"""Mamba2 (SSD) block, chunked state-space duality formulation: the port of
``repro.models.ssm``.

Used by the zamba2-7b hybrid.  Train path: the chunked scan; decode path:
the single-step recurrence over the carried (conv, ssm) state.

Recurrence (per head h, state size N, head dim P):
    S_t = a_t * S_{t-1} + (dt_t * x_t) (x) B_t          S in R^{P x N}
    y_t = C_t . S_t + D * x_t
with a_t = exp(dt_t * A), A = -exp(A_log) < 0, dt_t = softplus(...).

The JAX package's simplifications are kept: one B/C group, and the causal
depthwise conv on the SSM input stream only.

Packing semantics: the SSM state resets exactly at segment starts (tracked
as reset COUNTS, see the chunked scan); the depthwise conv window leaks up
to CONV_K-1 tokens across packed boundaries, the JAX package's accepted
contract (``tests/test_torch_hybrid.py`` pins it).

The scan keeps the JAX formulas, in float32.  Its terms within a chunk do
not depend on the carried state, so they are computed for every chunk at
once; only the (b, H, P, N) state is carried, chunk by chunk.  Every
einsum has two operands, so none forms an outer product of three (torch
contracts a longer einsum left to right: ``bcmhp,bcmn,bcmh`` would make
a (b, c, m, h, p, n) tensor, 7.5 GB at zamba2-7b's training shape).  JAX
also rematerialises each chunk of the scan in the backward pass
(``jax.checkpoint`` inside it, whatever ``cfg.remat`` says); the port
instead covers the scan's memory at the hybrid's block granularity: under
``cfg.remat`` other than ``"none"``, ``models.hybrid.forward`` keeps only
each block's input and recomputes its layers, the scan included, in the
backward.  On DTensors the scan (``_ssd_scan``, independent per batch row
and head) runs on each rank's shards, as a kernel would.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.params import CONV, EMBED, ParamDef, SSM_INNER, \
    SSM_STATE
from repro_torch.sharding.logical import dtensor_mesh, on_shards, shard

CONV_K = 4  # depthwise conv kernel width


def mamba2_def(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_heads = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return {
        # fused input projection -> [z, x, B, C, dt]
        "w_z": ParamDef((d, d_in), (EMBED, SSM_INNER), init="scaled"),
        "w_x": ParamDef((d, d_in), (EMBED, SSM_INNER), init="scaled"),
        "w_B": ParamDef((d, N), (EMBED, SSM_STATE), init="scaled"),
        "w_C": ParamDef((d, N), (EMBED, SSM_STATE), init="scaled"),
        "w_dt": ParamDef((d, n_heads), (EMBED, None), init="scaled"),
        "dt_bias": ParamDef((n_heads,), (None,), init="zeros"),
        "A_log": ParamDef((n_heads,), (None,), init="zeros"),
        "D": ParamDef((n_heads,), (None,), init="ones"),
        "conv": ParamDef((CONV_K, d_in), (CONV, SSM_INNER), init="scaled"),
        "norm": L.rmsnorm_def(d_in),
        "w_out": ParamDef((d_in, d), (SSM_INNER, EMBED), init="scaled"),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (b, s, c); w: (K, c).  Causal: output t sees x[t-K+1 .. t]."""
    K, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return F.silu(out).to(x.dtype)


def _project(p, cfg, x):
    """Shared projection for train/decode.  x: (b, s, d)."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    B = (x @ p["w_B"]).float()
    C = (x @ p["w_C"]).float()
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    loga = dt * A                                  # (b, s, H) log decay
    return z, xs, B, C, dt, loga


def _ssd_scan(dtx, Bv, Cv, loga, seg_reset, chunk: int):
    """The chunked SSD scan, in float32, independent per batch row and
    head.  dtx: (b, s, H, P); Bv, Cv: (b, s, N); loga: (b, s, H);
    seg_reset: (b, s) bool.  Returns y (b, s, H, P) without the D skip, and
    the final state (b, H, P, N)."""
    b, s, H, P = dtx.shape
    N = Bv.shape[-1]
    Lc, nc = chunk, s // chunk
    # chunked SSD scan, chunks as dim 1.  Segment resets are tracked as
    # COUNTS (never folded into the fp32 decay cumsum: catastrophic
    # cancellation; see models/rwkv.py).
    xc = dtx.reshape(b, nc, Lc, H, P)
    Bc, Cc = Bv.reshape(b, nc, Lc, N), Cv.reshape(b, nc, Lc, N)
    cla = torch.cumsum(loga.reshape(b, nc, Lc, H), dim=2)  # cumulative
    R = torch.cumsum(seg_reset.to(torch.int32).reshape(b, nc, Lc),
                     dim=2)                         # resets up to & incl t
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=dtx.device))
    # intra-chunk: M[l,m,h] = (C_l . B_m) * exp(cla_l - cla_m), valid iff
    # l >= m and no reset in (m, l]  <=>  R_l == R_m
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    diff = cla[:, :, :, None, :] - cla[:, :, None, :, :]   # (b,c,l,m,H)
    decay = torch.exp(torch.minimum(diff, diff.new_zeros(())))
    valid = (R[:, :, :, None] == R[:, :, None, :]) & tri   # (b,c,l,m)
    M = scores[..., None] * decay * valid[..., None]
    y = torch.einsum("bclmh,bcmhp->bclhp", M, xc)
    # state update: kv_m survives iff no reset in (m, L]; the carried state
    # survives a chunk only if it holds no reset
    k_gate = (R[:, :, -1:] == R)[..., None]                # (b,c,m,1)
    kw = xc * (torch.exp(cla[:, :, -1:, :] - cla) * k_gate)[..., None]
    kv = torch.einsum("bcmhp,bcmn->bchpn", kw, Bc)
    keep = torch.exp(cla[:, :, -1]) * (R[:, :, -1] == 0)[..., None]
    S = torch.zeros((b, H, P, N), dtype=torch.float32, device=dtx.device)
    entering = []
    for c in range(nc):
        entering.append(S)
        S = kv[:, c] + S * keep[:, c, :, None, None]
    # inter-chunk: the carried state reaches position l only until the
    # chunk's first reset
    carry_gate = (R == 0)[..., None]                       # (b,c,l,1)
    y = y + torch.einsum("bcln,bchpn->bclhp", Cc, torch.stack(entering, 1)) \
        * (torch.exp(cla) * carry_gate)[..., None]
    return y.reshape(b, s, H, P), S


def mamba2_train(p: dict, cfg, x: torch.Tensor, segment_ids: torch.Tensor,
                 return_state: bool = False):
    """x: (b, s, d_model); segment_ids: (b, s).  Returns (b, s, d_model),
    and with ``return_state`` also the final {ssm, conv} state (prefill)."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    Lc = min(cfg.ssm_chunk, s)
    if s % Lc:
        raise ValueError(f"sequence {s} is not a multiple of the SSM chunk "
                         f"{Lc}")

    prev_seg = F.pad(segment_ids[:, :-1], (1, 0))
    seg_reset = (segment_ids != prev_seg) | (segment_ids == 0)

    z, xs, Bv, Cv, dt, loga = _project(p, cfg, x)
    xs_raw = xs                                    # pre-conv stream (prefill)
    xs = _causal_depthwise_conv(xs, p["conv"])
    xs = shard(xs, "batch", "seq", "act_ssm")
    xh = xs.reshape(b, s, H, P).float()
    dtx = xh * dt[..., None]                       # (b, s, H, P)

    if dtensor_mesh(dtx) is None:
        y, S = _ssd_scan(dtx, Bv, Cv, loga, seg_reset, Lc)
    else:   # per batch row and head on each rank's shards, as a kernel
        bh = {"b": 0, "h": 2}
        y, S = on_shards(functools.partial(_ssd_scan, chunk=Lc),
                         (dtx, Bv, Cv, loga, seg_reset),
                         (bh, {"b": 0}, {"b": 0}, bh, {"b": 0}),
                         (bh, {"b": 0, "h": 1}))
    y = y + xh * p["D"].float()[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = L.rmsnorm(p["norm"], y * F.silu(z.float()), cfg.norm_eps)
    y = shard(y.to(x.dtype), "batch", "seq", "act_ssm")
    out = y @ p["w_out"]
    if return_state:
        state = {"ssm": S, "conv": xs_raw[:, -(CONV_K - 1):].float()}
        return out, state
    return out


def mamba2_init_state(cfg, batch: int, dtype=torch.float32,
                      device="cuda") -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=dtype, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_in), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p: dict, cfg, x: torch.Tensor, state: dict):
    """Single-step decode.  x: (b, 1, d_model).  Returns (y, new_state);
    the new conv window is in the activations' dtype, as in JAX."""
    b = x.shape[0]
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim

    z, xs, Bv, Cv, dt, loga = _project(p, cfg, x)
    # conv over carried window
    window = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv"].float())
    xh = F.silu(conv_out).reshape(b, 1, H, P)

    a = torch.exp(loga[:, 0])                      # (b, H)
    dtx = (xh * dt[..., None])[:, 0]               # (b, H, P)
    S = state["ssm"] * a[:, :, None, None] \
        + torch.einsum("bhp,bn->bhpn", dtx, Bv[:, 0])
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0], S)
    y = y + xh[:, 0] * p["D"].float()[None, :, None]
    y = y.reshape(b, 1, d_in)
    y = L.rmsnorm(p["norm"], y * F.silu(z.float()),
                  cfg.norm_eps).to(x.dtype)
    new_state = {"ssm": S, "conv": window[:, 1:]}
    return y @ p["w_out"], new_state
