"""The port's dry-run against the JAX package's, and its op counts.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so it is imported only in a subprocess of its own, which prints
for every cell the per-device bytes that its ``lower_cell`` counts (train:
the state's params, ``mu``, ``nu`` and step; prefill: the float32 params;
decode: those and ``jax.eval_shape`` of ``init_cache``), ``model_flops``
and the fallbacks its rules recorded, without compiling.  The port's
records (no meta pass) must equal them: bytes exactly, FLOPs to 1e-12.
Its meta pass must count the FLOPs that ``FlopCounterMode`` counts of the
same step on real CPU tensors, for the reduced config of each family.

Its sharded pass (``launch.collectives``) counts no collective on the 1 x 1
mesh, uses the reference's ring formulas, and counts hand-reckoned cells
exactly (``test_hand_reckoned_prefill_cell``, and
``test_hand_reckoned_decode_cell`` for the KV-sequence-parallel decode).
"""
import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, ShapeConfig, assigned_archs
from repro_torch.kernels import meta, ops, ref
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model_zoo
from repro_torch.sharding import logical

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s, m) for a in assigned_archs() for s in SHAPES
         for m in ("single", "multi")]
FAMILIES = {"dense": "qwen3_8b", "moe": "qwen3_moe_30b_a3b",
            "vlm": "pixtral_12b", "hybrid": "zamba2_7b",
            "audio": "whisper_medium", "ssm": "rwkv6_3b"}
COLLECTIVE_KEYS = {"collective_counts", "collective_result_bytes",
                   "collective_wire_bytes"}
RECORD_KEYS = {"arch", "shape", "mesh", "status", "params",
               "persistent_bytes_per_device", "model_flops",
               "dropped_shardings", "trace_s", "op_flops", "op_bytes",
               "op_count", "torch"} | COLLECTIVE_KEYS

_JAX_CELLS = r"""
import functools, json
import repro.launch.dryrun as dr          # sets XLA_FLAGS before jax starts
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import (SHAPES, assigned_archs, get_config,
                                shape_applicable)
from repro.launch.mesh import make_production_mesh
from repro.models import params as pdefs
from repro.models.model_zoo import batch_logical_axes, build_model, input_specs
from repro.sharding.logical import ShardingRules
from repro.train.optimizer import AdamWState
from repro.train.train_step import TrainState, abstract_train_state

out = {}
for arch in assigned_archs():
    cfg = get_config(arch)
    model = build_model(cfg)
    specs = pdefs.logical_specs(model.defs)
    for sname, shape in SHAPES.items():
        for mname in ("single", "multi"):
            key = f"{arch}__{sname}__{mname}"
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                out[key] = {"status": "skipped", "reason": why}
                continue
            mesh = make_production_mesh(multi_pod=mname == "multi")
            rules = ShardingRules(mesh, dr.rules_for(shape))
            ts = lambda a, s: dr.tree_shardings(a, s, rules, mesh)
            if shape.kind == "train":
                state = abstract_train_state(model)
                sh = TrainState(params=ts(specs, state.params), opt=AdamWState(
                    step=NamedSharding(mesh, P()), mu=ts(specs, state.opt.mu),
                    nu=ts(specs, state.opt.nu)))
                nbytes = dr.per_device_bytes(sh, state)
                batch = input_specs(cfg, shape)
                ts(batch_logical_axes(cfg, shape), batch)
            elif shape.kind == "prefill":
                params = model.abstract_params(jnp.float32)
                nbytes = dr.per_device_bytes(ts(specs, params), params)
                batch = input_specs(cfg, shape)
                ts(batch_logical_axes(cfg, shape), batch)
            else:
                params = model.abstract_params(jnp.float32)
                p_sh = ts(specs, params)
                b, S = shape.global_batch, shape.seq_len
                cache = jax.eval_shape(functools.partial(model.init_cache, b, S))
                c_sh = ts(model.cache_axes(), cache)
                rules.spec(("batch", None), (b, 1))
                nbytes = (dr.per_device_bytes(p_sh, params)
                          + dr.per_device_bytes(c_sh, cache))
            out[key] = {
                "status": "ok", "params": model.param_count(),
                "persistent_bytes_per_device": nbytes,
                "model_flops": dr.model_flops(cfg, shape, model),
                "dropped_shardings": [f"{l}:{d}:{a}"
                                      for (l, d, a) in rules.dropped[:20]]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_CELLS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["__".join(c) for c in CELLS])
def test_cell_equals_jax(jax_cells, arch, shape, mesh):
    want = jax_cells[f"{arch}__{shape}__{mesh}"]
    rec = dryrun.lower_cell(arch, shape, mesh, ops=False)
    assert rec["status"] == want["status"]
    if want["status"] == "skipped":
        assert rec["reason"] == want["reason"]
        return
    assert rec["params"] == want["params"]
    assert rec["persistent_bytes_per_device"] == \
        want["persistent_bytes_per_device"]
    assert rec["model_flops"] == pytest.approx(want["model_flops"],
                                               rel=1e-12)
    assert rec["dropped_shardings"] == want["dropped_shardings"]
    assert rec["op_flops"] is None


def test_cell_counts(jax_cells):
    status = [v["status"] for v in jax_cells.values()]
    assert (status.count("ok"), status.count("skipped")) == (64, 16)


def _cpu_batch(cfg, shape: ShapeConfig, gen) -> dict:
    """Real CPU tensors of ``model_zoo.input_specs``'s shapes and dtypes:
    two packed documents a row, image and frame stubs."""
    b, s = shape.global_batch, shape.seq_len
    specs = model_zoo.input_specs(cfg, shape)
    if shape.kind == "decode":
        return {"tokens": torch.randint(1, cfg.vocab_size, (b, 1),
                                        generator=gen, dtype=torch.int32)}
    half = s // 2
    seg = torch.cat([torch.ones(b, half), torch.full((b, s - half), 2)], 1)
    pos = torch.cat([torch.arange(half), torch.arange(s - half)])
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s),
                                     generator=gen),
             "segment_ids": seg, "positions": pos.expand(b, s)}
    batch["labels"] = batch["tokens"]
    if "image_positions" in specs:
        n = specs["image_positions"].shape[1]
        batch["image_positions"] = torch.arange(n).expand(b, n)
    for k in ("image_embeds", "enc_embeds"):
        if k in specs:
            batch[k] = torch.randn(specs[k].shape, generator=gen)
    return {k: v.to(specs[k].dtype).contiguous() for k, v in batch.items()
            if k in specs}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_meta_pass_counts_the_cpu_steps_flops(family, kind):
    cfg = importlib.import_module(
        f"repro_torch.configs.{FAMILIES[family]}").reduced()
    shape = ShapeConfig(f"{kind}_small", kind, 64, 2)
    gen = torch.Generator().manual_seed(0)
    model = model_zoo.build_model(cfg, gen)
    cpu = dryrun.step_cost(model, shape, _cpu_batch(cfg, shape, gen))
    on_meta = dryrun.op_pass(cfg, shape)
    assert on_meta["op_flops"] == cpu.flops > 0
    # the bytes and the op count too, but where torch takes another path
    # on meta: wkv6 is one op there, not a chunk loop, and on the CPU the
    # MoE's F.one_hot checks its ids' range (aminmax, a host read) first
    if family not in ("ssm", "moe"):
        assert (on_meta["op_bytes"], on_meta["op_count"]) == (cpu.bytes,
                                                              cpu.ops)


def _wkv6_args(b, s, h, dk, device, grad):
    gen = torch.Generator().manual_seed(1)
    args = [(torch.randn(b, s, h, dk, generator=gen) * 0.3) for _ in range(3)]
    args.append(-torch.rand(b, s, h, dk, generator=gen))
    args.append(torch.randn(h, dk, generator=gen))
    args = [a.to(device).requires_grad_(grad) for a in args]
    reset = torch.zeros(b, s, dtype=torch.bool)
    reset[:, 0] = True
    reset[:, s // 3] = True
    return args, reset.to(device)


@pytest.mark.parametrize("b,s,h,dk,chunk", [
    (2, 128, 3, 16, 64), (1, 40, 2, 8, 64), (2, 96, 3, 8, 32),
    (1, 64, 1, 64, 64), (3, 256, 2, 16, 16)])
def test_wkv6_meta_formulas_equal_the_plain_count(b, s, h, dk, chunk):
    """Forward and backward, (1, 40, ...) a single chunk shorter than the
    chunk length."""
    counts = []
    for device in ("cpu", "meta"):
        args, reset = _wkv6_args(b, s, h, dk, device, grad=True)
        with FlopCounterMode(display=False) as fc:
            o = ops.wkv6(*args, reset, chunk=chunk)
            fwd = fc.get_total_flops()
            o.sum().backward()
        counts.append((fwd, fc.get_total_flops() - fwd))
        assert all(a.grad.shape == a.shape for a in args)
    assert counts[0] == counts[1] == (
        meta.wkv6_flops((b, s, h, dk), chunk),
        meta.wkv6_bwd_flops((b, s, h, dk), chunk))


def test_wkv6_custom_op_runs_the_plain_version_on_cpu():
    args, reset = _wkv6_args(2, 64, 2, 8, "cpu", grad=True)
    o, state = meta.register()(*args, reset, 16)
    want, want_state = ref.wkv6_chunked(*args, chunk=16, reset=reset,
                                        return_state=True)
    assert torch.equal(o, want) and torch.equal(state, want_state)
    dout = torch.randn_like(o)
    got = torch.autograd.grad(o, args, dout)
    exp = torch.autograd.grad(want, args, dout)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=5e-4, atol=5e-5)
    with pytest.raises(ValueError, match="not a multiple"):
        meta.wkv6_flops((1, 100, 1, 8), 64)


def test_cli_writes_records_with_the_keys(tmp_path):
    dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh",
                 "local", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k", "--mesh",
                 "both", "--no-ops", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k", "--mesh",
                 "single", "--no-ops", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-8b__decode_32k__local.json")
                     .read_text())
    assert set(rec) == RECORD_KEYS and rec["status"] == "ok"
    assert rec["torch"] == torch.__version__
    assert rec["op_flops"] > rec["model_flops"] > 0 and rec["op_count"] > 0
    assert rec["dropped_shardings"] == []
    for key in COLLECTIVE_KEYS:          # nothing moves on one device
        assert set(rec[key]) == set(collectives.KINDS)
        assert not any(rec[key].values())
    no_ops = json.loads((tmp_path / "qwen3-8b__decode_32k__single.json")
                        .read_text())
    assert set(no_ops) == RECORD_KEYS and no_ops["status"] == "ok"
    assert all(no_ops[key] is None for key in COLLECTIVE_KEYS)
    for mesh in ("single", "multi"):
        skip = json.loads((tmp_path / f"qwen3-8b__long_500k__{mesh}.json")
                          .read_text())
        assert skip["status"] == "skipped" and "quadratic" in skip["reason"]


def test_import_sets_nothing_and_touches_no_device():
    code = "\n".join([
        "import os, sys",
        "env = dict(os.environ)",
        "import repro_torch.launch.dryrun",
        "import torch.distributed as dist",
        "assert dict(os.environ) == env",
        "assert not dist.is_initialized()",
        "assert 'jax' not in sys.modules",
        "print('ok')"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "ok", proc.stderr[-2000:]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_local_mesh_issues_no_collective(family):
    cfg = importlib.import_module(
        f"repro_torch.configs.{FAMILIES[family]}").reduced()
    rec = dryrun.collective_pass(cfg, ShapeConfig("t", "train", 64, 2),
                                 "local")
    assert set(rec["collective_counts"]) == set(collectives.KINDS)
    assert not any(v for key in COLLECTIVE_KEYS for v in rec[key].values())


def test_wire_formulas_equal_the_reference():
    from repro.launch.hlo_cost import _collective_wire
    for kind in collectives.KINDS:
        for rb in (0, 1, 4096, 3 * 2**30 + 7):
            for n in (1, 2, 3, 16, 256, 512):
                assert collectives.wire_bytes(kind, rb, n) == \
                    _collective_wire(kind, rb, n), (kind, rb, n)


def test_hand_reckoned_prefill_cell():
    """Reduced qwen3-8b (2 layers, d 64, 4 heads and 2 KV heads of 16,
    d_ff 128, vocab 256), prefill of 4 x 64 tokens, on a (2, 1) ("data",
    "model") mesh.  Under ``TRAIN_RULES`` only ``embed`` and ``batch``
    reach a mesh axis of more than one device: every weight with an
    ``embed`` dim is split over the 2 data devices, the batch too.  The
    serve cast makes the weights bf16 (2 bytes).

    - Each of a layer's seven products gathers its weight whole, once:
      wq 64 x 64, wk and wv 64 x 32, wo 64 x 64, w_gate and w_up 64 x 128,
      w_down 128 x 64: 36,864 elements, 73,728 bytes, 147,456 for the two
      layers.  The head product ``layers.head_project`` gathers by design
      (its batch shard times the whole weight); DTensor chooses the same
      for the other four.
    - The embedding lookup (``layers.embed``) takes each batch shard's
      rows from the whole table, gathered: 256 x 64, 32,768 bytes.
    - The last position's logits gather the unembedding, 64 x 256,
      32,768 bytes.
    So 2 x 7 + 2 = 16 all-gathers of 147,456 + 32,768 + 32,768 = 212,992
    result bytes, nothing else; each over a group of 2, so the wire is
    half the result."""
    from repro_torch.configs.qwen3_8b import reduced
    rec = dryrun.collective_pass(reduced(), ShapeConfig("p", "prefill", 64, 4),
                                 MeshShape(("data", "model"), (2, 1)))
    zero = dict.fromkeys(collectives.KINDS, 0)
    assert rec["collective_counts"] == dict(zero, **{"all-gather": 16})
    assert rec["collective_result_bytes"] == dict(zero,
                                                  **{"all-gather": 212_992})
    assert rec["collective_wire_bytes"] == dict(zero,
                                                **{"all-gather": 106_496})


def test_hand_reckoned_decode_cell():
    """Reduced qwen3-8b (2 layers, d 64, 4 heads and 2 KV heads of 16,
    d_ff 128, vocab 256), one decode step at the last position of a bf16
    cache of 64, batch 2, on a (1, 4) ("data", "model") mesh under
    ``DECODE_RULES`` (torch 2.13; DTensor's choices change with the
    release).  Nothing is split over ``data``; over ``model`` the heads,
    the MLP and the vocabulary are split, and the cache's sequence: 16
    positions a device.  The serve cast makes the weights bf16.

    - The KV-sequence-parallel merge, a layer: an all-reduce (max) of the
      (2, 4) float32 lse, 32 bytes, and one (sum) of the weighted outputs
      beside their weights, (2, 4, 16 + 1) float32, 544 bytes: 4
      all-reduces, 1,152 bytes.  The cache is never gathered (the
      whole-cache path gathered k and v a layer: 4 all-gathers of
      2 x 2 x 64 x 16 x 2 = 8,192 bytes).
    - Whole weights on each device, by all-gather: the embedding table for
      the batch-local lookup (256 x 64, 32,768 B); ``wq`` a layer for
      ``head_project`` (64 x 4 x 16, 8,192 B; ``wk`` and ``wv`` hold the
      replicated KV heads); ``wo`` a layer, since attention's output is
      whole over ``model`` (8,192 B); layer 1's ``w_gate`` and ``w_up``
      (64 x 128, 16,384 B each); the unembedding (64 x 256, 32,768 B).
      8 all-gathers, 131,072 B.
    - The pending sum over ``model`` that ``w_down``'s split contraction
      leaves in the residual stream (layer 0's FFN moves nothing: its
      input is whole), reduced where a value is read, f32 (2, 1, 64) 512
      B or bf16 256 B: layer 1's attention norm (512) and its three
      projections' inputs (256 each), its FFN norm (512), the gate's
      product (2, 1, 128) bf16 (512), the final norm (512): 7
      all-reduces, 2,816 B.
    - ``shard(..., "act_mlp")`` and ``shard(..., "act_vocab")`` scatter
      layer 1's (2, 1, 32) bf16 MLP activations (128 B) and the (2, 1,
      64) logits (256 B): 2 reduce-scatters, 384 B.
    So 11 all-reduces of 3,968 B, 8 all-gathers of 131,072 B and 2
    reduce-scatters of 384 B; over a group of 4 the wire is 3/2, 3/4 and
    3 times the result."""
    from repro_torch.configs.qwen3_8b import reduced
    rec = dryrun.collective_pass(reduced(), ShapeConfig("d", "decode", 64, 2),
                                 MeshShape(("data", "model"), (1, 4)))
    zero = dict.fromkeys(collectives.KINDS, 0)
    assert rec["collective_counts"] == dict(
        zero, **{"all-reduce": 11, "all-gather": 8, "reduce-scatter": 2})
    assert rec["collective_result_bytes"] == dict(
        zero, **{"all-reduce": 3_968, "all-gather": 131_072,
                 "reduce-scatter": 384})
    assert rec["collective_wire_bytes"] == dict(
        zero, **{"all-reduce": 5_952, "all-gather": 98_304,
                 "reduce-scatter": 1_152})


def test_expert_transpose_and_the_cuda_all_to_all():
    """The MoE's expert transpose, ``shard(buf, None, "act_expert", "cap",
    None)`` from the batch split of the dispatch (``data``), replicates the
    buffer over ``data`` and splits its experts over ``model``: on DTensor,
    one all-gather over ``data`` of this device's expert block (GSPMD
    counts all-to-alls and collective-permutes there; PERF.md).  A
    ``Shard(0) -> Shard(1)`` move over one mesh dim is one all-to-all, as
    NCCL runs it, not gloo's all-gather fallback."""
    b, ep, c, d = 8, 16, 5, 64
    with collectives.fake_mesh(MeshShape(("data", "model"), (2, 2))) as mesh:
        with logical.use_rules(mesh) as rules:
            buf = logical.distribute(
                torch.empty((b, ep, c, d), dtype=torch.bfloat16,
                            device="meta"),
                rules.spec(("batch", None, "cap", None), (b, ep, c, d)), mesh)
            out, tally = collectives.count(
                logical.shard, buf, None, "act_expert", "cap", None)
            assert tuple(out.to_local().shape) == (b, ep // 2, c, d)
            assert tally.counts == dict.fromkeys(collectives.KINDS, 0) | {
                "all-gather": 1}
            assert tally.result_bytes["all-gather"] == b * ep // 2 * c * d * 2
            from torch.distributed.tensor import Replicate, Shard
            moved, tally = collectives.count(
                buf.redistribute, mesh, (Shard(1), Replicate()))
            assert tally.counts["all-to-all"] == 1 and tally.total == 1
            assert tuple(moved.to_local().shape) == (b, ep // 2, c, d)
            assert tally.result_bytes["all-to-all"] == b * ep * c * d
