"""The port's activation constraints against the JAX package's.

Every (arch, shape) cell of the dry-run, on both production meshes, at the
fewest layers that reach every ``shard`` site of its family (one layer;
one encoder layer; one hybrid block of ``attn_every`` Mamba2 layers and no
tail), runs the cell's step once under ``use_rules(mesh,
rules_for(shape))``: the port's on meta tensors, JAX's under
``jax.eval_shape`` in a subprocess that imports ``repro.launch.dryrun``
first (its 512 host devices) and makes the meshes with ``Auto`` axes (jax
0.9's default ``Explicit`` axes refuse ``with_sharding_constraint``).
Both sides record, by wrapping ``ShardingRules.spec``, what each call made
from a ``shard`` constraint resolves: the distinct (logical axes, shape,
spec) triples of a cell must be equal.  The caller of each ``shard`` is
recorded too: the reference's 33 sites (file:line) must all be reached,
and the port's counterpart of each (file, function, the call's first
line) with them, and no other.
"""
import json
import linecache
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs.base import (
    SHAPES, assigned_archs, get_config, shape_applicable,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import named_mesh
from repro_torch.models.model_zoo import build_meta_model, input_specs
from repro_torch.sharding import logical
from repro_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s, m) for a in assigned_archs() for s, shape in SHAPES.items()
         if shape_applicable(get_config(a), shape)[0]
         for m in ("single", "multi")]

# the reference's site -> the port's (file, function, the call's first line)
SITES = {
    "layers.py:75": ("layers.py", "swiglu",
                     'h = shard(h, "batch", "seq", "act_mlp")'),
    "layers.py:90": ("layers.py", "gelu_mlp",
                     'h = shard(h, "batch", "seq", "act_mlp")'),
    "layers.py:105": ("layers.py", "unembed", 'return shard(x @ p["table"].T,'
                      ' "batch", "seq", "act_vocab")'),
    "layers.py:139": ("layers.py", "qkv_project",
                      'q = shard(q, "batch", "seq", "act_heads", None)'),
    "layers.py:140": ("layers.py", "qkv_project",
                      'k = shard(k, "batch", "seq", "act_kv_heads", None)'),
    "layers.py:141": ("layers.py", "qkv_project",
                      'v = shard(v, "batch", "seq", "act_kv_heads", None)'),
    "transformer.py:70": ("transformer.py", "_attn_block", 'attn = shard('
                          'attn, "batch", "seq", "act_heads", None)'),
    "transformer.py:90": ("transformer.py", "_embed_inputs",
                          'return shard(h, "batch", "seq", "act_embed")'),
    "transformer.py:98": ("transformer.py", "_unembed", 'return shard(h @ '
                          'params["unembed"], "batch", "seq", "act_vocab")'),
    "transformer.py:116": ("transformer.py", "forward.<locals>.layer_fn",
                           'h = shard(h + ffn, "batch", "seq", "act_embed")'),
    "transformer.py:153": ("transformer.py", "prefill", 'h = shard(h + '
                           '_ffn_block(lp, cfg, h)[0], "batch", "seq", '
                           '"act_embed")'),
    "transformer.py:158": ("transformer.py", "prefill", 'kv = {n: shard('
                           'torch.stack(t), "layers", "batch", "kv_seq",'),
    "transformer.py:169": ("transformer.py", "decode_step", 'h = shard('
                           'L.embed(params["embed"], tokens), "batch", "seq",'
                           ' "act_embed")'),
    "moe.py:146": ("moe.py", "moe_block",
                   'buf_e = shard(buf, None, "act_expert", "cap", None)'),
    "moe.py:149": ("moe.py", "moe_block",
                   'h = shard(h, None, "act_expert", "cap", "act_mlp")'),
    "moe.py:153": ("moe.py", "moe_block",
                   'out_buf = shard(out_e, "batch", None, "cap", None)'),
    "rwkv.py:201": ("rwkv.py", "rwkv6_timemix_train", 'o = shard(o.to('
                    'x.dtype), "batch", "seq", "act_heads", None)'),
    "rwkv.py:215": ("rwkv.py", "rwkv6_channelmix_train",
                    'kk = shard(kk, "batch", "seq", "act_mlp")'),
    "rwkv_model.py:33": ("rwkv_model.py", "forward",
                         'h = shard(h, "batch", "seq", "act_embed")'),
    "rwkv_model.py:48": ("rwkv_model.py", "forward.<locals>.layer_fn",
                         'return shard(h, "batch", "seq", "act_embed")'),
    "rwkv_model.py:57": ("rwkv_model.py", "forward", 'logits = shard(_head('
                         'params, cfg, h), "batch", "seq", "act_vocab")'),
    "ssm.py:99": ("ssm.py", "mamba2_train",
                  'xs = shard(xs, "batch", "seq", "act_ssm")'),
    "ssm.py:145": ("ssm.py", "mamba2_train",
                   'y = shard(y.to(x.dtype), "batch", "seq", "act_ssm")'),
    "hybrid.py:72": ("hybrid.py", "forward", 'h = shard(L.embed(params['
                     '"embed"], batch["tokens"]), "batch", "seq",'),
    "hybrid.py:81": ("hybrid.py", "forward.<locals>.block_fn",
                     'return shard(h, "batch", "seq", "act_embed")'),
    "hybrid.py:90": ("hybrid.py", "forward", 'logits = shard(_head(params, '
                     'cfg, h), "batch", "seq", "act_vocab")'),
    "hybrid.py:97": ("hybrid.py", "prefill", 'h = shard(L.embed(params['
                     '"embed"], batch["tokens"]), "batch", "seq",'),
    "encdec.py:54": ("encdec.py", "encode",
                     'h = shard(enc_embeds, "batch", "seq", "act_embed")'),
    "encdec.py:68": ("encdec.py", "encode.<locals>.layer_fn", 'return shard('
                     '_mlp(lp, cfg, h), "batch", "seq", "act_embed")'),
    "encdec.py:96": ("encdec.py", "forward", 'h = shard(L.embed(params['
                     '"embed"], batch["tokens"]), "batch", "seq",'),
    "encdec.py:109": ("encdec.py", "forward.<locals>.layer_fn", 'return '
                      'shard(_mlp(lp, cfg, h), "batch", "seq", "act_embed")'),
    "encdec.py:116": ("encdec.py", "forward", 'logits = shard(_head(params, '
                      'cfg, h), "batch", "seq", "act_vocab")'),
    "encdec.py:158": ("encdec.py", "prefill", 'h = shard(L.embed(params['
                      '"embed"], batch["tokens"]), "batch", "seq",'),
}

_JAX_SITES = r"""
import functools, json, os, sys
import repro.launch.dryrun as dr          # sets XLA_FLAGS before jax starts
import jax, jax.numpy as jnp
from repro.configs.base import (SHAPES, assigned_archs, get_config,
                                shape_applicable)
from repro.models.model_zoo import build_model, input_specs
from repro.sharding import logical as L
from repro.train import train_step as jts

seen, sites = None, set()
spec = L.ShardingRules.spec

def recording(self, axes, shape):
    out = spec(self, axes, shape)
    if sys._getframe(1).f_code.co_name == "shard":
        site = sys._getframe(2)
        sites.add(f"{os.path.basename(site.f_code.co_filename)}:"
                  f"{site.f_lineno}")
        seen.add(json.dumps([list(axes), list(shape),
                             [list(e) if isinstance(e, tuple) else e
                              for e in out]]))
    return out
L.ShardingRules.spec = recording

def cut(cfg):
    n = cfg.attn_every if cfg.family == "hybrid" else 1
    return cfg.replace(num_layers=n,
                       encoder_layers=min(cfg.encoder_layers, 1))

auto = (jax.sharding.AxisType.Auto,)
meshes = {"single": jax.make_mesh((16, 16), ("data", "model"),
                                  axis_types=auto * 2),
          "multi": jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                                 axis_types=auto * 3)}
out = {}
for arch in assigned_archs():
    cfg = cut(get_config(arch))
    model = build_model(cfg)
    for sname, shape in SHAPES.items():
        if not shape_applicable(get_config(arch), shape)[0]:
            continue
        batch = input_specs(cfg, shape)
        for mname, mesh in meshes.items():
            seen = set()
            with L.use_rules(mesh, dr.rules_for(shape)):
                if shape.kind == "train":
                    jax.eval_shape(jts.make_train_step(model),
                                   jts.abstract_train_state(model), batch)
                elif shape.kind == "prefill":
                    jax.eval_shape(jts.make_prefill_step(model),
                                   model.abstract_params(jnp.float32), batch)
                else:
                    b, S = shape.global_batch, shape.seq_len
                    cache = jax.eval_shape(
                        functools.partial(model.init_cache, b, S))
                    jax.eval_shape(
                        jts.make_decode_step(model),
                        model.abstract_params(jnp.float32), cache,
                        jax.ShapeDtypeStruct((b, 1), jnp.int32),
                        jax.ShapeDtypeStruct((), jnp.int32))
            out[f"{arch}__{sname}__{mname}"] = sorted(seen)
print(json.dumps({"cells": out, "sites": sorted(sites)}))
"""


def _cut(cfg):
    n = cfg.attn_every if cfg.family == "hybrid" else 1
    return cfg.replace(num_layers=n,
                       encoder_layers=min(cfg.encoder_layers, 1))


@pytest.fixture(scope="module")
def jax_sites():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SITES], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_sites():
    """Each cell's triples and every site reached, as ``jax_sites``."""
    seen, sites, cells = set(), set(), {}
    spec = logical.ShardingRules.spec

    def recording(self, axes, shape):
        out = spec(self, axes, shape)
        if sys._getframe(1).f_code.co_name == "shard":
            site = sys._getframe(2)
            code = site.f_code
            sites.add((os.path.basename(code.co_filename), code.co_qualname,
                       linecache.getline(code.co_filename,
                                         site.f_lineno).strip()))
            seen.add(json.dumps([list(axes), list(shape),
                                 [list(e) if isinstance(e, tuple) else e
                                  for e in out]]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logical.ShardingRules, "spec", recording)
        for arch, sname, mname in CELLS:
            shape = SHAPES[sname]
            model = build_meta_model(_cut(get_config(arch)))
            batch = input_specs(model.cfg, shape)
            seen.clear()
            with logical.use_rules(named_mesh(mname),
                                   dryrun.rules_for(shape)):
                if shape.kind == "train":
                    ts.make_train_step(model)(ts.init_train_state(model),
                                              batch)
                elif shape.kind == "prefill":
                    ts.make_prefill_step(model)(batch)
                else:
                    cache = model.init_cache(shape.global_batch,
                                             shape.seq_len)
                    ts.make_decode_step(model)(cache, batch["tokens"],
                                               shape.seq_len - 1)
            cells[f"{arch}__{sname}__{mname}"] = sorted(seen)
    return {"cells": cells, "sites": sites}


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["__".join(c) for c in CELLS])
def test_cell_resolves_the_triples_jax_resolves(jax_sites, port_sites, arch,
                                                shape, mesh):
    """(An RWKV6 decode step reaches no site, on both sides.)"""
    key = f"{arch}__{shape}__{mesh}"
    assert port_sites["cells"][key] == jax_sites["cells"][key]


def test_every_reference_site_has_its_counterpart(jax_sites, port_sites):
    assert len(SITES) == 33
    assert set(jax_sites["sites"]) == set(SITES)
    assert port_sites["sites"] == set(SITES.values())
    assert set(jax_sites["cells"]) == {"__".join(c) for c in CELLS}
