"""The served weights, drawn straight into the dtypes the steps compute in.

``serve.run`` builds its model with ``build_model(cfg, gen, bf16)``: each
leaf is drawn in float32 and held by the cast rule (``params.compute_dtype``,
JAX's ``_cast_for_compute``), a stacked leaf one slice of its first dim at
a time.  These tests hold that tree to the cast of the float32 tree the
same seed draws (bit for bit, one reduced arch of each family), its dtypes
to JAX's cast of JAX's tree, the build's float32 pieces to one layer's
slice or the largest unstacked leaf (a ``TorchDispatchMode`` sees every
tensor made), and ``serve.main`` at the reduced sizes of the three
configs that this draw lets serve whole on one card.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as jax_train_step

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model, model_defs
from repro_torch.models.params import (
    LAYERS, compute_dtype, param_bytes, tree_leaves,
)
from repro_torch.train.train_step import _cast_for_compute

BF16 = torch.bfloat16
# one reduced arch of each family
FAMILIES = {"dense": "qwen3-32b", "vlm": "pixtral-12b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "rwkv6-3b",
            "hybrid": "zamba2-7b", "audio": "whisper-medium"}
# the configs that were served cut in depth while the float32 tree was
# drawn whole, and the bytes of their served trees at full size
WHOLE = {"granite-20b": 56_334_999_552, "qwen3-32b": 60_994_396_160,
         "qwen3-moe-30b-a3b": 61_064_249_344}
CARD_BYTES = 79 * 2**30        # what torch sees of an 80 GB H100


def _reduced(package: str, arch: str, **changes):
    module = importlib.import_module(
        f"{package}.configs.{arch.replace('-', '_')}")
    return module.reduced().replace(**changes)


def _state(model) -> dict:
    return dict(tree_leaves(model.tree()))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_served_tree_is_the_cast_float32_tree(family):
    """Leaf by leaf the same dtype and ``torch.equal`` values, and each
    dtype that of JAX's ``_cast_for_compute`` on JAX's float32 tree."""
    arch = FAMILIES[family]
    cfg = _reduced("repro_torch", arch)
    served = _state(build_model(cfg, torch.Generator().manual_seed(3), BF16))
    cast = _state(_cast_for_compute(build_model(
        cfg, torch.Generator().manual_seed(3), torch.float32)))
    assert served.keys() == cast.keys()
    for path, leaf in cast.items():
        assert served[path].dtype == leaf.dtype, path
        assert torch.equal(served[path], leaf), path
    jmodel = jax_build_model(_reduced("repro", arch))
    jcast = jax.eval_shape(lambda: jax_train_step._cast_for_compute(
        jmodel.init(jax.random.key(0), jnp.float32)))
    jdtypes = {path: leaf.dtype.name for path, leaf in tree_leaves(jcast)}
    assert jdtypes == {p: str(t.dtype).split(".")[-1]
                       for p, t in served.items()}
    assert BF16 in {t.dtype for t in served.values()}
    assert torch.float32 in {t.dtype for t in served.values()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cast_for_compute_leaves_a_served_model_alone(family):
    """The serve steps' in-place cast finds nothing to do on a served
    model: every parameter keeps its storage and dtype."""
    cfg = _reduced("repro_torch", FAMILIES[family])
    model = build_model(cfg, torch.Generator().manual_seed(0), BF16)
    before = {n: (p.data_ptr(), p.dtype)
              for n, p in model.named_parameters()}
    _cast_for_compute(model)
    assert before == {n: (p.data_ptr(), p.dtype)
                      for n, p in model.named_parameters()}


class _Float32Sizes(TorchDispatchMode):
    """The element counts of every float32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.sizes += [t.numel() for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)
                       and t.dtype == torch.float32]
        return out


@pytest.mark.parametrize("arch,changes", [
    ("granite-20b", {"num_layers": 6}),
    ("qwen3-32b", {"num_layers": 6}),
    ("qwen3-moe-30b-a3b", {"num_layers": 6}),
    ("zamba2-7b", {"num_layers": 9}),          # three blocks and a tail
    ("rwkv6-3b", {"num_layers": 6}),
])
def test_served_build_makes_no_float32_copy_of_a_stacked_leaf(arch,
                                                             changes):
    """No float32 tensor made while a served model is built is larger than
    one slice of a stacked leaf or the largest unstacked leaf; a stacked
    leaf drawn whole would be (checked, so the bound means something)."""
    cfg = _reduced("repro_torch", arch, **changes)
    defs = [d for _, d in tree_leaves(model_defs(cfg))]
    stacked = [d for d in defs if d.axes[:1] == (LAYERS,)]
    bound = max([math.prod(d.shape[1:]) for d in stacked]
                + [math.prod(d.shape) for d in defs
                   if d.axes[:1] != (LAYERS,)])
    assert max(math.prod(d.shape) for d in stacked
               if compute_dtype(d.dtype or torch.float32, d.shape, BF16)
               == BF16) > bound
    with _Float32Sizes() as seen:
        build_model(cfg, torch.Generator().manual_seed(0), BF16)
    assert seen.sizes and max(seen.sizes) <= bound


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_served_trees_fit_one_card_at_full_size(arch):
    """At full width and depth the served tree's bytes (from shapes) are
    the ones chip_smoke.py prints beside each run's peak, half the float32
    tree's and under the card's memory with room for a serve run."""
    defs = model_defs(get_config(arch))
    assert param_bytes(defs, BF16) == WHOLE[arch]
    assert param_bytes(defs, BF16) < param_bytes(defs) / 1.99
    assert param_bytes(defs, BF16) < CARD_BYTES - 16 * 2**30


@pytest.mark.parametrize("arch", sorted(WHOLE))
def test_serve_main_serves_the_formerly_cut_configs_on_cpu(arch):
    """``serve.main`` at the reduced size: finite logits, tokens in the
    vocabulary, and the model held in the served dtypes (no float32 leaf
    of rank > 1)."""
    cfg = _reduced("repro_torch", arch)
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    for key in ("prefill_logits", "logits"):
        assert torch.isfinite(out[key].float()).all(), key
    for path, p in _state(out["model"]).items():
        assert not (p.dtype == torch.float32 and p.dim() > 1), path


def test_served_draw_serves_as_the_cast_float32_draw(monkeypatch):
    """``serve.run`` draws its model in the compute dtype, and serves as it
    would the float32 tree the same seed draws, handed in through
    ``serve.build_model`` as a caller's tree is: the same prefill and
    decode logits, bitwise, and the same tokens."""
    cfg = _reduced("repro_torch", "qwen3-moe-30b-a3b")
    cpu, asked = torch.device("cpu"), []
    monkeypatch.setattr(serve, "build_model", lambda c, g, dtype: build_model(
        c, g, asked.append(dtype) or dtype))
    served = serve.run(cfg, 2, 16, 4, cpu)
    assert asked == [BF16]
    monkeypatch.setattr(serve, "build_model", lambda c, g, dtype: build_model(
        c, g, torch.float32))
    drawn = serve.run(cfg, 2, 16, 4, cpu)
    np.testing.assert_array_equal(served["tokens"], drawn["tokens"])
    for key in ("prefill_logits", "logits"):
        assert torch.equal(served[key], drawn[key]), key
