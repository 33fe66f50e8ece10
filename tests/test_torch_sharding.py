"""The port's sharding rules and meshes against the JAX package's.

Every parameter leaf's spec and every fallback the rules record, for each
assigned arch, rule table and mesh (16 x 16, 2 x 16 x 16, 1 x 1), equal
``repro.sharding.logical``'s on a shape-only mesh (as in
``test_sharding_hlo.py``); so do the batch and cache axes and the dry-run's
input stand-ins.  The local mesh is a real gloo ``DeviceMesh`` of one rank,
torn down by every test that starts it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.sharding import logical as jlogical
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import params as tparams
from repro_torch.sharding import logical as tlogical

ARCHS = jconfigs.assigned_archs()
TABLES = ("TRAIN_RULES", "DECODE_RULES", "LONG_DECODE_RULES")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}
FAMILY_ARCHS = ["qwen3-8b", "qwen3-moe-30b-a3b", "pixtral-12b", "zamba2-7b",
                "whisper-medium", "rwkv6-3b"]


class FakeMesh:
    """Shape-only stand-in so rule resolution is testable without devices."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _jax_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {".".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_rule_tables_equal():
    for name in ("_COMMON",) + TABLES:
        assert getattr(tlogical, name) == getattr(jlogical, name), name


def test_assigned_archs_and_shapes_equal():
    assert tconfigs.assigned_archs() == ARCHS
    assert {k: tuple(vars(v).values()) for k, v in tconfigs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        for shape in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(
                tconfigs.get_config(arch), tconfigs.SHAPES[shape]) == \
                jconfigs.shape_applicable(jconfigs.get_config(arch),
                                          jconfigs.SHAPES[shape])


@pytest.mark.parametrize("entries", [
    (("data",), "model"), (("pod", "data"), None), ((), "model"),
    (None, None), ("data", ("data", "model")), ()])
def test_partition_spec_normalises_as_jax(entries):
    assert tuple(tlogical.PartitionSpec(*entries)) == tuple(JP(*entries))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_dropped_equal_jax(arch, table, mesh):
    jrules = jlogical.ShardingRules(FakeMesh(MESHES[mesh]),
                                    getattr(jlogical, table))
    jdefs = jzoo.build_model(jconfigs.get_config(arch)).defs
    jspecs = {p: tuple(jrules.spec(d.axes, d.shape)) for p, d in
              _jax_leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes")).items()}
    sizes = MESHES[mesh]
    tmeshshape = tmesh.MeshShape(tuple(sizes), tuple(sizes.values()))
    shardings, trules = tlogical.param_shardings(
        tzoo.model_defs(tconfigs.get_config(arch)), tmeshshape,
        getattr(tlogical, table))
    tspecs = {p: tuple(s.spec) for p, s in tparams.tree_leaves(shardings)}
    assert tspecs == jspecs
    assert trules.dropped == jrules.dropped


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_axes_and_input_specs_equal_jax(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape, tshape = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    assert tzoo.batch_logical_axes(tcfg, tshape) == \
        jzoo.batch_logical_axes(jcfg, jshape)
    jin = jzoo.input_specs(jcfg, jshape)
    tin = tzoo.input_specs(tcfg, tshape)
    assert sorted(tin) == sorted(jin)
    for k in jin:
        assert tin[k].device.type == "meta"
        assert (tuple(tin[k].shape), _dtype_name(tin[k].dtype)) == \
            (tuple(jin[k].shape), _dtype_name(jin[k].dtype)), k


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_axes_and_meta_cache_equal_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jmodel = jzoo.build_model(jcfg)
    tmodel = tzoo.build_meta_model(tcfg)
    assert tmodel.cache_axes() == jmodel.cache_axes()
    jcache = _jax_leaves(jax.eval_shape(lambda: jmodel.init_cache(2, 48)))
    tcache = dict(tparams.tree_leaves(tmodel.init_cache(2, 48)))
    assert {p: (tuple(t.shape), _dtype_name(t.dtype))
            for p, t in tcache.items()} == \
        {p: (tuple(t.shape), _dtype_name(t.dtype))
         for p, t in jcache.items()}
    # the axes tree has a rank-matched tuple for every cache leaf
    axes = dict(tparams.tree_leaves(tmodel.cache_axes()))
    assert sorted(axes) == sorted(tcache)
    assert all(len(axes[p]) == tcache[p].dim() for p in axes)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_params_equal_jax_abstract(arch):
    jdefs = jzoo.build_model(jconfigs.get_config(arch)).defs
    jabs = _jax_leaves(jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype or jnp.float32),
        jdefs, is_leaf=lambda x: hasattr(x, "axes")))
    tabs = dict(tparams.tree_leaves(
        tzoo.build_meta_model(tconfigs.get_config(arch)).tree()))
    assert {p: (tuple(t.shape), _dtype_name(t.dtype), t.device.type)
            for p, t in tabs.items()} == \
        {p: (tuple(t.shape), _dtype_name(t.dtype), "meta")
         for p, t in jabs.items()}
    from repro.models import params as jparams
    assert dict(tparams.tree_leaves(tparams.logical_specs(tzoo.model_defs(
        tconfigs.get_config(arch))))) == _jax_leaves(
            jparams.logical_specs(jdefs), is_leaf=lambda x: isinstance(
                x, tuple))


def test_shard_is_a_no_op_outside_rules_and_checks_rank():
    x = torch.zeros(4, 8)
    assert tlogical.current_rules() is None
    assert tlogical.shard(x, "batch", "act_embed") is x
    assert tlogical.spec_for(("batch", None), (4, 8)) == \
        tlogical.PartitionSpec()
    mesh = tmesh.make_production_mesh()
    with tlogical.use_rules(mesh, tlogical.TRAIN_RULES) as rules:
        assert tlogical.current_rules() is rules
        assert tlogical.shard(x, "batch", "act_embed") is x
        assert tuple(tlogical.spec_for(("batch", "act_mlp"), (32, 64))) == \
            tuple(JP(("data",), "model"))
        with pytest.raises(ValueError, match="rank-2"):
            tlogical.shard(x, "batch")
    assert tlogical.current_rules() is None


def test_production_meshes_and_local_shapes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (tmesh.data_axes(single), tmesh.dp_degree(single)) == (
        ("data",), 16)
    assert (tmesh.data_axes(multi), tmesh.dp_degree(multi)) == (
        ("pod", "data"), 32)
    from torch.distributed.tensor import Replicate, Shard
    spec = tlogical.PartitionSpec(("pod", "data"), "model", None)
    assert tlogical.placements(spec, multi) == (Shard(0), Shard(0), Shard(1))
    assert tlogical.local_shape(spec, (64, 32, 5), multi) == (2, 2, 5)
    assert tlogical.placements(tlogical.PartitionSpec(None, "data"),
                               single) == (Shard(1), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        tlogical.placements(tlogical.PartitionSpec(("model", "data")), single)
    with pytest.raises(ValueError, match="does not divide"):
        tlogical.local_shape(tlogical.PartitionSpec("model"), (24,), single)


def test_gloo_local_mesh_distributes_with_the_rules_placements():
    assert not dist.is_initialized()
    cfg = tconfigs.get_config("qwen3-8b").replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    model = tzoo.build_model(cfg, torch.Generator().manual_seed(0))
    try:
        with tmesh.local_mesh("cpu") as mesh:
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            assert tlogical.mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
            assert (tmesh.data_axes(mesh), tmesh.dp_degree(mesh)) == (
                ("data",), 1)
            from torch.distributed.tensor import distribute_tensor
            shardings, rules = tlogical.param_shardings(
                tzoo.model_defs(cfg), mesh, tlogical.TRAIN_RULES)
            specs = dict(tparams.tree_leaves(shardings))
            for path, p in tparams.tree_leaves(model.tree()):
                sh = specs[path]
                d = distribute_tensor(p.detach(), mesh, sh.placements())
                assert tuple(d.to_local().shape) == sh.shard_shape(
                    tuple(p.shape))
                assert torch.equal(d.to_local(), p)
                assert torch.equal(d.full_tensor(), p)
            assert rules.dropped == []
            from torch.distributed.tensor import DTensor, Replicate, Shard
            x = DTensor.from_local(torch.ones(4, 8), mesh, (Shard(0),
                                                            Replicate()))
            with tlogical.use_rules(mesh):
                y = tlogical.shard(x, "batch", "act_embed")
            assert y.placements == (Replicate(), Replicate())
            assert torch.equal(y.to_local(), x.to_local())
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_local_mesh_leaves_a_callers_group_running():
    assert not dist.is_initialized()
    try:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        with tmesh.local_mesh("cpu") as mesh:
            assert mesh.shape == (1, 1)
        assert dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_local_shapes_match_jax_shard_shapes_on_a_fake_mesh():
    """``NamedSharding.shard_shape`` over every qwen3-moe leaf on the
    multi-pod mesh, against the dims the JAX spec divides by."""
    sizes = MESHES["2x16x16"]
    cfg = tconfigs.get_config("qwen3-moe-30b-a3b")
    shardings, _ = tlogical.param_shardings(
        tzoo.model_defs(cfg), tmesh.make_production_mesh(multi_pod=True))
    jrules = jlogical.ShardingRules(FakeMesh(sizes), jlogical.TRAIN_RULES)
    jdefs = _jax_leaves(jzoo.build_model(jconfigs.get_config(
        "qwen3-moe-30b-a3b")).defs, is_leaf=lambda x: hasattr(x, "axes"))
    for path, sh in tparams.tree_leaves(shardings):
        d = jdefs[path]
        want = []
        for dim, entry in zip(d.shape, tuple(jrules.spec(d.axes, d.shape))):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            want.append(dim // int(np.prod([sizes[a] for a in axes])))
        assert sh.shard_shape(d.shape) == tuple(want), path
