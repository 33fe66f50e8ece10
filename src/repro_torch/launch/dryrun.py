"""Dry-run of every (arch x shape x mesh) cell on meta tensors: the port of
``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh local

For each cell it builds the model with meta leaves (shapes and dtypes, no
storage), resolves the sharding rules on the cell's mesh and counts what
each device holds between steps, as the reference does: the train state
(float32 params, AdamW ``mu`` and ``nu``, the int32 step) for a train cell,
the float32 params for a prefill cell, and those plus the cache of
``init_cache(batch, seq_len)`` for a decode cell.  Then it runs the step
the port really runs, once, on meta tensors under ``launch.op_cost``:
``train_step`` on the meta ``TrainState``, the prefill step, or one
decode step (at the cache's last position) on the meta cache.  The meshes
are the production ones (``single`` 16 x 16, ``multi`` 2 x 16 x 16) and
``local``, the (1, 1) mesh of one card.

Then it runs the same step once more, sharded (``collective_pass``): on
the cell's mesh as a fake ``DeviceMesh`` (``launch.collectives``), under
``use_rules(mesh, rules_for(shape))``, with the params, moments and cache
DTensors of meta shards placed by the rules that count
``persistent_bytes_per_device`` and the batch placed by
``batch_logical_axes``; the models' ``shard`` constraints and DTensor's
own redistributions issue the collectives that ``launch.collectives``
counts.

A record has the reference's keys where the port has the quantity:
``arch``, ``shape``, ``mesh``, ``status`` (``ok``; ``skipped`` with the
reference's ``reason``; ``error`` with the traceback), ``params``,
``persistent_bytes_per_device``, ``model_flops``, ``dropped_shardings``
(the reference's list: the fallbacks of the params', cache's and batch's
specs, not of the activations'), ``trace_s`` (the seconds of the meta
pass), and ``collective_counts``, ``collective_result_bytes`` and
``collective_wire_bytes`` (per device, by the reference's kinds).  It adds
``op_flops``, ``op_bytes`` and ``op_count``: the whole global step's
counts on one device, the same on every mesh (the meta pass runs once per
arch and shape); and ``torch``, the release that counted (DTensor's
choices, and so the collectives, change with it).  The reference's
``hlo_flops`` are per device after SPMD partitioning, so the two do not
compare.  It leaves out ``compile_s``,
``memory_analysis``, ``hlo_*`` and ``while_trips``: the port compiles no
program, so there is no compiled HLO, memory analysis or loop nest to
read.  The collectives are DTensor's choices, not GSPMD's; PERF.md
compares the two.

Meta tensors hold no data, so the dry-run runs the same on any machine: it
touches no device and sets no environment variable, and the fake process
group of the sharded pass ends with it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, assigned_archs, get_config,
    shape_applicable,
)
from repro_torch.launch import collectives
from repro_torch.launch.mesh import named_mesh
from repro_torch.launch.op_cost import measure
from repro_torch.models import params as pdefs
from repro_torch.models.model_zoo import (
    batch_logical_axes, build_meta_model, distribute_model, input_specs,
    model_defs,
)
from repro_torch.sharding.logical import (
    DECODE_RULES, LONG_DECODE_RULES, TRAIN_RULES, NamedSharding,
    ShardingRules, distribute, distribute_tree, use_rules,
)
from repro_torch.train.train_step import (
    init_train_state, make_decode_step, make_prefill_step, make_train_step,
)

def rules_for(shape: ShapeConfig):
    if shape.kind != "decode":
        return TRAIN_RULES
    return LONG_DECODE_RULES if shape.name == "long_500k" else DECODE_RULES


def tree_shardings(axes_tree, shapes_tree, rules: ShardingRules, mesh):
    """Map a logical-axes tree + tensor tree -> NamedShardings, leaf by
    leaf in sorted-key order (the reference's ``jax.tree`` order, which
    orders ``rules.dropped``)."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(axes_tree[k], shapes_tree[k], rules, mesh)
                for k in sorted(axes_tree)}
    return NamedSharding(mesh, rules.spec(axes_tree,
                                          tuple(shapes_tree.shape)))


def per_device_bytes(shardings, tensors) -> int:
    total = 0
    for (path, sh), (tpath, t) in zip(pdefs.tree_leaves(shardings),
                                      pdefs.tree_leaves(tensors)):
        if path != tpath:
            raise ValueError(f"shardings and tensors differ: {path} vs "
                             f"{tpath}")
        n = 1
        for d in sh.shard_shape(tuple(t.shape)):
            n *= d
        total += n * t.element_size()
    return total


def persistent_bytes(model, shape: ShapeConfig, mesh,
                     rules: ShardingRules) -> int:
    """What one device holds between steps, for ``model``'s float32
    leaves (meta or real): for a train cell they and ``init_train_state``'s
    moments and step (which it makes), for a prefill cell they, for a
    decode cell they and ``init_cache(global_batch, seq_len)``.  The
    shardings are resolved in the reference's order: params, moments (the
    params' specs), then the cache."""
    specs = pdefs.logical_specs(model_defs(model.cfg))
    params = model.tree()
    total = per_device_bytes(tree_shardings(specs, params, rules, mesh),
                             params)
    if shape.kind == "train":
        opt = init_train_state(model).opt
        total += opt.step.element_size()        # replicated scalar
        for moment in (opt.mu, opt.nu):
            total += per_device_bytes(
                tree_shardings(specs, moment, rules, mesh), moment)
    elif shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        total += per_device_bytes(
            tree_shardings(model.cache_axes(), cache, rules, mesh), cache)
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_total: int) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference); N excludes embeds'
    unused rows but we keep the simple convention N = all params, with MoE
    experts scaled to the active fraction."""
    n_active = n_total
    if cfg.num_experts > 0:
        from repro_torch.models.moe import padded_experts
        per_layer = 3 * cfg.d_model * cfg.d_ff
        n_expert_total = cfg.num_layers * padded_experts(cfg) * per_layer
        n_expert_active = cfg.num_layers * cfg.experts_per_token * per_layer
        n_active = n_total - n_expert_total + n_expert_active
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def step_cost(model, shape: ShapeConfig, batch):
    """Run the cell's step once on ``model`` and ``batch`` (meta, or real
    tensors of the same shapes) under ``op_cost.measure``; its OpCost.  A
    prefill or decode step casts the model's leaves to bf16, as serving
    does."""
    if shape.kind == "train":
        return measure(make_train_step(model), init_train_state(model),
                       batch)[1]
    if shape.kind == "prefill":
        return measure(make_prefill_step(model), batch)[1]
    step = make_decode_step(model)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return measure(step, cache, batch["tokens"], shape.seq_len - 1)[1]


def op_pass(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's step once on meta tensors: its global op counts and the
    seconds the pass took."""
    model = build_meta_model(cfg)
    batch = input_specs(cfg, shape)
    t0 = time.perf_counter()
    cost = step_cost(model, shape, batch)
    return {"trace_s": round(time.perf_counter() - t0, 2),
            "op_flops": cost.flops, "op_bytes": cost.bytes,
            "op_count": cost.ops}


def collective_pass(cfg: ModelConfig, shape: ShapeConfig, mesh_name) -> dict:
    """The cell's step once, sharded on meta DTensors on a fake
    ``mesh_name`` mesh (a name or a ``MeshShape``): the three
    ``collective_*`` keys."""
    mapping = rules_for(shape)
    model = build_meta_model(cfg)
    with collectives.fake_mesh(mesh_name) as mesh, \
            use_rules(mesh, mapping) as rules:
        distribute_model(model, mesh, mapping)
        batch = input_specs(cfg, shape)
        if shape.kind == "decode":
            b, S = shape.global_batch, shape.seq_len
            cache = distribute_tree(model.init_cache(b, S),
                                    model.cache_axes(), rules)
            tokens = distribute(batch["tokens"],
                                rules.spec(("batch", None), (b, 1)), mesh)
            _, tally = collectives.count(make_decode_step(model), cache,
                                         tokens, S - 1)
        else:
            batch = distribute_tree(batch, batch_logical_axes(cfg, shape),
                                    rules)
            if shape.kind == "train":
                _, tally = collectives.count(make_train_step(model),
                                             init_train_state(model), batch)
            else:
                _, tally = collectives.count(make_prefill_step(model), batch)
    return {"collective_counts": tally.counts,
            "collective_result_bytes": tally.result_bytes,
            "collective_wire_bytes": tally.wire_bytes}


def lower_cell(arch: str, shape_name: str, mesh_name: str, *,
               ops: bool = True, op_cache: dict | None = None) -> dict:
    """One cell's record.  ``ops=False`` skips the meta pass and the
    sharded pass (their keys are then null); ``op_cache`` keeps each
    (arch, shape)'s meta pass for the other meshes."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why,
                "torch": torch.__version__}

    model = build_meta_model(cfg)
    mesh = named_mesh(mesh_name)
    rules = ShardingRules(mesh, rules_for(shape))
    n_params = pdefs.param_count(model_defs(cfg))
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "params": n_params,
              "torch": torch.__version__}
    record["persistent_bytes_per_device"] = persistent_bytes(
        model, shape, mesh, rules)
    if shape.kind == "decode":   # the new token's spec, for the fallbacks
        rules.spec(("batch", None), (shape.global_batch, 1))
    else:
        batch = input_specs(cfg, shape)
        tree_shardings(batch_logical_axes(cfg, shape), batch, rules, mesh)
    record["model_flops"] = model_flops(cfg, shape, n_params)
    record["dropped_shardings"] = [
        f"{l}:{d}:{a}" for (l, d, a) in rules.dropped[:20]]
    passed = dict.fromkeys(("trace_s", "op_flops", "op_bytes", "op_count",
                            "collective_counts", "collective_result_bytes",
                            "collective_wire_bytes"))
    if ops:
        key = (arch, shape_name)
        cache = {} if op_cache is None else op_cache
        if key not in cache:
            cache[key] = op_pass(cfg, shape)
        passed.update(cache[key])
        passed.update(collective_pass(cfg, shape, mesh_name))
    record.update(passed)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-ops", action="store_true",
                    help="count bytes and model FLOPs only: no meta pass")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = assigned_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    op_cache: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                path = outdir / f"{arch}__{shape}__{mesh_name}.json"
                if path.exists():
                    print(f"[skip existing] {path.name}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                try:
                    rec = lower_cell(arch, shape, mesh_name,
                                     ops=not args.no_ops, op_cache=op_cache)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "torch": torch.__version__,
                           "traceback": traceback.format_exc()[-4000:]}
                path.write_text(json.dumps(rec, indent=2))
                extra = ""
                if rec["status"] == "ok":
                    gib = rec["persistent_bytes_per_device"] / 2**30
                    extra = f" persistent={gib:.2f}GiB/dev"
                    if rec["op_flops"] is not None:
                        wire = sum(rec["collective_wire_bytes"].values())
                        extra += (f" op_flops={rec['op_flops']:.3e}"
                                  f" trace={rec['trace_s']}s"
                                  f" wire={wire / 2**30:.2f}GiB/dev")
                print(f"  -> {rec['status']}{extra}", flush=True)


if __name__ == "__main__":
    main()
