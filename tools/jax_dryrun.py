"""Run the JAX package's dry-run (``repro.launch.dryrun``) on meshes whose
axes are ``Auto``.

From jax 0.9 ``jax.make_mesh`` makes ``Explicit`` axes by default, and
``jax.lax.with_sharding_constraint`` refuses a spec over them, so every
cell of ``python -m repro.launch.dryrun`` ends in ``status: error``.  This
script passes ``axis_types=Auto`` to ``jax.make_mesh`` (older jax, whose
meshes are ``Auto`` already, runs unchanged) and then runs that module's
``main`` with the same arguments.  Nothing under ``src/repro`` changes.

Usage (CPU only; the dry-run sets 512 host devices itself):
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_dryrun.py \\
        --arch qwen3-8b --shape train_4k --mesh single --out results/dryrun
"""
import repro.launch.dryrun as dryrun    # sets XLA_FLAGS before jax starts

import jax


def _auto_axes():
    axis_type = getattr(jax.sharding, "AxisType", None)
    if axis_type is None:
        return
    make_mesh = jax.make_mesh

    def auto_mesh(shape, names, **kw):
        kw.setdefault("axis_types", (axis_type.Auto,) * len(names))
        return make_mesh(shape, names, **kw)
    jax.make_mesh = auto_mesh


if __name__ == "__main__":
    _auto_axes()
    dryrun.main()
