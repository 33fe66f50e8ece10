"""``examples/train_e2e_torch.py``, the port of ``examples/train_e2e.py``,
on the CPU at a few steps: it trains from the port's Overlord and passes
its loss checks, and ``--lr 0`` (an update that does nothing) fails them.

At 30 steps, 2 layers and rows of 128 the seeded run closes 0.40 of the
gap to ln(V - 1) (the check asks for 0.3); the default 200 steps, 4
layers, rows of 256 close 0.68 on the CPU and run on the card in
``chip_smoke.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "train_e2e_torch.py"
ARGV = ["--device", "cpu", "--steps", "30", "--layers", "2", "--seq-len",
        "128"]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the example's data-plane threads and the
    other test workers share the CPU, and a full thread pool per worker
    oversubscribes it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _example():
    spec = importlib.util.spec_from_file_location("train_e2e_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_e2e_torch_trains_on_the_cpu():
    out = _example().main(ARGV)
    assert len(out["history"]) == 30
    assert np.isfinite([r["loss"] for r in out["history"]]).all()
    assert out["last"] < out["first"] and out["share"] >= 0.3
    assert out["trainer"].device.type == "cpu"


def test_train_e2e_torch_fails_an_update_that_does_nothing():
    with pytest.raises(AssertionError, match="loss did not improve|gap"):
        _example().main(ARGV + ["--lr", "0"])
