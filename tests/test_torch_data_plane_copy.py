"""The port's copy of the data plane stays the reference's text.

``repro_torch.{core,data,telemetry,chaos,analysis}`` are the JAX package's
data-plane modules copied with their ``repro.`` imports renamed to
``repro_torch.`` (the port may import nothing of ``repro``).  Each copy
must equal its reference, read here as a file (nothing of it is imported),
after that rename, with no edit of its own: 42 files (the Overlord's 29,
the nine of the static analysis behind ``Overlord(validate=True)``, the
chaos injector's three, and the co-located baseline).  The port's ``data``
package has an empty ``__init__`` file (``repro.data`` has none).
"""
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
PACKAGES = ("core", "data", "telemetry", "chaos", "analysis")
EMPTY = {"data/__init__.py"}

IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _copies():
    return sorted(str(p.relative_to(PORT)) for pkg in PACKAGES
                  for p in (PORT / pkg).glob("*.py"))


def test_the_copy_holds_the_overlords_modules():
    assert len(_copies()) == 42
    assert {"core/orchestrator.py", "chaos/ledger.py",
            "data/cost_models.py", "telemetry/plane.py",
            "analysis/config_lint.py", "chaos/injector.py",
            "core/colocated.py"} <= set(_copies())


@pytest.mark.parametrize("rel", _copies())
def test_copy_equals_its_reference(rel):
    got = (PORT / rel).read_text()
    if rel in EMPTY:
        assert got == ""
        return
    want = IMPORT.sub(r"\1\2 repro_torch.", (REF / rel).read_text())
    assert got == want
