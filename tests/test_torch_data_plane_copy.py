"""The port's copy of the data plane stays the reference's text.

``repro_torch.{core,data,telemetry,chaos}`` are the JAX package's data-plane
modules copied with their ``repro.`` imports renamed to ``repro_torch.``
(the port may import nothing of ``repro``).  Each copy must equal its
reference, read here as a file (nothing of it is imported), after that
rename.  The one edit beyond it: ``Overlord(validate=True)`` raises in the
copy, since the static analysis it would run is not ported.  The
port's ``data`` and ``chaos`` packages have empty ``__init__`` files
(``repro.data`` has none; ``repro.chaos``'s imports its fault injector).
"""
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
PACKAGES = ("core", "data", "telemetry", "chaos")
EMPTY = {"data/__init__.py", "chaos/__init__.py"}

IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)

VALIDATE_REF = """\
        if validate:
            from repro_torch.analysis import AnalysisError, validate_launch
            self.analysis = validate_launch(
                cfg, tree, n_sources=len(self.paths))
            if not self.analysis.ok:
                raise AnalysisError(self.analysis)
"""
VALIDATE_PORT = """\
        if validate:
            raise NotImplementedError(
                "Overlord(validate=True) runs the static analysis, which is "
                "not ported to repro_torch yet (see ROADMAP.md); pass "
                "validate=False")
"""


def _copies():
    return sorted(str(p.relative_to(PORT)) for pkg in PACKAGES
                  for p in (PORT / pkg).glob("*.py"))


def test_the_copy_holds_the_overlords_modules():
    assert len(_copies()) == 29
    assert {"core/orchestrator.py", "chaos/ledger.py",
            "data/cost_models.py", "telemetry/plane.py"} <= set(_copies())


@pytest.mark.parametrize("rel", _copies())
def test_copy_equals_its_reference(rel):
    got = (PORT / rel).read_text()
    if rel in EMPTY:
        assert got == ""
        return
    want = IMPORT.sub(r"\1\2 repro_torch.", (REF / rel).read_text())
    if rel == "core/orchestrator.py":
        assert want.count(VALIDATE_REF) == 1
        want = want.replace(VALIDATE_REF, VALIDATE_PORT)
    assert got == want
