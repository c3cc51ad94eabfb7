"""No module of the benchmark imports JAX or the JAX package, and the reference, the yardsticks, the
judgment, the operation counts and the metric readers import nothing of the program.  Top-level module
names are compared whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "riemannhamiltonianmontecarlo_tpu_torch"
# Only these may import the program: the drivers of the system under test and the entry points.
MAY_IMPORT_PROGRAM = {"families", "run.py", "calibrate.py", "tests"}


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported_top_levels(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in MODULES if p.relative_to(ROOT).parts[0] not in MAY_IMPORT_PROGRAM],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_and_reference_import_nothing_of_the_program(path):
    assert PROGRAM not in imported_top_levels(path)


def test_top_level_names_compared_whole():
    """The program's name starts with the JAX package's; only the whole name is forbidden."""
    assert PROGRAM.startswith("riemannhamiltonianmontecarlo_tpu") and PROGRAM not in run.FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.blr, portbench.reference.stochvol, portbench.judge, "
            "portbench.yardstick.ess, portbench.yardstick.bounds, portbench.yardstick.trace, portbench.yardstick.data; "
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', "
            f"'riemannhamiltonianmontecarlo_tpu', '{PROGRAM}'}}; print(sorted(bad)); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
