"""What the benchmark may load: no JAX and no JAX package in a run, and
nothing of the program in the reference; names compared whole."""

import ast
import subprocess
import sys

import pytest

from harness import cell
from harness.spec import BENCH_DIR, REPO

PORT = "apsu_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("loaded, found", [
    ({"apsu_tpu_torch", "apsu_tpu_torch.core.bfv", "numpy"}, []),
    ({"apsu_tpu_torch", "apsu_tpu.core"}, ["apsu_tpu"]),
    ({"jax.numpy", "jaxlib_extra"}, ["jax"]),
    ({"flax", "jaxlib"}, ["flax", "jaxlib"]),
])
def test_forbidden_names_compare_whole(monkeypatch, loaded, found):
    fake = {name: object() for name in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert cell.forbidden_modules() == found


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        names = top_level_imports(path)
        assert not names & {PORT, "apsu_tpu", "jax", "jaxlib", "flax", "harness"}, path


def test_harness_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not top_level_imports(path) & {"apsu_tpu", "jax", "jaxlib", "flax"}, path


def test_a_run_loads_no_jax_package():
    """The port and the harness, imported as a run imports them, load
    neither JAX nor the JAX package."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness.cell, harness.check, "
            "apsu_tpu_torch.api.parties, apsu_tpu_torch.db.receiver_db; "
            "from harness.cell import forbidden_modules; print(forbidden_modules())"
            % (str(BENCH_DIR), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
