"""The import rule: nothing the benchmark runs imports JAX, flax or the JAX
package (top-level names compared whole, so the port's ``repro_torch`` is
not ``repro``), and the plain reference imports nothing of the port."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from wabench import cell as cells
from wabench import harness

WABENCH = cells.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in WABENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "streams.py",
                                  "check.py"])
def test_the_reference_imports_nothing_of_the_port(name):
    found = imports(WABENCH / name)
    assert "repro_torch" not in found
    assert found <= {"__future__", "numpy", "torch", "fractions",
                     "concurrent", "pickle", "subprocess", "sys", "wabench"}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def test_a_run_loads_no_jax():
    """A whole (small) run in a fresh process, then its loaded modules."""
    code = (
        "import sys, json, time\n"
        "sys.path[:0] = ['.', 'wabench/tests']\n"
        "from wabench_small import small_cell\n"
        "from wabench import harness\n"
        "if __name__ == '__main__':\n"
        "    c = small_cell('dyn_tpcc_churn_d8', drives=2, events=400)\n"
        "    line, _ = harness.run_cell(c, 3, 0.1, False, 'cpu',\n"
        "                               time.perf_counter(), workers=1)\n"
        "    print(json.dumps([line['correct'],\n"
        "                      harness.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    the command exits with an error and prints no result line."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(WABENCH, tmp_path / "wabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*bench["command"], "--workload", bench["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
