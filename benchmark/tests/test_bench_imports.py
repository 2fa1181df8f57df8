"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, nothing of the port in the plain reference, and no such module
loaded once a run on the CPU is over."""

import ast
import subprocess
import sys

from benchmark.harness import FORBIDDEN
from conftest import ROOT

BENCH = ROOT / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = [n for n in _imports(path) if _top(n) in FORBIDDEN]
        assert not bad, (path, bad)
    # whole names: the port's name begins with the JAX package's
    assert _top("ugpg_tpu_torch.eval.serving") not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = list(_imports(path))
        assert all(_top(n) in ("torch", "benchmark", "__future__", "contextlib", "copy",
                               "statistics") for n in names), (path, names)
        assert not any(n.startswith("benchmark.") and not n.startswith("benchmark.reference")
                       for n in names), (path, names)


DRY_RUN = """
import sys, json
sys.path[:0] = [{root!r}, {tests!r}]
import pytest, conftest
from benchmark import harness
mp = pytest.MonkeyPatch()
scales = conftest.small_port.__wrapped__(mp)
for cell in ("seg4-serve-bulk", "seg4-train-b8"):
    r = harness.run(cell, 2**31 + 5, 0.5, False, device="cpu", scale=scales[cell], log=lambda s: None)
    assert r["correct"], r
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_cpu_run_loads_no_jax_module():
    code = DRY_RUN.format(root=str(ROOT), tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
