"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "detectorch_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"detectorch_tpu_torch"})
    assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch",
                                       "benchmark"}


def test_a_run_loads_no_jax():
    """The whole harness and the program imported in a fresh interpreter
    leave no JAX module behind."""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run as r; "
            "import benchmark.harness.infer, benchmark.tools.calibrate, "
            "benchmark.tools.proposal_count; print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without enough CUDA devices the run exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "fpn_mask.infer_b8", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
