"""The port stands without JAX, and chip_smoke.py refuses to run without a card.

The machine with the card has no JAX, so importing the port must not pull
it in. conftest.py has already imported JAX into this process, so the
check runs in a fresh interpreter.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import detectorch_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _port_modules():
    return ["detectorch_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(detectorch_tpu_torch.__path__,
                                              "detectorch_tpu_torch.")]


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "detectorch_tpu_torch.ops.cuda.roi_align_kernel" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "print('LEAKED', leaked)\n"
            "sys.exit(1 if leaked else 0)\n")
    proc = _python(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "detectorch_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = [p for p in paths if pattern.search(open(p).read())]
    assert not offenders


def test_chip_smoke_fails_without_a_card(tmp_path):
    # in the checkout, on a machine without CUDA
    proc = _python(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _python(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
