"""The port stands alone: importing every module of gauspcc_tpu_torch and
chip_smoke loads neither JAX nor any module of the JAX package. Checked in
a fresh interpreter, since this test process has JAX loaded already
(tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import gauspcc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gauspcc_tpu_torch.__path__,
                                               "gauspcc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "gauspcc_tpu"
             or m.startswith("gauspcc_tpu."))
print(len(names), "modules")
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 48, out.stdout
