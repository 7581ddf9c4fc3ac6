"""The port stands alone: importing every module of gauspcc_tpu_torch and
chip_smoke loads neither JAX nor any module of the JAX package. Checked in
a fresh interpreter, since this test process has JAX loaded already
(tests/conftest.py). And the port is whole: every module of the JAX
package has its counterpart, and no stub is left."""

import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX modules whose counterpart sits at another path in the port
COUNTERPART = {
    "render/pallas_blend.py": "render/tile_blend.py",  # K1, in CUDA
    "native/__init__.py": "native.py",  # the native builds
    "utils/compile_cache.py": "native.py",  # XLA's cache: the hashed builds
}

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
    assert n_modules >= 64, out.stdout


def _modules(package: str) -> set:
    root = os.path.join(REPO, package)
    return {os.path.relpath(p, root) for p in
            glob.glob(os.path.join(root, "**", "*.py"), recursive=True)}


def test_every_jax_module_has_a_counterpart():
    port = _modules("gauspcc_tpu_torch")
    assert set(COUNTERPART.values()) <= port
    missing = sorted(m for m in _modules("gauspcc_tpu")
                     if COUNTERPART.get(m, m) not in port)
    assert missing == []


def test_no_stub_is_left():
    """No module of the port still raises NotImplementedError for work the
    roadmap's Queue 1 item 7 was to port."""
    stubs = []
    for rel in sorted(_modules("gauspcc_tpu_torch")):
        with open(os.path.join(REPO, "gauspcc_tpu_torch", rel)) as f:
            text = f.read()
        if "NotImplementedError" in text or "Queue 1 item 7" in text:
            stubs.append(rel)
    assert stubs == []
