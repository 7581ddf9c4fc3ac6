"""The JAX package's native libraries, made present atomically for the
port's tests.

`gauspcc_tpu/ops/coder.py` and `gauspcc_tpu/ops/hostmap.py` build their
shared library on first load: when it is missing or older than its
source, g++ writes it straight onto its final path, and `ctypes.CDLL`
opens any file there. Under a parallel run (pytest-xdist) one process can
open the file while another is still writing it ("file too short").

`ensure_jax_native_libs()` builds each library under an `fcntl.flock`
lock file, with the JAX package's own g++ command, into a temporary name
in the same directory, and moves it onto its path with `os.replace`
(atomic), unless it is already there and newer than its source; then it
loads it through the JAX package's `_load`, retrying on OSError for a
bounded time, since a JAX test in another process may still be writing
the file in place. Every port test file that reaches those loaders calls
it when it is imported. A pytest-xdist worker imports every test file
before any test runs, so in a whole run the libraries are in place before
the JAX package's own tests load them too; a JAX test file run without
the port's can still lose the race in its first test, which only the
JAX package's loaders could prevent.
"""

import fcntl
import importlib
import os
import subprocess
import sys
import textwrap
import time

# the JAX modules that build a library, and the source each builds from
LIBRARIES = {"gauspcc_tpu.ops.coder": "ac_coder.cpp",
             "gauspcc_tpu.ops.hostmap": "neighbor.cpp"}
LOAD_TIMEOUT_S = 120.0


def _fresh(lib_path: str, src: str) -> bool:
    """The JAX loaders' test, negated: present and not older than src."""
    return (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src))


def build_atomically(mod, src: str) -> None:
    """Make mod._LIB_PATH present and fresh: under a lock file beside it,
    build with mod._build_library into a temporary name in its directory
    and os.replace it onto the path, unless it is fresh already."""
    final = mod._LIB_PATH
    with open(final + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(final, src):
            return
        tmp = f"{final[:-len('.so')]}.{os.getpid()}.tmp.so"
        mod._LIB_PATH = tmp  # _build_library writes to mod._LIB_PATH
        try:
            mod._build_library()
        finally:
            mod._LIB_PATH = final
        os.replace(tmp, final)


def load_with_retry(mod, timeout_s: float = LOAD_TIMEOUT_S):
    """mod._load(), retried on OSError until `timeout_s` has passed."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return mod._load()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.25)


def ensure_jax_native_libs() -> None:
    """Both JAX native libraries present, fresh and loaded in this process."""
    for name, source in LIBRARIES.items():
        mod = importlib.import_module(name)
        build_atomically(mod, os.path.join(os.path.abspath(mod._NATIVE_DIR),
                                           source))
        load_with_retry(mod)


# a stand-in for a JAX loader module: its build writes the library slowly,
# in pieces, as a compiler does, and its load refuses a short file as
# ctypes.CDLL does
_FAKE_LOADER = '''
import os, time
_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfake.so")
SIZE = 1 << 20
_lib = None

def _build_library():
    with open(_LIB_PATH, "wb") as f:
        for _ in range(64):
            f.write(b"x" * (SIZE // 64))
            f.flush()
            time.sleep(0.005)

def _load():
    global _lib
    if _lib is None:
        if os.path.getsize(_LIB_PATH) != SIZE:
            raise OSError(_LIB_PATH + ": file too short")
        _lib = "loaded"
    return _lib
'''


def test_ensure_loads_both_jax_libraries():
    ensure_jax_native_libs()
    for name, source in LIBRARIES.items():
        mod = importlib.import_module(name)
        assert mod._lib is not None, name
        assert _fresh(mod._LIB_PATH,
                      os.path.join(os.path.abspath(mod._NATIVE_DIR), source))


def test_concurrent_builds_never_expose_a_partial_library(tmp_path):
    """Six processes start together on a directory without the library:
    one builds it, the others wait on the lock, and every one loads the
    whole file on its first try."""
    (tmp_path / "fake_loader.py").write_text(_FAKE_LOADER)
    (tmp_path / "src.cpp").write_text("// the library's source\n")
    past = time.time() - 60
    os.utime(tmp_path / "src.cpp", (past, past))
    here = os.path.dirname(os.path.abspath(__file__))
    child = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(tmp_path)!r}, {here!r}]
        import fake_loader
        from test_torch_native_libs import build_atomically
        build_atomically(fake_loader, {str(tmp_path / 'src.cpp')!r})
        print(fake_loader._load())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", child],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert os.path.getsize(tmp_path / "libfake.so") == 1 << 20
    assert not list(tmp_path.glob("*.tmp.so"))
    # fresh now: a later call builds nothing
    mtime = os.path.getmtime(tmp_path / "libfake.so")
    sys.path.insert(0, str(tmp_path))
    try:
        fake = importlib.import_module("fake_loader")
        build_atomically(fake, str(tmp_path / "src.cpp"))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("fake_loader", None)
    assert os.path.getmtime(tmp_path / "libfake.so") == mtime


def test_load_retries_while_the_file_is_being_written(tmp_path):
    """A load that meets a short file (another process writing it in place)
    succeeds once the file is whole, within the bound."""
    calls = []

    class Loader:
        @staticmethod
        def _load():
            calls.append(time.monotonic())
            if len(calls) < 3:
                raise OSError("file too short")
            return "loaded"

    assert load_with_retry(Loader, timeout_s=10) == "loaded"
    assert len(calls) == 3

    class Broken:
        @staticmethod
        def _load():
            raise OSError("file too short")

    t0 = time.monotonic()
    try:
        load_with_retry(Broken, timeout_s=0.5)
    except OSError:
        pass
    else:
        raise AssertionError("a file that never becomes whole must raise")
    assert time.monotonic() - t0 < 5
