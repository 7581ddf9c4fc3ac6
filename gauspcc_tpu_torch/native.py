"""Build and load the port's hand-written CUDA kernels and its host C++.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/lib<name>-<hash>.so`, then loaded
with `ctypes`. The build runs at first use, in the process that needs the
kernel, and again only when the source's content hash changes. Nothing
here includes PyTorch's headers, so a build takes seconds.

`load_host` does the same for a host library, `csrc/<name>.cpp`, with
`g++ -O3 -march=native` (the native arithmetic coder). Its flags are the
JAX package's own build of that coder, so the two write the same bytes on
one machine; since `-march=native` ties the library to the CPU that built
it, the build's hash also covers the CPU's model and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
GXX_LIBS = ("-lpthread",)


class BuiltLibrary:
    """A loaded kernel library with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when an existing build was reused
        self.log = log  # nvcc's output, also when a build was reused


_loaded: dict[str, BuiltLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (set CUDA_HOME or PATH)")


def load(name: str) -> BuiltLibrary:
    """Compile (if needed) and load `csrc/<name>.cu`."""
    return load_source(CSRC / f"{name}.cu")


def load_source(src: Path) -> BuiltLibrary:
    """Compile (if needed) and load the CUDA source `src`. A wrapper calls
    this on every launch, so a loaded library is found by the path as
    given, without touching the file system."""
    key = str(src)
    if key in _loaded:
        return _loaded[key]
    _loaded[key] = _build(Path(src), lambda out, src: [
        _nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)], "nvcc", b"")
    return _loaded[key]


def load_host(name: str) -> BuiltLibrary:
    """Compile (if needed) and load the host C++ source `csrc/<name>.cpp`
    with g++. A failed build raises with g++'s output; nothing falls back."""
    key = f"host:{name}"
    if key in _loaded:
        return _loaded[key]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: it builds csrc/{name}.cpp")
    _loaded[key] = _build(CSRC / f"{name}.cpp", lambda out, src: [
        gxx, *GXX_FLAGS, str(src), "-o", str(out), *GXX_LIBS], "g++",
        _cpu_fingerprint())
    return _loaded[key]


def _cpu_fingerprint() -> bytes:
    """The CPU's model name and feature flags: what `-march=native` reads."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode() or platform.processor().encode()


def _build(src: Path, command, compiler: str, salt: bytes) -> BuiltLibrary:
    """Build `src` into `build/lib<stem>-<hash>.so` by `command(out, src)`
    unless that file exists; the hash covers the source and `salt`."""
    digest = hashlib.sha256(src.read_bytes() + salt).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    log_path = out.with_name(f"{out.name}.log")  # the compiler's report
    seconds = 0.0
    log = log_path.read_text() if log_path.exists() else ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(command(tmp, src), capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed on {src} "
                               f"(exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
