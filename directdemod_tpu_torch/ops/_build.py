"""Build and load the CUDA kernels in `csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into a shared library under the package's `_build/` directory (listed in
`.gitignore`), then loaded with `ctypes`. The library's file name carries a
hash of the source, the shared headers `csrc/*.cuh` and the compiler flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Flags of one source on top of NVCC_FLAGS. K3 must not contract a * b + c
# into a fused multiply-add where the JAX scan rounds twice: it writes out
# every fused multiply-add it wants.
SOURCE_FLAGS = {"symbol_scan": ("-fmad=false",)}

_libs: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else
    the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def flags(name: str, extra: tuple = ()) -> tuple:
    """The nvcc flags of `csrc/<name>.cu`, with `extra` (a measurement
    build's -D flags) last."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + tuple(extra)


def library_path(name: str, extra: tuple = ()) -> str:
    """Where the build of `csrc/<name>.cu` with `extra` flags lives for its
    current source and the headers beside it (`csrc/*.cuh`)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags(name, extra)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str, extra: tuple = ()) -> str:
    """Compile `csrc/<name>.cu` (with `extra` flags) unless a build of this
    exact source exists; returns the library path. The compiler writes to a
    temporary file that is renamed into place, so concurrent builds never
    load a partial library."""
    out = library_path(name, extra)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *flags(name, extra), "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all(names) -> list[str]:
    """`build` each of `names` (a name, or a (name, extra flags) pair) with
    all compilers running at once; returns the library paths (raises the
    first build failure)."""
    jobs = [(n, ()) if isinstance(n, str) else n for n in names]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(lambda job: build(*job), jobs))


def load(name: str, extra: tuple = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` with `extra` flags, built on
    first use."""
    with _lock:
        key = (name, tuple(extra))
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(build(name, extra))
        return lib
