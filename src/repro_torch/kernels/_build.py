"""Build and load the hand-written CUDA kernels (`kernels/csrc/*.cu`).

Each `.cu` source is compiled with nvcc into its own shared library with
a plain C interface, at first use, and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

The library name carries a hash of every file under `csrc/` (sources and
shared headers) plus the flags, so an edited kernel is never served a
stale build.  The build directory `build/` at the repository root is
git-ignored.  `torch.utils.cpp_extension` is not used: a file that
includes PyTorch's headers takes minutes to compile, a plain C one
seconds.

Every C entry point returns `cudaGetLastError()` after its launch; the
wrappers raise on a nonzero code (a refused launch never runs, and a
later synchronize would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (searched PATH and "
                           f"{path}); the CUDA kernels need the CUDA "
                           "toolkit")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(*names: str) -> None:
    """Compile every named kernel that has no current build, one nvcc per
    source, all started together.  Each writes a private temp file that is
    renamed into place, so a concurrent or interrupted build never leaves
    a half-written library under the final name."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    try:
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            jobs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for n, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu (exit "
                                   f"{proc.returncode}):\n{out}")
            os.replace(tmp, library_path(n))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{code}")
