"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so
a build takes seconds). Libraries go to `kubernetes_tpu_torch/build/`,
named by a hash of the sources and flags: an edited source is rebuilt
at its next use and a stale library is never loaded. Builds run at
first use, or all at once, in parallel, through `build_all()`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no FMA contraction, so f32 scores round exactly as the
# plain version's separate operations do. No fast math anywhere.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def kernel_names() -> List[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Where the library of csrc/<name>.cu lives, keyed by a hash of the
    kernel's source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


class _Job:
    def __init__(self, name: str):
        self.name = name
        self.out = library_path(name)
        self.tmp = f"{self.out}.{os.getpid()}.tmp"
        self.t0 = time.perf_counter()
        cmd = [nvcc(), *NVCC_FLAGS, "-o", self.tmp, os.path.join(CSRC, name + ".cu")]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def wait(self) -> Dict[str, object]:
        log, _ = self.proc.communicate()
        seconds = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{self.name}.cu (rc {self.proc.returncode}):\n{log}"
            )
        os.replace(self.tmp, self.out)
        return {"name": self.name, "seconds": seconds, "log": log, "built": True}


def build_all(names: Optional[List[str]] = None) -> List[Dict[str, object]]:
    """Build every missing library, one nvcc per source, all started
    together. Returns one record per kernel (seconds, ptxas log)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = kernel_names() if names is None else names
    jobs, done = [], []
    try:
        for name in names:
            if os.path.exists(library_path(name)):
                done.append({"name": name, "seconds": 0.0, "log": "", "built": False})
            else:
                jobs.append(_Job(name))
        for job in jobs:
            done.append(job.wait())
    finally:
        for job in jobs:
            if job.proc.poll() is None:
                job.proc.kill()
                job.proc.wait()
    return done


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing.
    `bind` declares the C functions' argtypes once, at load."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            bind(lib)
            _loaded[name] = lib
        return lib
