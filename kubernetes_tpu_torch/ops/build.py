"""Build and load the port's native code: CUDA kernels and the host helper.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so
a build takes seconds). Each `csrc/<name>.cc` (the columnar lowering's
host helper) is compiled by `g++ -O2 -shared -fPIC` the same way.
Libraries go to `kubernetes_tpu_torch/build/`, named by a hash of the
sources and flags: an edited source is rebuilt at its next use and a
stale library is never loaded. A build writes a temporary name and
renames it into place, so processes building at the same moment never
load a half-written library. Builds run at first use, or all at once,
in parallel, through `build_all()`; each is recorded in the kernel
ledger (`ops/ledger.py`: compiles and seconds). A missing compiler or a
failed build raises: nothing falls back to another path.
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

# No contraction into FMA either: the host helper's f32 sums round once
# per add, as the NumPy versions do.
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off", "-Wall")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _names(ext: str) -> List[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*" + ext))
    )


def kernel_names() -> List[str]:
    """The CUDA kernels: every csrc/*.cu."""
    return _names(".cu")


def host_names() -> List[str]:
    """The host helpers: every csrc/*.cc."""
    return _names(".cc")


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


def gxx() -> str:
    """The host C++ compiler: g++ on PATH."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host lowering helper cannot be built")
    return found


def _hashed_path(name: str, sources: List[str], flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where the library of csrc/<name>.cu lives, keyed by a hash of the
    kernel's source, the shared headers and the flags."""
    sources = [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )
    return _hashed_path(name, sources, NVCC_FLAGS)


def host_library_path(name: str) -> str:
    """Where the library of csrc/<name>.cc lives, keyed by a hash of its
    source and the flags."""
    return _hashed_path(name, [os.path.join(CSRC, name + ".cc")], GXX_FLAGS)


class _Job:
    """One compiler process writing `out` through a temporary name."""

    def __init__(self, name: str, host: bool):
        self.name = name
        self.host = host
        if host:
            self.tool, self.impl, src = "g++", "host", name + ".cc"
            self.out = host_library_path(name)
            compiler, flags = gxx(), GXX_FLAGS
        else:
            self.tool, self.impl, src = "nvcc", "cuda", name + ".cu"
            self.out = library_path(name)
            compiler, flags = nvcc(), NVCC_FLAGS
        self.src = src
        self.tmp = f"{self.out}.{os.getpid()}.{threading.get_ident()}.tmp"
        self.t0 = time.perf_counter()
        cmd = [compiler, *flags, "-o", self.tmp, os.path.join(CSRC, src)]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def wait(self) -> Dict[str, object]:
        from kubernetes_tpu_torch.ops import ledger

        log, _ = self.proc.communicate()
        seconds = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"{self.tool} failed for csrc/{self.src} (rc {self.proc.returncode}):\n{log}"
            )
        os.replace(self.tmp, self.out)
        ledger.DEFAULT.record_build(self.name, self.impl, seconds)
        return {"name": self.name, "tool": self.tool, "seconds": seconds, "log": log,
                "built": True}


def build_all(
    names: Optional[List[str]] = None, hosts: Optional[List[str]] = None
) -> List[Dict[str, object]]:
    """Build every missing library, one compiler process per source, all
    started together: the kernels `names` (default: every csrc/*.cu)
    with nvcc and the host helpers `hosts` (default: every csrc/*.cc)
    with g++. Returns one record per library (tool, seconds, log)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = kernel_names() if names is None else names
    hosts = host_names() if hosts is None else hosts
    jobs, done = [], []
    try:
        for group, host, path_of in ((names, False, library_path), (hosts, True, host_library_path)):
            for name in group:
                if os.path.exists(path_of(name)):
                    done.append({"name": name, "tool": "g++" if host else "nvcc",
                                 "seconds": 0.0, "log": "", "built": False})
                else:
                    jobs.append(_Job(name, host))
        for job in jobs:
            done.append(job.wait())
    finally:
        for job in jobs:
            if job.proc.poll() is None:
                job.proc.kill()
                job.proc.wait()
            if os.path.exists(job.tmp):
                os.unlink(job.tmp)
    return done


def _load(key: str, path_of: Callable[[], str], build: Callable[[], object],
          bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library loaded under `key`; on its first use (only: hashing
    the sources takes time a launch should not pay) the library at
    `path_of()`, built first if missing, with `bind` run once."""
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = path_of()
            if not os.path.exists(path):
                build()
            lib = ctypes.CDLL(path)
            bind(lib)
            _loaded[key] = lib
        return lib


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing.
    `bind` declares the C functions' argtypes once, at load."""
    return _load(name, lambda: library_path(name), lambda: build_all([name], []), bind)


def load_host(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cc, built with g++ first if
    missing (raises when g++ is missing or the build fails)."""
    return _load(name + ".cc", lambda: host_library_path(name), lambda: build_all([], [name]),
                 bind)


def loaded_libraries() -> int:
    """Libraries this process has loaded (the counterpart of the JAX
    package's compile-cache entries, read by `utils/sli.py`)."""
    with _lock:
        return len(_loaded)
