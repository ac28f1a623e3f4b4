"""The port's CUDA kernels as one shared library, and their entry points.

Every source in `SOURCES` (`csrc/*.cu`: K1 and K2 of `ops/best_match.py`,
the pose-only Gauss-Newton of `optim/ba.py`) is compiled by one nvcc call
for sm_90a into `multicol_slam_tpu_torch/build/`, at first use, and loaded
with ctypes. The library's name carries a tag hashed over every source and
the flags, so only the first run in a checkout builds, and an edit to any
source builds anew.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "best_match.cu", CSRC / "pose_opt.cu")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build_tag(sources: Sequence[Path], flags: Sequence[str]) -> str:
    """12 hex digits of a hash over each source's name and bytes, in order,
    and the flags."""
    h = hashlib.sha1()
    for src in sources:
        data = Path(src).read_bytes()
        h.update(f"{Path(src).name}:{len(data)}:".encode())
        h.update(data)
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


class Library:
    """The shared library built from `SOURCES`, compiled once per content and
    loaded once: a lock serialises the build and the load, so that the first
    calls of the tracker and of the mapping worker make one library."""

    def __init__(self):
        self.log = ""
        self._lib = None
        self._lock = threading.RLock()

    def path(self) -> Path:
        return BUILD_DIR / f"libmcslam_kernels_{build_tag(SOURCES, NVCC_FLAGS)}.so"

    def build(self) -> Path:
        """Compile the sources (once per content) and return the library path."""
        with self._lock:
            lib = self.path()
            if lib.is_file():
                return lib
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                                      capture_output=True, text=True)
                self.log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    names = ", ".join(s.name for s in SOURCES)
                    raise RuntimeError(f"nvcc failed on {names}:\n{self.log}")
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return lib

    def symbol(self, name: str):
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return getattr(self._lib, name)


LIBRARY = Library()


class KernelEntry:
    """One entry point of the library and its launch count. `launches` goes
    up by one each time the entry's wrapper launches it (`count`), and
    nowhere else; `by_thread` splits the same count by the launching
    thread's name (the tracker and the mapping worker both launch K1)."""

    def __init__(self, symbol: str, argtypes, restype=ctypes.c_int):
        self.symbol_name = symbol
        self.argtypes = argtypes
        self.restype = restype
        self.launches = 0
        self.by_thread: Dict[str, int] = {}
        self._fn = None
        self._count_lock = threading.Lock()

    def count(self):
        with self._count_lock:
            self.launches += 1
            name = threading.current_thread().name
            self.by_thread[name] = self.by_thread.get(name, 0) + 1

    def thread_launches(self) -> int:
        """The launches made so far by the calling thread."""
        return self.by_thread.get(threading.current_thread().name, 0)

    def build(self) -> Path:
        return LIBRARY.build()

    @property
    def build_log(self) -> str:
        return LIBRARY.log

    def function(self):
        if self._fn is None:
            fn = LIBRARY.symbol(self.symbol_name)
            fn.argtypes = self.argtypes
            fn.restype = self.restype
            self._fn = fn
        return self._fn


def check_all(checks, dev):
    """Dtype, shape, contiguity, device and 4-byte alignment of each input:
    (name, tensor, dtype, shape) tuples."""
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} is not 4-byte aligned")
