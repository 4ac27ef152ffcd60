"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source under `xlxmert_tpu_torch/csrc/` becomes one shared library
with a plain `extern "C"` interface, compiled by `nvcc` for Hopper
(`sm_90a`) into `xlxmert_tpu_torch/_build/` (listed in `.gitignore`).
The file name carries a hash of the source and of the local headers
it includes (`#include "..."`: device code two kernels share), so an
edited kernel is rebuilt and a built one is reused. The sources include no PyTorch
header: a build takes seconds, not minutes, and needs no `ninja`.

Each source exports `<name>_launch`, which returns the `cudaError_t` of
its launch, and `<name>_error_string`;
`Kernel.launch` raises if it is not 0 and otherwise adds one to the
kernel's launch count, which is how a run shows that it went through the
kernel. A count means the launches a call makes: a CUDA graph's replay
adds those its capture made (`launch_counts`, `add_launches`). Nothing
here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC"]

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


class _Build(NamedTuple):
    proc: subprocess.Popen
    tmp: str
    so: str
    t0: float


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put nvcc "
                       "on PATH (the kernels are built on the machine with "
                       "the card)")


# every Kernel made, in the order the modules made them
KERNELS: List["Kernel"] = []


class Kernel:
    """One CUDA source, its shared library and its launch count.

    `argtypes` are the ctypes types of `<name>_launch`'s arguments: every
    pointer and the stream c_void_p, ints c_int, 64-bit strides
    c_longlong (ctypes would otherwise pass a 32-bit int)."""

    def __init__(self, name: str, source: str, argtypes: List):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        KERNELS.append(self)

    # -- build -------------------------------------------------------------
    def sources(self) -> List[str]:
        """The source and every local header it includes, transitively."""
        seen, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in seen:
                continue
            seen.append(path)
            with open(path, "rb") as f:
                todo += [os.path.join(os.path.dirname(path), m.decode())
                         for m in _LOCAL_INCLUDE.findall(f.read())]
        return seen

    def so_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.sources():
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:16]}.so")

    def start_build(self, verbose: bool = False) -> Optional[_Build]:
        """Start nvcc for this source unless its library is built;
        returns the process (None when there is nothing to build)."""
        so = self.so_path()
        if os.path.exists(so):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose
                                             else []) + [
            "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return _Build(proc, tmp, so, time.time())

    def finish_build(self, build: Optional[_Build]) -> None:
        if build is None:
            return
        log, _ = build.proc.communicate()
        self.build_seconds = time.time() - build.t0
        self.build_log = log
        if build.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {build.proc.returncode}):\n{log}")
        os.replace(build.tmp, build.so)

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.so_path())
                fn = getattr(lib, f"{self.name}_launch")
                fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    # -- launch ------------------------------------------------------------
    def launch(self, *args) -> None:
        lib = self.lib()
        code = getattr(lib, f"{self.name}_launch")(*args)
        if code != 0:
            msg = getattr(lib, f"{self.name}_error_string")(code)
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{code} ({msg.decode()})")
        self.launches += 1


def launch_counts() -> Dict[Kernel, int]:
    """Each kernel's launch count now."""
    return {k: k.launches for k in KERNELS}


def add_launches(counts: Dict[Kernel, int]) -> None:
    """Add `counts` (negative to take launches back) to the kernels'
    launch counts."""
    for k, n in counts.items():
        k.launches += n


def build_all(kernels: Sequence[Kernel], verbose: bool = True) -> float:
    """Build every kernel's library at once (one nvcc each, all started
    together) and load them. Returns the wall-clock seconds."""
    t0 = time.time()
    procs = [(k, k.start_build(verbose)) for k in kernels]
    for k, proc in procs:
        k.finish_build(proc)
    for k in kernels:
        k.lib()
    return time.time() - t0
