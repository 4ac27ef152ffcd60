"""ctypes binding of the native WordPiece batch encoder (port of
xlxmert_tpu/data/fast_tokenizer.py).

The library is the port's own copy of the encoder,
`xlxmert_tpu_torch/runtime/tokenizer.cpp`, compiled at first use with
the host C++ compiler (`$CXX`, then `g++`, then `c++`; `-O3 -shared
-fPIC -std=c++17`) into the git-ignored `xlxmert_tpu_torch/_build/`,
under a name that carries a hash of the source and the flags, as
`ops/_build.py` names the kernels' libraries: an edited source is
rebuilt, a built one reused, and nothing is written beside the source.

Behaviour is the JAX package's: rows with a non-ASCII byte go to the
Python tokenizer one row at a time; `do_lower_case=False`, or a failed
build or load, means the Python tokenizer for everything; `native` says
which of the two is in use, and `build_error` why the native one is not
(None when it is). The scalar API is delegated to `Tokenizer`. This is
host code: the card's rule that a kernel has no fallback does not cover
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from xlxmert_tpu_torch.data.tokenization import Tokenizer

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "runtime", "tokenizer.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# library path -> (library or None, error text or None): one build and one
# load per process
_LIBS: Dict[str, Tuple[Optional[ctypes.CDLL], Optional[str]]] = {}
_LOCK = threading.Lock()


def find_cxx() -> Optional[str]:
    """The host C++ compiler: $CXX, then g++, then c++ (None if none)."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libxlt_tokenizer-{h.hexdigest()[:16]}.so")


def _build_and_load(so: str) -> ctypes.CDLL:
    if not os.path.exists(so):
        cxx = find_cxx()
        if cxx is None:
            raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) on "
                               "PATH")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed (exit {proc.returncode}): "
                               f"{(proc.stdout + proc.stderr).strip()}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.xlt_vocab_load.restype = ctypes.c_void_p
    lib.xlt_vocab_load.argtypes = [ctypes.c_char_p]
    lib.xlt_vocab_free.argtypes = [ctypes.c_void_p]
    lib.xlt_encode_batch.restype = ctypes.c_int
    lib.xlt_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def load_library() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(the library, None), or (None, why it could not be built or
    loaded). Built at most once per process and library path."""
    so = library_path()
    with _LOCK:
        if so not in _LIBS:
            try:
                _LIBS[so] = (_build_and_load(so), None)
            except (OSError, RuntimeError, AttributeError,
                    subprocess.SubprocessError) as e:
                # no compiler, a failed build or load: the Python path
                _LIBS[so] = (None, f"{type(e).__name__}: {e}")
        return _LIBS[so]


class FastTokenizer:
    """Drop-in for data/tokenization.Tokenizer's encode_batch, backed by
    the native library when it builds and loads."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        self.py = Tokenizer(vocab_path, do_lower_case)
        self._lib, self._handle = None, None
        self.build_error: Optional[str] = None
        if not do_lower_case:
            self.build_error = ("do_lower_case=False: the native encoder "
                                "implements the uncased tokenizer only")
            return
        self._lib, self.build_error = load_library()
        if self._lib is not None:
            h = self._lib.xlt_vocab_load(str(vocab_path).encode())
            if h:
                self._handle = ctypes.c_void_p(h)
            else:
                self._lib = None
                self.build_error = f"xlt_vocab_load({vocab_path!r}) failed"

    # delegate the scalar API to the Python implementation
    def __getattr__(self, name):
        if name == "py":  # not set yet: no recursion through __getattr__
            raise AttributeError(name)
        return getattr(self.py, name)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def encode_batch(self, texts: List[str], max_length: int = 20
                     ) -> np.ndarray:
        if self._handle is None:
            return self.py.encode_batch(texts, max_length)
        n = len(texts)
        out = np.zeros((n, max_length), np.int32)
        ok = np.zeros((n,), np.uint8)
        c_texts = (ctypes.c_char_p * n)(
            *[t.encode("utf-8", "ignore") for t in texts])
        self._lib.xlt_encode_batch(
            self._handle, c_texts, n, max_length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        for i in np.where(ok == 0)[0]:  # non-ASCII rows: the Python path
            ids = self.py.encode(texts[i], max_length)
            row = np.full((max_length,), self.py.pad_id, np.int32)
            row[: len(ids)] = ids
            out[i] = row
        return out

    def __del__(self):
        try:
            if self._handle is not None:
                self._lib.xlt_vocab_free(self._handle)
        except Exception:
            pass
