"""Native (C++) batch tokenizer, built on demand.

The port's copy of the JAX package's ``native/``: the batch tokenizer (a
hash-map vocabulary and an ASCII scanner, OpenMP over rows) in
``tokenizer.cc``, a byte-for-byte copy of the JAX package's source,
compiled once with g++ and loaded with ctypes. Rows with non-ASCII text,
and machines without a toolchain, take the Python path with identical
results (``Tokenizer.encode_batch``).

The library is built into the port's build directory (``_build/`` inside
the package, listed in ``.gitignore``; ``TTR_TORCH_BUILD_DIR`` overrides
it, as for the CUDA kernels), named by a hash of the source and the
flags, so an edit rebuilds and an unchanged source reuses the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

from twotowermlretrieval_tpu_torch.ops._build import build_dir

_SRC = Path(__file__).resolve().parent / "tokenizer.cc"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"tokenizer_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so_path = library_path()
    if so_path.exists():
        return so_path
    so_path.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary name: two processes building at once never
    # publish a half-written library
    tmp_path = so_path.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp_path)],
                       check=True, capture_output=True)
        os.replace(tmp_path, so_path)
    finally:
        tmp_path.unlink(missing_ok=True)
    return so_path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (with the reason recorded)."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.vocab_create.restype = ctypes.c_void_p
            lib.vocab_create.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ]
            lib.vocab_free.restype = None
            lib.vocab_free.argtypes = [ctypes.c_void_p]
            lib.vocab_size.restype = ctypes.c_int64
            lib.vocab_size.argtypes = [ctypes.c_void_p]
            lib.encode_batch.restype = None
            lib.encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _lib_error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
            print(f"native tokenizer unavailable ({_lib_error}); using the Python path",
                  file=sys.stderr)
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def native_error() -> Optional[str]:
    get_lib()
    return _lib_error
