"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone
into ``<build dir>/<name>_<hash>.so``; the hash covers the source, every
``.cuh`` header and the flags, so an edit rebuilds and an unchanged tree
reuses the library. Nothing is built when a module is imported: the first
launch builds (``load``), or :func:`build_all` builds every source at once,
one nvcc process per source, all started together.

The build directory defaults to ``_build/`` inside the package (listed in
``.gitignore``); ``TTR_TORCH_BUILD_DIR`` overrides it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("rnn_fwd", "rnn_bwd", "segmax", "segmax_s8", "topk_stream", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(
        os.environ.get("TTR_TORCH_BUILD_DIR", Path(__file__).resolve().parent.parent / "_build")
    )


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen] | None:
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary name: concurrent builds never publish a
    # half-written library
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def _finish(name: str, job) -> str:
    so, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, so)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel source in parallel; returns nvcc's output (with
    ``-Xptxas -v``: registers, shared memory and spills) per source that
    was built, '' for one found in the cache."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        logs = {}
        errors: List[str] = []
        for name, job in jobs.items():
            if job is None:
                logs[name] = ""
                continue
            try:
                logs[name] = _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
