"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone
into ``<build dir>/<name>_<hash>.so``; the hash covers the source, every
``.cuh`` header and the flags, so an edit rebuilds and an unchanged tree
reuses the library. Nothing is built when a module is imported: the first
launch builds (``load``), or :func:`build_all` builds every source at once,
one nvcc process per source, all started together.

The build directory defaults to ``_build/`` inside the package (listed in
``.gitignore``); ``TTR_TORCH_BUILD_DIR`` overrides it. A variant built with
preprocessor ``defines`` (``load("rnn_bwd", ("RNN_BWD_PHASES",))``, the
instrumented backward a timing tool asks for) is a library of its own
beside the shipped one.
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
SOURCES = ("rnn_fwd", "rnn_bwd", "segmax", "segmax_s8", "topk_stream", "attention", "adam")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


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


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, defines: Tuple[str, ...] = ()) -> Tuple[Path, Path, subprocess.Popen] | None:
    so = _target(name, defines)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    # per-process temporary name: concurrent builds never publish a
    # half-written library
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library ``name`` (compiled with ``-D`` each of
    ``defines``), built on first use."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            job = _start(name, defines)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name, defines)))
            _libs[name, defines] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
