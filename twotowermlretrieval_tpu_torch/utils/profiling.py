"""Tracing: the port of the JAX package's ``utils/profiling.py`` on
``torch.profiler``.

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records CPU activity, plus CUDA activity (CUPTI: every kernel on the card,
  the hand-written ones launched through ctypes included) when a card is
  present, and writes a Chrome/Kineto trace (``<host>_<pid>.<ts>.pt.trace.json``)
  under ``log_dir``: open it in Perfetto or ``chrome://tracing``, no
  TensorBoard needed;
- :func:`annotate`: the program's span, a named region inside a trace
  (``record_function``) while a ``torch.profiler`` session records, and a
  shared no-op context otherwise. The port's spans are named ``ttr.*``
  (the table in ``PERF.md`` §3 says where each opens);
- :class:`TraceWindow`: a trace spanning the first ``n`` events of a
  workload (the server's live searches, each on a request thread of its
  own). A ``torch.profiler`` session belongs to the thread that started
  it, so the window starts and stops it on a thread of its own and asks
  for every thread's CPU operations (``profile_all_threads``, where the
  installed torch has it; CUDA activity is the whole process's in any
  case);
- :func:`trace_summary`: what a written trace says of the card: the device
  operations with the most total time, the busy share of the window (the
  union of device intervals over the trace's span) and the longest idle
  gaps between them.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
from pathlib import Path
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

# the Kineto trace's categories of work on the card
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _profiler(log_dir: str):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:  # an older torch: the starting thread's CPU operations only
        extra = {}
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)),
                   **extra)


def _stop(prof) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the window's kernels end inside it
    prof.stop()  # writes the trace (on_trace_ready)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): step(...)``."""
    prof = _profiler(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        _stop(prof)


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span: ``with annotate("ttr.train.step"): ...``.

    While no ``torch.profiler`` session records, one check of a flag and
    the shared no-op context, nothing else. While one records, a
    ``record_function``, so the span shares the trace's clock with the
    card's kernels and the runtime calls that launched them. The flag is
    the process's, not the thread's: the span also records on the threads
    of a session that profiles every thread (``TraceWindow``) and on the
    autograd engine's thread, which inherits the caller's profiler state.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class _OwnedProfiler:
    """A profiler started and stopped on a thread of its own, whichever
    threads ask: start() returns once it runs (or raises its error), stop()
    once the trace is written (or raises)."""

    def __init__(self, log_dir: str):
        self._log_dir = log_dir
        self._stop_asked = threading.Event()
        self._results: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="trace-window")

    def _run(self):
        try:
            prof = _profiler(self._log_dir)
            prof.start()
        except Exception as e:  # noqa: BLE001 — handed to the caller of start()
            self._results.put(e)
            return
        self._results.put(None)
        self._stop_asked.wait()
        try:
            _stop(prof)
            self._results.put(None)
        except Exception as e:  # noqa: BLE001 — handed to the caller of stop()
            self._results.put(e)

    def _result(self):
        err = self._results.get()
        if err is not None:
            raise err

    def start(self):
        self._thread.start()
        self._result()

    def stop(self):
        self._stop_asked.set()
        self._result()
        self._thread.join()


class TraceWindow:
    """A trace spanning the first ``n`` traced events.

    Lazy start: the first ``event()`` begins the capture, so start-up and
    the kernels' build stay out of the timeline; an exact-once stop after
    the n-th event completes. ``close()`` finalizes an UNFILLED window (the
    trace is only written at stop; the training driver finalizes the same
    way when the run ends inside its window). Thread-safe. A profiler
    failure DISABLES the window with one printed line instead of
    propagating: a profiling flag never fails the workload it observes.
    """

    def __init__(self, log_dir: str, n: int, what: str = "events"):
        if n < 1:
            raise ValueError(f"trace window needs n >= 1, got {n}")
        self._dir = str(log_dir)
        self._remaining = n
        self._what = what
        self._lock = threading.Lock()
        self._prof = None
        self._finished = False  # stopped OR disabled by a profiler error

    @property
    def done(self) -> bool:
        return self._finished

    @contextlib.contextmanager
    def event(self):
        """Context manager around one traced event; a no-op once done."""
        with self._lock:
            if not self._finished and self._prof is None:
                try:
                    prof = _OwnedProfiler(self._dir)
                    prof.start()
                    self._prof = prof
                    print(f"profiler: tracing the next {self._remaining} "
                          f"{self._what} to {self._dir}", flush=True)
                except Exception as e:  # noqa: BLE001 — never fail the workload
                    self._finished = True
                    print(f"profiler: disabled — start failed ({type(e).__name__}: {e})",
                          flush=True)
        try:
            yield
        finally:
            stop = False
            with self._lock:
                if self._prof is not None and not self._finished:
                    self._remaining -= 1
                    if self._remaining <= 0:
                        self._finished = stop = True
            if stop:
                self._finalize()

    def close(self):
        """Finalize an unfilled window (shutdown path)."""
        with self._lock:
            if self._prof is None or self._finished:
                return
            self._finished = True
        self._finalize()

    def _finalize(self):
        try:
            self._prof.stop()
            print(f"profiler: trace written to {self._dir}", flush=True)
        except Exception as e:  # noqa: BLE001 — never fail the workload
            print(f"profiler: stop failed ({type(e).__name__}: {e})", flush=True)


def trace_files(log_dir) -> List[Path]:
    """The Chrome/Kineto traces written under ``log_dir``, oldest first."""
    return sorted(Path(log_dir).rglob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)


def trace_summary(path, top: int = 10, gaps: int = 3) -> dict:
    """What one written trace says of the card: ``device_ops`` (the ``top``
    device operations by total time: name, calls, total ms), ``span_ms``
    (the trace's extent, every event of it), ``busy_ms`` and ``busy_share``
    (the union of the device intervals over that span), ``idle_gaps_ms``
    (the ``gaps`` longest gaps between device intervals, longest first) and
    ``device_events``. A trace without device events has ``busy_share`` 0."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") in _DEVICE_CATEGORIES), key=lambda x: x[0])
    totals: Dict[str, list] = {}
    merged: List[list] = []
    for start, end, name in device:
        tot = totals.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += end - start
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    idle = sorted((b[0] - a[1] for a, b in zip(merged, merged[1:])), reverse=True)
    ops = sorted(totals.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device_ops": [{"name": n, "calls": c, "total_ms": us / 1e3} for n, (c, us) in ops],
        "span_ms": (t1 - t0) / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / max(t1 - t0, 1e-9),
        "idle_gaps_ms": [g / 1e3 for g in idle[:gaps]],
        "device_events": len(device),
    }
