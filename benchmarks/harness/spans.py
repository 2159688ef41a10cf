"""The program's own spans (``ttr.*``) in a traced window, and the
arithmetic the per-layer metrics that read them share.

The port opens its spans (``utils/profiling.py`` ``annotate``) at the
boundaries of its layers; in a ``torch.profiler`` trace they share one
clock with the CUDA runtime's calls and with the card's kernels, copies
and memsets. Here:

- a device operation is put down to the runtime (or driver) call that
  launched it, matched by ``args.correlation``, and so to the innermost
  ``ttr.*`` span open on that call's thread when the call began. A thread
  that opens no ``ttr.*`` span at all (the autograd engine's, during
  ``torch.autograd.grad``) takes the innermost span open on any thread;
- a synchronizing call (``SYNC_CALLS``: the host waits for the card) is
  put down to a span the same way, by its start;
- a span's device time counts every operation launched in it or in a span
  nested in it.

Every reading is None where the trace has no ``ttr.*`` span (a program
without them) or no device operation (a CPU run). ``python -m
benchmarks.harness.spans <trace.json>`` prints a trace's breakdown by span,
e.g. of a ``--profile_dir`` window of the training driver.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "ttr."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the runtime and driver calls that return only once the card has reached
# a point: the explicit waits, and the synchronous copies (a copy from
# pageable memory is an asynchronous copy and a stream synchronize)
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyPeer",
    "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyHtoD", "cuMemcpyDtoH", "cuMemcpyDtoD", "cuMemcpy2D",
    "cuMemcpy3D", "cuMemcpyPeer",
})
_API_SUFFIX = re.compile(r"(_v\d+)?(_pt[sd]z)?$")


def sync_call(name: str) -> bool:
    return _API_SUFFIX.sub("", str(name)) in SYNC_CALLS


def _host_span(e: dict) -> bool:
    cat = str(e.get("cat", ""))
    return (str(e.get("name", "")).startswith(SPAN_PREFIX) and not cat.startswith("gpu_")
            and cat not in DEVICE_CATEGORIES)


def _segments(spans: Sequence[Tuple[float, float, int]]):
    """Nested spans of one thread, (start, end, index) sorted by start, as
    disjoint (start, end, innermost index) pieces in time order, and each
    span's parent index (None at the top)."""
    out: List[Tuple[float, float, int]] = []
    parent: Dict[int, Optional[int]] = {}
    stack: List[Tuple[float, float, int]] = []
    cursor = 0.0

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            _, end, i = stack.pop()
            if end > cursor:
                out.append((cursor, end, i))
                cursor = end

    for start, end, i in spans:
        close_until(start)
        if stack and start > cursor:
            out.append((cursor, start, stack[-1][2]))
        parent[i] = stack[-1][2] if stack else None
        stack.append((start, end, i))
        cursor = max(cursor, start)
    close_until(float("inf"))
    return out, parent


class Spans:
    """The ``ttr.*`` spans, launches, device operations and synchronizing
    calls of one trace. Times in microseconds, on the trace's clock."""

    def __init__(self, events: Sequence[dict]):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        # by start, the outer of two spans that start together first
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                         e.get("tid")) for e in events if _host_span(e)),
                       key=lambda s: (s[0], -s[1]))
        self.spans = spans
        self.parent: Dict[int, Optional[int]] = {}
        self._threads: Dict[object, Tuple[List[float], list]] = {}
        by_tid: Dict[object, list] = {}
        for i, (a, b, _, tid) in enumerate(spans):
            by_tid.setdefault(tid, []).append((a, b, i))
        for tid, own in by_tid.items():
            segs, parent = _segments(own)
            self.parent.update(parent)
            self._threads[tid] = ([s[0] for s in segs], segs)
        self.launches: Dict[object, Tuple[float, object]] = {}
        self.syncs: List[Tuple[float, float, str, object]] = []
        for e in events:
            if e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = (float(e["ts"]), e.get("tid"))
                if sync_call(e["name"]):
                    self.syncs.append((float(e["ts"]), float(e["dur"]), e["name"], e.get("tid")))
        self.device = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                               (e.get("args") or {}).get("correlation"), e["name"])
                              for e in events if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda d: (d[0], d[1]))
        self._events = events
        self._owner_cache: Dict[object, Optional[int]] = {}

    @classmethod
    def load(cls, path) -> "Spans":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @classmethod
    def of(cls, ctx) -> Optional["Spans"]:
        """The spans of a traced run's trace (``ctx``: the runner's
        ``Context``); None without a trace, without device operations (a
        CPU run) or without ``ttr.*`` spans. The drivers write the trace to
        the run's temporary directory as ``bench_trace_<pid>.json``, which
        the runner removes only after every metric is read."""
        if ctx.trace is None or not ctx.trace.device:
            return None
        if not hasattr(ctx, "program_spans"):  # read once for all the run's metrics
            tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
            path = getattr(ctx, "trace_path", None) or Path(tmp) / f"bench_trace_{os.getpid()}.json"
            spans = cls.load(path) if os.path.exists(path) else None
            ctx.program_spans = spans if spans is not None and spans.spans else None
        return ctx.program_spans

    # -- attribution ------------------------------------------------------

    def _own(self, tid, t: float) -> Optional[int]:
        starts, segs = self._threads[tid]
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and segs[j][0] <= t <= segs[j][1]:
            return segs[j][2]
        return None

    def owner(self, t: float, tid) -> Optional[int]:
        """The index of the innermost span that holds time ``t`` of thread
        ``tid`` (see the module's docstring), or None."""
        if tid in self._threads:
            return self._own(tid, t)
        best = None
        for other in self._threads:
            i = self._own(other, t)
            if i is not None and (best is None or self._length(i) < self._length(best)):
                best = i
        return best

    def _length(self, i: int) -> float:
        return self.spans[i][1] - self.spans[i][0]

    def chain(self, i: Optional[int]) -> List[str]:
        """The names of span ``i`` and of the spans it is nested in,
        innermost first."""
        names = []
        while i is not None:
            names.append(self.spans[i][2])
            i = self.parent.get(i)
        return names

    def launch_owner(self, corr) -> Optional[int]:
        if corr not in self.launches:
            return None
        if corr not in self._owner_cache:
            self._owner_cache[corr] = self.owner(*self.launches[corr])
        return self._owner_cache[corr]

    # -- readings ---------------------------------------------------------

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[2] == name)

    def wall_us(self, name: str) -> float:
        return sum(b - a for a, b, n, _ in self.spans if n == name)

    def _launched_in(self, name: str):
        return [(start, end) for start, end, corr, _ in self.device
                if name in self.chain(self.launch_owner(corr))]

    def device_us(self, name: str) -> float:
        """Device time of the operations launched in a ``name`` span or in
        a span nested in one."""
        return sum(end - start for start, end in self._launched_in(name))

    def launches_in(self, name: str) -> int:
        """How many device operations a ``name`` span (or one nested in
        it) launched."""
        return len(self._launched_in(name))

    def device_by_span(self) -> Dict[str, float]:
        """Device time by the innermost span that launched it (``"none"``:
        no span, ``"no launch"``: no runtime call with its correlation)."""
        out: Dict[str, float] = {}
        for start, end, corr, _ in self.device:
            if corr not in self.launches:
                key = "no launch"
            else:
                i = self.launch_owner(corr)
                key = "none" if i is None else self.spans[i][2]
            out[key] = out.get(key, 0.0) + (end - start)
        return out

    def syncs_in(self, name: str) -> List[Tuple[float, float, str, object]]:
        """The synchronizing calls made in a ``name`` span or in a span
        nested in one."""
        return [s for s in self.syncs if name in self.chain(self.owner(s[0], s[3]))]

    def launched_share(self) -> Optional[float]:
        """The share of device time whose launching call the trace holds."""
        total = sum(end - start for start, end, _, _ in self.device)
        if total <= 0:
            return None
        found = sum(end - start for start, end, corr, _ in self.device if corr in self.launches)
        return found / total

    def attributed_share(self) -> Optional[float]:
        """The share of device time launched in some ``ttr.*`` span."""
        total = sum(end - start for start, end, _, _ in self.device)
        if total <= 0:
            return None
        return sum(end - start for start, end, corr, _ in self.device
                   if self.launch_owner(corr) is not None) / total

    def launch_lags_us(self) -> List[float]:
        """Each kernel's start less the start of the call that launched it."""
        return [start - self.launches[corr][0] for start, _, corr, _ in self.device
                if corr in self.launches]

    def busy_us(self) -> float:
        """The union of the device operations' intervals."""
        busy, reach = 0.0, float("-inf")
        for start, end, _, _ in self.device:
            if end > reach:
                busy += end - max(start, reach)
                reach = end
        return busy

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest gaps between the merged device intervals, in
        ms, each named by the innermost span open where it began (on the
        thread with the innermost one)."""
        gaps, reach = [], None
        for start, end, _, _ in self.device:
            if reach is not None and start > reach:
                gaps.append((start - reach, reach))
            reach = end if reach is None else max(reach, end)
        gaps.sort(reverse=True)
        out = []
        for g, t in gaps[:n]:
            i = self.owner(t, None)
            out.append(("none" if i is None else self.spans[i][2], g / 1e3))
        return out

    def sync_sites(self) -> Dict[str, Tuple[int, float]]:
        """(count, ms) of the synchronizing calls by innermost span and
        innermost operator around the call on its thread."""
        ops: Dict[object, list] = {}
        for e in self._events:
            if e.get("cat") == "cpu_op":
                ops.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        for v in ops.values():
            v.sort()
        out: Dict[str, Tuple[int, float]] = {}
        for t, dur, name, tid in self.syncs:
            i = self.owner(t, tid)
            own = ops.get(tid, [])
            j = bisect.bisect_right(own, (t, float("inf"), "")) - 1
            op = "no operator"
            while j >= 0:
                if own[j][0] <= t <= own[j][1]:
                    op = own[j][2]
                    break
                j -= 1
            key = f"{'none' if i is None else self.spans[i][2]} / {op} / {name}"
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + 1, ms + dur / 1e3)
        return out


def per_step(ctx, read) -> Optional[float]:
    """``read(spans, steps)`` over the traced run's ``ttr.train.step``
    spans; None without them."""
    spans = Spans.of(ctx)
    steps = spans.count("ttr.train.step") if spans is not None else 0
    return read(spans, steps) if steps else None


def per_batch(ctx, read) -> Optional[float]:
    """``read(spans, batches)`` over the traced run's batches; None without
    ``ttr.*`` spans or batches."""
    spans = Spans.of(ctx)
    batches = int(getattr(ctx, "traced_batches", 0) or 0)
    return read(spans, batches) if spans is not None and batches else None


def step_sync_ms(spans: Spans, steps: int) -> float:
    return sum(s[1] for s in spans.syncs_in("ttr.train.step")) / steps / 1e3


def breakdown(spans: Spans) -> dict:
    """What ``python -m benchmarks.harness.spans`` prints."""
    steps = spans.count("ttr.train.step")
    names = sorted({s[2] for s in spans.spans})
    return {
        "spans": {n: {"count": spans.count(n), "wall_ms": spans.wall_us(n) / 1e3,
                      "device_ms": spans.device_us(n) / 1e3,
                      "device_ops": spans.launches_in(n)} for n in names},
        "device_ms_by_innermost_span": {k: v / 1e3 for k, v in
                                         sorted(spans.device_by_span().items(),
                                                key=lambda kv: -kv[1])},
        "busy_ms": spans.busy_us() / 1e3,
        "steps": steps,
        "launched_share": spans.launched_share(),
        "attributed_share": spans.attributed_share(),
        "sync_sites": {k: list(v) for k, v in spans.sync_sites().items()},
        "idle_gaps_ms": spans.idle_gaps(10),
    }


if __name__ == "__main__":
    print(json.dumps(breakdown(Spans.load(sys.argv[1])), indent=1))
