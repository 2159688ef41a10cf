"""Reading a ``torch.profiler`` Chrome trace of a window.

The arithmetic is a frozen copy of the port's ``utils/profiling.py``
``trace_summary``: the device operations are the events of the Kineto
categories of work on the card, the busy time is the union of their
intervals, the window is the extent of every complete event, and the idle
gaps lie between the merged device intervals. Here each gap is also named
by what the host was doing when it began: the innermost of the
benchmark's own ``bench.*`` spans (``torch.profiler.record_function``)
that covers the gap's start, or ``"no bench span"``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def span(name: str):
    """A host span of the benchmark's own around a call into the program
    (``name`` starts with ``bench.``)."""
    return torch.profiler.record_function(name)


class Trace:
    """The parts of one trace the readers use. Times in microseconds, on
    the trace's clock."""

    def __init__(self, events: Sequence[dict]):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        if not events:
            raise ValueError("the trace has no complete events")
        self.t0 = min(float(e["ts"]) for e in events)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
        self.device: List[Tuple[float, float, str]] = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in DEVICE_CATEGORIES)
        self.spans: List[Tuple[float, float, str]] = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if str(e.get("name", "")).startswith(SPAN_PREFIX) and e.get("cat") not in
            DEVICE_CATEGORIES)
        merged: List[list] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.merged = merged

    @classmethod
    def load(cls, path) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(end - start for start, end in self.merged)

    def device_time_us(self, pattern: str) -> Tuple[float, int]:
        """Total device time and count of the operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [(end - start) for start, end, name in self.device if rx.search(name)]
        return sum(hits), len(hits)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations with the most total time, in seconds."""
        totals: Dict[str, float] = {}
        for start, end, name in self.device:
            totals[name] = totals.get(name, 0.0) + (end - start)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [(name, us / 1e6) for name, us in ops]

    def host_activity(self, t: float) -> str:
        """The innermost bench span covering time ``t``."""
        best: Optional[Tuple[float, str]] = None
        for start, end, name in self.spans:
            if start <= t <= end and (best is None or end - start < best[0]):
                best = (end - start, name)
        return best[1] if best else "no bench span"

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest gaps between device intervals, in seconds,
        each named by the host's activity where it began."""
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(self.merged, self.merged[1:])),
                      reverse=True)[:n]
        return [(self.host_activity(t), g / 1e6) for g, t in gaps]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name cut to ``limit`` characters, on one line."""
    name = " ".join(str(name).split())
    return name if len(name) <= limit else name[: limit - 3] + "..."
