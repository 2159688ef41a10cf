"""Serving observability: a Prometheus-exposition ``/metrics`` surface.

A copy of the JAX package's module, so the port serves the same metrics.

The reference's only serving telemetry is a per-request wall-clock print
(ref: frontend/main.py:113-114, 200-201). A production deployment needs
scrapeable counters instead; this module keeps them in-process with a
lock (the stdlib server is threaded) and renders the standard text
format — no client library required.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

# Upper bounds in seconds; +Inf is implicit in render(). Spans cache hits
# (~10 us) through remote-relay cold compiles (tens of seconds).
_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)


class ServerMetrics:
    """Request counters + latency histogram, Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, int], int] = {}
        self._hist = [0] * (len(_BUCKETS) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, path: str, code: int, seconds: float | None) -> None:
        """Count a response; ``seconds=None`` counts without a latency
        sample (parse-error responses have no measurable start: any stamp
        taken before the request line is read would fold keep-alive idle
        time into the histogram)."""
        with self._lock:
            key = (path, code)
            self._requests[key] = self._requests.get(key, 0) + 1
            if seconds is None:
                return
            for i, ub in enumerate(_BUCKETS):
                if seconds <= ub:
                    self._hist[i] += 1
                    break
            else:
                self._hist[-1] += 1
            self._sum += seconds
            self._count += 1

    def render(self, extra: Dict[str, Tuple[str, float]] | None = None) -> str:
        """``extra`` maps metric name -> (prometheus type, value)."""
        with self._lock:
            requests = dict(self._requests)
            hist = list(self._hist)
            total_sum, total_count = self._sum, self._count
        lines = [
            "# HELP ttr_http_requests_total HTTP requests by path and status code",
            "# TYPE ttr_http_requests_total counter",
        ]
        for (path, code), n in sorted(requests.items()):
            lines.append(
                f'ttr_http_requests_total{{path="{path}",code="{code}"}} {n}'
            )
        lines += [
            "# HELP ttr_http_request_seconds HTTP request latency",
            "# TYPE ttr_http_request_seconds histogram",
        ]
        cum = 0
        for ub, n in zip(_BUCKETS, hist):
            cum += n
            lines.append(f'ttr_http_request_seconds_bucket{{le="{ub}"}} {cum}')
        cum += hist[-1]
        lines.append(f'ttr_http_request_seconds_bucket{{le="+Inf"}} {cum}')
        lines.append(f"ttr_http_request_seconds_sum {total_sum}")
        lines.append(f"ttr_http_request_seconds_count {total_count}")
        for name, (mtype, value) in (extra or {}).items():
            lines += [f"# TYPE {name} {mtype}", f"{name} {value}"]
        return "\n".join(lines) + "\n"
