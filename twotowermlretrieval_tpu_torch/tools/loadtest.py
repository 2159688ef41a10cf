#!/usr/bin/env python3
"""Serving latency load test: concurrent POST /search against a running
server, reporting p50/p90/p99 and throughput.

BASELINE's serving metric is "p50 top-50 query latency"; the reference
only ever printed per-request wall time server-side
(ref: frontend/main.py:113-114, 200-201). This drives the real HTTP
surface (the same contract the UI uses) from N client threads and
reports the client-observed distribution plus the server-reported
``took_ms`` (their difference = HTTP + queueing overhead).

Usage:
    ttr-loadtest http://127.0.0.1:8888 --requests 200 --concurrency 8 \
        --alpha 0.7 --queries-file queries.txt
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request


def percentile(sorted_vals, p):
    if not sorted_vals:
        return float("nan")
    idx = min(int(round(p / 100 * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[idx]


def run_load(
    url: str,
    queries,
    num_requests: int,
    concurrency: int,
    alpha: float,
    timeout_s: float = 30.0,
    indices=None,
    keep_alive: bool = False,
):
    """Fire ``num_requests`` searches from ``concurrency`` threads.
    ``indices`` (optional) maps request number -> query index, for skewed
    workloads; default is round-robin over ``queries``. ``keep_alive``
    reuses ONE HTTP/1.1 connection per worker (the UI's real pattern —
    urllib opens a fresh TCP connection per request, which taxes every
    sample with a handshake and never exercises the server's persistent-
    connection path); a worker reconnects once if the server closed its
    idle connection between requests.
    Returns (client_latencies_ms, server_took_ms, errors, wall_seconds)."""
    import http.client
    import urllib.parse

    lock = threading.Lock()
    latencies, server_ms, errors = [], [], []
    counter = {"next": 0}
    parsed = urllib.parse.urlsplit(url if "//" in url else "//" + url)

    def worker():
        conn = None
        try:
            while True:
                with lock:
                    i = counter["next"]
                    if i >= num_requests:
                        return
                    counter["next"] = i + 1
                qi = indices[i] if indices is not None else i % len(queries)
                body = json.dumps(
                    {"query": queries[qi], "alpha": alpha}
                ).encode()
                t0 = time.time()
                try:
                    if keep_alive:
                        payload = None
                        for attempt in (0, 1):  # one reconnect on a stale conn
                            if conn is None:
                                conn = http.client.HTTPConnection(
                                    parsed.hostname, parsed.port, timeout=timeout_s
                                )
                            try:
                                conn.request(
                                    "POST", "/search", body=body,
                                    headers={"Content-Type": "application/json"},
                                )
                                resp = conn.getresponse()
                                payload = json.loads(resp.read())
                                if resp.getheader("Connection") == "close":
                                    conn.close()
                                    conn = None
                                break
                            except (http.client.HTTPException, OSError):
                                conn.close()
                                conn = None
                                if attempt:
                                    raise
                        if payload is None:
                            continue
                    else:
                        req = urllib.request.Request(
                            url.rstrip("/") + "/search", data=body,
                            headers={"Content-Type": "application/json"},
                            method="POST",
                        )
                        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                            payload = json.loads(resp.read())
                    ms = (time.time() - t0) * 1000
                    with lock:
                        latencies.append(ms)
                        if "took_ms" in payload:
                            server_ms.append(float(payload["took_ms"]))
                except Exception as e:  # noqa: BLE001 — a load test records failures
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
        finally:
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t_start = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, server_ms, errors, time.time() - t_start


def summarize(latencies, server_ms, errors, wall, concurrency):
    lat = sorted(latencies)
    out = {
        "requests": len(lat),
        "errors": len(errors),
        "concurrency": concurrency,
        "throughput_rps": round(len(lat) / max(wall, 1e-9), 1),
        "client_ms": {
            "p50": round(percentile(lat, 50), 2),
            "p90": round(percentile(lat, 90), 2),
            "p99": round(percentile(lat, 99), 2),
            "mean": round(sum(lat) / max(len(lat), 1), 2),
        },
    }
    if server_ms:
        srv = sorted(server_ms)
        out["server_took_ms"] = {
            "p50": round(percentile(srv, 50), 2),
            "p99": round(percentile(srv, 99), 2),
        }
    return out


def main():
    parser = argparse.ArgumentParser(description="Search-serving load test")
    parser.add_argument("url", help="server base URL, e.g. http://127.0.0.1:8888")
    parser.add_argument("--requests", "-n", type=int, default=200)
    parser.add_argument("--concurrency", "-c", type=int, default=8)
    parser.add_argument("--alpha", type=float, default=0.7)
    parser.add_argument("--queries-file", default=None,
                        help="one query per line; default: a small synthetic set")
    parser.add_argument("--warmup", type=int, default=5,
                        help="untimed warmup requests (compile the search path)")
    parser.add_argument("--zipf", type=float, default=0.0,
                        help="draw queries from a Zipf(s) distribution "
                             "instead of round-robin — a realistic repeat-"
                             "heavy workload for measuring --cache-size "
                             "(try 1.1); 0 = round-robin")
    parser.add_argument("--keep-alive", action="store_true",
                        help="reuse one HTTP/1.1 connection per worker "
                             "(the UI's real pattern) instead of a fresh "
                             "TCP connection per request")
    args = parser.parse_args()

    if args.queries_file:
        with open(args.queries_file) as f:
            queries = [ln.strip() for ln in f if ln.strip()]
    else:
        queries = [f"topic {i} example query terms" for i in range(16)]
    if not queries:
        raise SystemExit("no queries to send")

    indices = None
    if args.zipf > 0:
        import random

        rng = random.Random(0)
        weights = [1.0 / (r + 1) ** args.zipf for r in range(len(queries))]
        indices = rng.choices(range(len(queries)), weights=weights,
                              k=args.requests)
    if args.warmup:
        run_load(args.url, queries, args.warmup, 1, args.alpha,
                 keep_alive=args.keep_alive)
    latencies, server_ms, errors, wall = run_load(
        args.url, queries, args.requests, args.concurrency, args.alpha,
        indices=indices, keep_alive=args.keep_alive,
    )
    summary = summarize(latencies, server_ms, errors, wall, args.concurrency)
    print(json.dumps(summary, indent=2))
    if errors:
        print(f"first error: {errors[0]}")


if __name__ == "__main__":
    main()
