"""The port's spans (``utils/profiling.py`` ``annotate``, named ``ttr.*``)
and the benchmark's reading of them (``benchmarks/harness/spans.py``), on
the CPU: the span costs nothing while no profiler records; under one it
records, nested, on the calling thread, on the threads of a window that
profiles every thread and inside ``torch.autograd.grad``; a train step and
the engine's encode-and-search open their spans in order; and the
reading's arithmetic on hand-written trace events."""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from twotowermlretrieval_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks.harness.spans import Spans, per_batch, per_step, sync_call  # noqa: E402


def _spans(events, prefix="ttr."):
    """(name, start, end, tid) of the trace's host spans named ``prefix*``,
    by start."""
    out = [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
           if e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix)
           and not str(e.get("cat", "")).startswith("gpu_")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _trace_events(prof, tmp_path, name="t.json"):
    path = tmp_path / name
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# -- the span helper ----------------------------------------------------------


def test_span_calls_nothing_without_a_profiler(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    first, second = P.annotate("ttr.a"), P.annotate("ttr.b")
    assert first is second  # one shared no-op context
    with first:
        with second:
            pass


def test_span_records_nested_on_the_calling_thread(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.annotate("ttr.outer"):
            with P.annotate("ttr.inner"):
                torch.ones(8) + 1
    assert P.annotate("ttr.after") is P.annotate("ttr.after2")  # off again
    spans = _spans(_trace_events(prof, tmp_path))
    assert [s[0] for s in spans] == ["ttr.outer", "ttr.inner"]
    assert _inside(spans[1], spans[0])


def test_span_records_on_a_request_thread_under_a_trace_window(tmp_path):
    """``TraceWindow`` starts its session on a thread of its own and
    profiles every thread: a span opened on another thread records."""
    win = P.TraceWindow(str(tmp_path / "win"), 1)

    def request():
        with win.event():
            with P.annotate("ttr.request"):
                with P.annotate("ttr.request.inner"):
                    torch.ones(8) * 2

    t = threading.Thread(target=request, name="request-thread")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and win.done
    (path,) = P.trace_files(tmp_path / "win")
    spans = _spans(json.loads(path.read_text())["traceEvents"])
    assert [s[0] for s in spans] == ["ttr.request", "ttr.request.inner"]
    assert _inside(spans[1], spans[0])


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        with P.annotate("ttr.in_backward"):
            return g * 2


def test_span_records_inside_autograd_grad(tmp_path):
    x = torch.ones(4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.annotate("ttr.grad"):
            (g,) = torch.autograd.grad(_Double.apply(x).sum(), [x])
    assert torch.equal(g, torch.full((4,), 2.0))
    spans = _spans(_trace_events(prof, tmp_path))
    assert [s[0] for s in spans] == ["ttr.grad", "ttr.in_backward"]
    assert _inside(spans[1], spans[0])


# -- the program's spans --------------------------------------------------------


def _tiny_step():
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.batching import Batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_train_step

    cfg = Config(vocab_size=40, embed_dim=8, hidden_dim=8, rnn_type="GRU", num_layers=1,
                 bidirectional=True, dropout=0.0, batch_size=8, max_query_len=4,
                 max_doc_len=6, compute_dtype="float32", freeze_embeddings=True)
    spec = TwoTowerSpec.from_config(cfg)
    table = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    state = create_train_state(torch.Generator().manual_seed(1),
                               init_two_tower(torch.Generator().manual_seed(0), spec, table), cfg)
    rng = np.random.default_rng(1)

    def tok(L):
        return (torch.from_numpy(rng.integers(1, 40, (8, L)).astype(np.int32)),
                torch.from_numpy(rng.integers(1, L + 1, (8,)).astype(np.int32)))

    batch = Batch(*tok(4), *tok(6), *tok(6), torch.ones(8))
    return make_train_step(spec, cfg), state, batch


def test_a_train_step_opens_forward_backward_optimizer_in_order(tmp_path):
    step, state, batch = _tiny_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    spans = _spans(_trace_events(prof, tmp_path))
    steps = [s for s in spans if s[0] == "ttr.train.step"]
    assert len(steps) == 1
    parts = [s for s in spans if s[0] in ("ttr.train.forward", "ttr.train.backward",
                                          "ttr.train.optimizer")]
    assert [s[0] for s in parts] == ["ttr.train.forward", "ttr.train.backward",
                                     "ttr.train.optimizer"]
    assert all(_inside(s, steps[0]) for s in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # one after another
    towers = [s for s in spans if s[0].startswith("ttr.tower.")]
    assert [s[0] for s in towers] == ["ttr.tower.query", "ttr.tower.doc"]
    assert all(_inside(s, parts[0]) for s in towers)


def test_packed_groups_opens_one_pack_span_a_group(tmp_path):
    from twotowermlretrieval_tpu_torch.data.batching import Batch
    from twotowermlretrieval_tpu_torch.train.loop import packed_groups

    rng = np.random.default_rng(0)

    def batch(L):
        t = rng.integers(1, 9, (4, L)).astype(np.int32)
        n = np.full(4, L, np.int32)
        return Batch(t[:, :3], n, t, n, t, n, np.ones(4, np.float32))

    stream = [batch(6), batch(8), batch(6), batch(8), batch(6)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        groups = [(s.shape, n) for s, n in packed_groups(iter(stream), 2)]
    assert groups == [((2, 4, 3 + 12 + 4), 8), ((2, 4, 3 + 16 + 4), 8), ((1, 4, 3 + 12 + 4), 4)]
    spans = _spans(_trace_events(prof, tmp_path))
    # a span a group, and the one that finds the stream's end before the last
    assert [s[0] for s in spans] == ["ttr.data.pack"] * 4


def test_encode_and_search_open_the_tower_then_the_scan_around_phase2(tmp_path):
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.serve.engine import _fused_encode_search
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    cfg = Config(vocab_size=40, embed_dim=8, hidden_dim=16, rnn_type="GRU", num_layers=1,
                 bidirectional=False, max_query_len=4, compute_dtype="float32")
    spec = TwoTowerSpec.from_config(cfg)
    params = init_two_tower(torch.Generator().manual_seed(0), spec,
                            np.ones((40, 8), np.float32) * 0.1)
    rng = np.random.default_rng(0)
    index = RetrievalIndex(rng.standard_normal((600, 16)).astype(np.float32),
                           storage_dtype="float32", device="cpu", use_kernel=True)
    tokens = torch.from_numpy(rng.integers(1, 40, (8, 4)).astype(np.int32))
    lengths = torch.full((8,), 4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        buf = _fused_encode_search(params, tokens, lengths, spec, k=5, index=index)
    assert buf.shape == (8, 10)
    spans = _spans(_trace_events(prof, tmp_path))
    assert [s[0] for s in spans] == ["ttr.tower.query", "ttr.search.scan", "ttr.search.phase2"]
    assert spans[0][2] <= spans[1][1] and _inside(spans[2], spans[1])


# -- the benchmark's reading ------------------------------------------------------


def _x(name, ts, dur, cat, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid,
            "args": args}


def _window():
    """Two steps on thread 1; the backward's launches on thread 2 (the
    autograd engine's), which opens no span; a sync in each step, one of
    them on thread 2; a launch and a kernel outside every span."""
    ev = []
    for s, t0 in enumerate((0, 1000)):
        ev += [_x("ttr.train.step", t0, 900, "user_annotation"),
               _x("ttr.train.forward", t0 + 10, 300, "user_annotation"),
               _x("ttr.tower.query", t0 + 20, 100, "user_annotation"),
               _x("ttr.train.backward", t0 + 400, 300, "user_annotation"),
               _x("ttr.train.optimizer", t0 + 750, 100, "user_annotation"),
               # the device's own copy of a span: not a host span
               _x("ttr.train.step", t0 + 5, 50, "gpu_user_annotation", tid=7)]
        c = 100 * s
        ev += [_x("cudaLaunchKernel", t0 + 30, 5, "cuda_runtime", correlation=c + 1),
               _x("cudaLaunchKernel", t0 + 200, 5, "cuda_runtime", correlation=c + 2),
               _x("cudaLaunchKernel", t0 + 450, 5, "cuda_runtime", tid=2, correlation=c + 3),
               _x("cudaMemcpyAsync", t0 + 760, 5, "cuda_runtime", correlation=c + 4),
               _x("cudaStreamSynchronize", t0 + 770, 40, "cuda_runtime", correlation=c + 5),
               _x("cuStreamSynchronize_ptsz", t0 + 500, 10, "cuda_driver", tid=2,
                  correlation=c + 6)]
        ev += [_x("k_query", t0 + 40, 50, "kernel", tid=7, correlation=c + 1),
               _x("k_loss", t0 + 210, 20, "kernel", tid=7, correlation=c + 2),
               _x("k_bwd", t0 + 460, 200, "kernel", tid=7, correlation=c + 3),
               _x("Memcpy HtoD", t0 + 765, 4, "gpu_memcpy", tid=7, correlation=c + 4)]
    ev += [_x("cudaLaunchKernel", 1950, 5, "cuda_runtime", correlation=999),
           _x("k_outside", 1960, 30, "kernel", tid=7, correlation=999),
           _x("k_orphan", 1995, 5, "kernel", tid=7, correlation=12345)]
    return ev


def test_device_time_goes_to_the_span_that_launched_it():
    sp = Spans(_window())
    assert sp.count("ttr.train.step") == 2  # the gpu_user_annotation copies are not spans
    assert sp.device_us("ttr.tower.query") == 2 * 50
    assert sp.device_us("ttr.train.forward") == 2 * (50 + 20)  # nested spans count
    assert sp.device_us("ttr.train.backward") == 2 * 200  # launched on thread 2
    assert sp.device_us("ttr.train.optimizer") == 2 * 4
    assert sp.device_us("ttr.train.step") == 2 * (70 + 200 + 4)
    assert sp.launches_in("ttr.train.forward") == 4 and sp.launches_in("ttr.train.step") == 8
    by = sp.device_by_span()
    assert by["ttr.tower.query"] == 100 and by["ttr.train.forward"] == 40
    assert by["none"] == 30 and by["no launch"] == 5
    total = 2 * 274 + 30 + 5
    assert sp.launched_share() == pytest.approx((total - 5) / total)
    assert sp.attributed_share() == pytest.approx(2 * 274 / total)
    assert sorted(set(sp.launch_lags_us())) == [5, 10]


def test_innermost_span_is_chosen_and_syncs_on_another_thread_count():
    sp = Spans(_window())
    assert sp.chain(sp.owner(35, 1)) == ["ttr.tower.query", "ttr.train.forward",
                                         "ttr.train.step"]
    assert sp.chain(sp.owner(200, 1)) == ["ttr.train.forward", "ttr.train.step"]
    assert sp.chain(sp.owner(455, 2)) == ["ttr.train.backward", "ttr.train.step"]
    assert sp.owner(1950, 1) is None
    syncs = sp.syncs_in("ttr.train.step")
    assert sorted(s[2] for s in syncs) == ["cuStreamSynchronize_ptsz"] * 2 + \
        ["cudaStreamSynchronize"] * 2
    assert [s[2] for s in sp.syncs_in("ttr.train.backward")] == ["cuStreamSynchronize_ptsz"] * 2
    assert sync_call("cudaMemcpy") and sync_call("cuMemcpyDtoH_v2")
    assert not sync_call("cudaMemcpyAsync") and not sync_call("cudaLaunchKernel")
    sites = sp.sync_sites()
    assert sites["ttr.train.optimizer / no operator / cudaStreamSynchronize"] == \
        (2, pytest.approx(0.08))


def test_the_gaps_are_named_by_the_span_open_where_they_begin():
    gaps = Spans(_window()).idle_gaps(20)
    assert gaps[0] == ("ttr.train.optimizer", pytest.approx(0.271))  # the copy to step 2
    assert {round(g * 1e3): n for n, g in gaps} == {
        271: "ttr.train.optimizer", 230: "ttr.train.forward", 191: "ttr.train.optimizer",
        120: "ttr.tower.query", 105: "ttr.train.backward", 5: "none"}


class _Ctx:
    """What the runner hands a metric's reader: the loaded trace, the
    traced batches; and here the trace's path."""

    def __init__(self, path, traced_batches=0):
        from benchmarks.harness.trace import Trace

        self.trace = Trace.load(path) if path.exists() else None
        self.trace_path, self.traced_batches = path, traced_batches


def test_the_metric_readers_read_the_spans_and_none_without_them(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _window()}))
    ctx = _Ctx(path, traced_batches=4)
    assert per_step(ctx, lambda sp, steps: sp.device_us("ttr.train.backward") / steps) == 200
    assert per_batch(ctx, lambda sp, n: sp.wall_us("ttr.tower.query") / n) == 50
    plain = [e for e in _window() if not e["name"].startswith("ttr.")]
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": plain}))
    assert per_step(_Ctx(bare), lambda sp, steps: 1.0) is None
    assert per_batch(_Ctx(bare, 4), lambda sp, n: 1.0) is None
    assert per_step(_Ctx(tmp_path / "missing.json"), lambda sp, steps: 1.0) is None
    host_only = tmp_path / "host.json"  # a CPU run's trace: spans, no device operation
    host_only.write_text(json.dumps({"traceEvents": [e for e in _window()
                                                     if e["cat"] == "user_annotation"]}))
    assert per_step(_Ctx(host_only), lambda sp, steps: 1.0) is None


def test_the_optimizer_launch_count_reads_what_the_optimizer_spans_launched(tmp_path):
    """``optimizer_launches.train``: the device operations launched inside
    ``ttr.train.optimizer`` a step (the step count's add and the kernel's
    two passes here), not the backward's; None without spans."""
    from benchmarks.harness.runner import load_metric

    ev = []
    for s, t0 in enumerate((0, 1000)):
        c = 100 * s
        ev += [_x("ttr.train.step", t0, 900, "user_annotation"),
               _x("ttr.train.backward", t0 + 100, 300, "user_annotation"),
               _x("ttr.train.optimizer", t0 + 600, 200, "user_annotation"),
               _x("cudaLaunchKernel", t0 + 150, 5, "cuda_runtime", correlation=c + 1),
               _x("k_bwd", t0 + 160, 50, "kernel", tid=7, correlation=c + 1)]
        for j, name in enumerate(("k_count_add", "adam_squares_kernel", "adam_update_kernel")):
            ev += [_x("cudaLaunchKernel", t0 + 610 + 20 * j, 5, "cuda_runtime",
                      correlation=c + 10 + j),
                   _x(name, t0 + 700 + 20 * j, 10, "kernel", tid=7, correlation=c + 10 + j)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    read = load_metric("optimizer_launches.train").read
    assert read(_Ctx(path)) == 3.0
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": [e for e in ev if not e["name"].startswith("ttr.")]}))
    assert read(_Ctx(bare)) is None
