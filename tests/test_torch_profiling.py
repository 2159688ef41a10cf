"""The port's tracing (``twotowermlretrieval_tpu_torch/utils/profiling.py``)
keeps the JAX package's semantics (``utils/profiling.py``), on the CPU: a
trace written by ``trace``, TraceWindow's lazy start, exact-once stop,
finalize on ``close()`` and disable-on-error, the training driver's
``--profile_dir`` window and the engine's window over live searches; and
``trace_summary`` on a trace with device events."""

import json
import threading

import pytest
import torch

from twotowermlretrieval_tpu_torch.utils import profiling as P


def test_trace_writes_a_file(tmp_path):
    with P.trace(str(tmp_path / "trace")):
        with P.annotate("test_region"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    files = P.trace_files(tmp_path / "trace")
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "test_region" in names and "aten::mm" in names


class _FakeProfiler:
    """Counts starts and stops; optionally fails to start."""

    log = []

    def __init__(self, log_dir, fail=False):
        self.log_dir, self.fail = log_dir, fail

    def start(self):
        if self.fail:
            raise RuntimeError("CUPTI unavailable")
        self.log.append(("start", self.log_dir))

    def stop(self):
        self.log.append(("stop", self.log_dir))


def test_trace_window_starts_lazily_and_stops_exactly_once(monkeypatch, capsys):
    _FakeProfiler.log = []
    monkeypatch.setattr(P, "_profiler", _FakeProfiler)
    win = P.TraceWindow("d", 3, what="searches")
    assert _FakeProfiler.log == [] and not win.done  # nothing until the first event
    for _ in range(5):
        with win.event():
            pass
    assert _FakeProfiler.log == [("start", "d"), ("stop", "d")] and win.done
    win.close()  # after the stop: a no-op
    assert _FakeProfiler.log == [("start", "d"), ("stop", "d")]
    out = capsys.readouterr().out
    assert "tracing the next 3 searches to d" in out and "trace written to d" in out
    with pytest.raises(ValueError):
        P.TraceWindow("d", 0)


def test_trace_window_close_finalizes_an_unfilled_window(monkeypatch):
    _FakeProfiler.log = []
    monkeypatch.setattr(P, "_profiler", _FakeProfiler)
    unused = P.TraceWindow("never", 4)
    unused.close()  # never started: nothing to finalize
    win = P.TraceWindow("half", 4)
    for _ in range(2):
        with win.event():
            pass
    assert _FakeProfiler.log == [("start", "half")] and not win.done
    win.close()
    win.close()
    assert _FakeProfiler.log == [("start", "half"), ("stop", "half")] and win.done


def test_trace_window_counts_events_from_threads_once(monkeypatch):
    """Many threads, one window: one start, one stop after n events."""
    _FakeProfiler.log = []
    monkeypatch.setattr(P, "_profiler", _FakeProfiler)
    win = P.TraceWindow("t", 10)
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait(timeout=10)
        for _ in range(5):
            with win.event():
                pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert _FakeProfiler.log == [("start", "t"), ("stop", "t")]


def test_a_failing_profiler_disables_the_window_with_one_line(monkeypatch, capsys):
    monkeypatch.setattr(P, "_profiler", lambda d: _FakeProfiler(d, fail=True))
    win = P.TraceWindow("x", 2)
    ran = 0
    for _ in range(4):
        with win.event():
            ran += 1  # the workload runs on
    win.close()
    assert ran == 4 and win.done
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("profiler:")]
    assert len(lines) == 1 and "disabled" in lines[0] and "CUPTI unavailable" in lines[0]


def test_trace_summary_reads_device_events(tmp_path):
    """Busy share: the union of device intervals over the trace's span;
    idle gaps between them, longest first; device operations by total."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "segmax_mma_kernel", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "rnn_fwd_kernel", "ts": 25, "dur": 10},  # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "segmax_mma_kernel", "ts": 90, "dur": 10},
        {"ph": "i", "name": "instant", "ts": 500},
    ]
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = P.trace_summary(path, top=2, gaps=2)
    assert s["span_ms"] == pytest.approx(0.1) and s["busy_ms"] == pytest.approx(0.04)
    assert s["busy_share"] == pytest.approx(0.4) and s["device_events"] == 4
    assert s["idle_gaps_ms"] == pytest.approx([0.025, 0.025])
    assert [(o["name"], o["calls"]) for o in s["device_ops"]] == [
        ("segmax_mma_kernel", 2), ("rnn_fwd_kernel", 1)]
    assert s["device_ops"][0]["total_ms"] == pytest.approx(0.03)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus, synthetic_config

    out = tmp_path_factory.mktemp("profile_corpus")
    generate_corpus(out, num_queries=120, num_topics=12, words_per_topic=20, embed_dim=16)
    return synthetic_config(out, hidden_dim=16, num_layers=1, bidirectional=True,
                            length_buckets=[16, 24], steps_per_dispatch=2, log_every_steps=100)


def test_train_profile_dir_traces_a_filled_window(corpus, tmp_path, capsys):
    """``train(..., profile_dir=...)`` opens the window at step 10, after
    the first group, and closes it 10 steps later, before the run ends (24
    steps): one trace with the steps' operations."""
    from twotowermlretrieval_tpu_torch.train.loop import train

    res = train(corpus.replace(epochs=3), output_root=tmp_path / "out", device="cpu",
                profile_dir=tmp_path / "prof")
    assert res["steps"] == 24
    files = P.trace_files(tmp_path / "prof")
    assert len(files) == 1
    assert P.trace_summary(files[0])["span_ms"] > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names


def test_engine_traces_live_searches_not_cache_hits(corpus, tmp_path, monkeypatch):
    """An engine with ``profile_dir`` starts its window at the first live
    search (not at boot), counts only live searches (a cache hit does no
    device work), stops after ``profile_requests`` of them, and ``close()``
    finalizes an unfilled window."""
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.loop import train

    art = train(corpus.replace(epochs=1), output_root=tmp_path / "out", device="cpu")
    _FakeProfiler.log = []
    monkeypatch.setattr(P, "_profiler", _FakeProfiler)
    engine = SearchEngine(art["artifacts_dir"], device="cpu", cache_size=8,
                          profile_dir=str(tmp_path / "serve"), profile_requests=3)
    assert _FakeProfiler.log == []
    engine.search("t1w3 t1w5", alpha=0.5)
    assert _FakeProfiler.log == [("start", str(tmp_path / "serve"))]
    for _ in range(3):
        engine.search("t1w3 t1w5", alpha=0.5)  # cache hits
    assert len(_FakeProfiler.log) == 1
    engine.search("t2w1", alpha=0.5)
    engine.search("t3w2", alpha=0.0)
    assert _FakeProfiler.log[-1] == ("stop", str(tmp_path / "serve"))
    engine.search("t4w4", alpha=0.5)
    engine.close()
    assert len(_FakeProfiler.log) == 2

    monkeypatch.undo()  # the real profiler: close() writes an unfilled window
    engine = SearchEngine(art["artifacts_dir"], device="cpu",
                          profile_dir=str(tmp_path / "real"), profile_requests=5)
    engine.search("t1w3 t1w5", alpha=0.5)
    assert P.trace_files(tmp_path / "real") == []
    engine.close()
    assert len(P.trace_files(tmp_path / "real")) == 1
