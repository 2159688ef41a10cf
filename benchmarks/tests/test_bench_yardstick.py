"""The frozen yardstick against hand counts and against the port's own
functions today, so that a later drift in the program is seen, not
followed."""

import json

import pytest

from benchmarks.harness import yardstick as ys
from benchmarks.harness.trace import Trace


def test_rnn_fwd_bound_by_hand():
    # T=2, B=1, H=1, D=1, GRU, bf16 operands and history
    nbytes, flops = ys.rnn_fwd_bound(2, 1, 1, 1, 3, 2, 2)
    xp, mask, w, b, outs, hfin = 2 * 3 * 2, 2 * 4, 3 * 2, 3 * 4, 2 * 2, 4
    assert nbytes == xp + mask + w + b + outs + hfin
    assert flops == 2 * 2 * 1 * 1 * 3 * 1


def test_rnn_bwd_bound_by_hand():
    nbytes, flops = ys.rnn_bwd_bound(2, 1, 1, 1, 3, 2, 2)
    stream = 2 * 3 * 2
    assert nbytes == stream + 2 * 4 + 2 * 2 * 2 + 3 * 2 + 3 * 4 + 4 + stream + 3 * 4 + 3 * 4
    assert flops == 2 * 3 * 2 * 1 * 1 * 3  # recompute, chain and weight-gradient products


def test_attention_bound_by_hand():
    R, T, hd = 2, 4, 8
    one = 2 * R * T * T * hd
    assert ys.attention_bound(R, T, hd, 4)[1] == 2 * one
    assert ys.attention_bound(R, T, hd, 4, backward=True)[1] == 5 * one
    assert ys.attention_bound(R, T, hd, 2)[0] == 3 * R * T * hd * 2 + R * T * 4 + R * T * hd * 4


def test_segmax_bound_by_hand():
    assert ys.segmax_bound(2, 4, 256, 2) == (256 * 4 * 2 + 2 * 4 * 2 + 2 * 2 * 4, 2 * 2 * 4 * 256)


def test_least_seconds_takes_the_larger_side():
    assert ys.least_seconds(ys.PEAK_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert ys.least_seconds(0, ys.PEAK_BF16_FLOPS * 2) == pytest.approx(2.0)


def test_train_step_flops_by_hand():
    gru = {"EMBED_DIM": 3, "HIDDEN_DIM": 2, "NUM_LAYERS": 2, "RNN_TYPE": "GRU",
           "BIDIRECTIONAL": True}
    B, Tq, Td = 4, 5, 7

    def tower(T):
        l0 = 2 * 2 * T * B * (3 + 2) * 3 * 2  # two directions, input + recurrent
        l1 = 2 * 2 * T * B * (4 + 2) * 3 * 2
        return l0 + l1 + 2 * B * 4 * 2  # projection [2H -> H]

    assert ys.train_step_flops(gru, B, Tq, Td) == 3 * (tower(Tq) + tower(Td) + 2 * B * B * 2)
    tf = {"TOWER_TYPE": "transformer", "EMBED_DIM": 3, "HIDDEN_DIM": 4, "NUM_LAYERS": 1,
          "FFN_DIM": 8}

    def block(T):
        return (2 * B * T * 4 * 12 + 2 * 2 * B * T * T * 4 + 2 * B * T * 16
                + 2 * 2 * B * T * 4 * 8)

    expect = 3 * (2 * B * Tq * 12 + block(Tq) + 2 * B * Td * 12 + block(Td) + 2 * B * B * 4)
    assert ys.train_step_flops(tf, B, Tq, Td) == expect


SHAPES = [(32, 1024, 256, 2, 3, 2, 2), (128, 64, 256, 2, 3, 2, 4), (7, 16, 1024, 1, 4, 4, 4),
          (128, 1024, 256, 2, 1, 2, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_recurrent_bounds_agree_with_the_port(shape):
    from twotowermlretrieval_tpu_torch.ops import rnn_scan

    assert ys.rnn_fwd_bound(*shape) == rnn_scan.rnn_fwd_bound(*shape)
    for split in (False, True):
        assert ys.rnn_bwd_bound(*shape, split=split) == rnn_scan.rnn_bwd_bound(*shape, split=split)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("backward", [False, True])
def test_attention_bound_agrees_with_the_port(cdt, in_bytes, backward):
    from twotowermlretrieval_tpu_torch.ops import attention

    for R, T, hd in ((4096, 32, 32), (4096, 128, 32), (64, 512, 64)):
        assert ys.attention_bound(R, T, hd, in_bytes, backward, cdt) == \
            attention.attention_bound(R, T, hd, in_bytes, backward, cdt)


def test_segmax_bound_agrees_with_the_port():
    from twotowermlretrieval_tpu_torch.ops import topk

    for args in ((32, 256, 8841856, 2), (1, 16, 4096, 4)):
        assert ys.segmax_bound(*args) == topk.segmax_bound(*args)
    assert ys.SEG == topk._SEG


def _synthetic_trace(path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "bench.dispatch", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.sync", "ts": 60, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "rnn_fwd_kernel<1>", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 62, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "rnn_fwd_kernel<1>", "ts": 70, "dur": 20},
        {"ph": "i", "name": "instant", "ts": 200},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_arithmetic_agrees_with_the_port(tmp_path):
    from twotowermlretrieval_tpu_torch.utils.profiling import trace_summary

    path = _synthetic_trace(tmp_path / "t.json")
    tr, port = Trace.load(path), trace_summary(path, top=10, gaps=10)
    assert tr.busy_us / 1e3 == pytest.approx(port["busy_ms"])
    assert tr.window_us / 1e3 == pytest.approx(port["span_ms"])
    assert [g for _, g in tr.idle_gaps()] == pytest.approx([g / 1e3 for g in port["idle_gaps_ms"]])
    assert [(n, s * 1e3) for n, s in tr.top_ops()] == \
        [(o["name"], pytest.approx(o["total_ms"])) for o in port["device_ops"]]


def test_idle_gaps_are_named_by_the_innermost_bench_span(tmp_path):
    tr = Trace.load(_synthetic_trace(tmp_path / "t.json"))
    assert tr.idle_gaps() == [("bench.dispatch", pytest.approx(27e-6)),
                              ("bench.sync", pytest.approx(5e-6))]
    assert tr.device_time_us(r"\brnn_fwd_") == (40.0, 2)
