"""A run's last line and the comparison that decides ``correct``, driven
on the CPU at a small size: the harness with the card check skipped, the
program's kernels' plain versions underneath, and the timed path broken in
each way a training cell can break."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks.harness import checks, runner

SMALL = dict(HIDDEN_DIM=16, VOCAB_SIZE=500, EMBED_DIM=8, BATCH_SIZE=16, MAX_QUERY_LEN=8,
             MAX_DOC_LEN=16, LENGTH_BUCKETS=[8, 16], STEPS_PER_DISPATCH=4)
SMALL_TF = dict(NUM_HEADS=2, FFN_DIM=32, NUM_LAYERS=2)


def small_cell(name):
    cell = runner.Cell(name)
    cell.model.update(SMALL)
    if cell.model.get("TOWER_TYPE") == "transformer":
        cell.model.update(SMALL_TF)
    cell.mix = dict(cell.mix, pool_batches=6,
                    query_len=dict(mean=4, sd=2, min=2, max=8),
                    passage_len=dict(mean=9, sd=4, min=2, max=16))
    return cell


def run_small(name, trace=False):
    torch.manual_seed(0)
    cell = small_cell(name)
    res = runner.run_cell(cell, 2 ** 31 + 7, 0.2, trace, "cpu", 0.0, "/nonexistent")
    return cell, res


@pytest.mark.parametrize("name", ["gru-inbatch.train", "transformer-c5.train"])
def test_the_last_line_has_the_contract_keys(name, tmp_path):
    cell, res = run_small(name)
    line = runner.result_line(cell, res, False, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end()}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == set(cell.spec["limits"])
    assert line["attempted"] > 0 and line["failed"] == 0
    json.loads(json.dumps(line))


def test_a_traced_run_reads_its_host_metrics_and_skips_what_it_cannot_see(tmp_path):
    cell = small_cell("gru-inbatch.train")
    res = runner.run_cell(cell, 3, 0.2, True, "cpu", 0.0, str(tmp_path))
    line = runner.result_line(cell, res, True, {"platform": "cpu", "kind": "cpu", "count": 1})
    # a CPU trace has no device operations: the device readers return nothing
    assert set(line["metrics"]) == {"host_dispatch_ms.train", "mfu.train"}
    assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_the_same_seed_makes_the_same_rows_and_weights():
    from benchmarks.harness.traffic import TripletPool
    from benchmarks.harness.weights import make_params

    cell = small_cell("gru-inbatch.train")
    a, b = (TripletPool(cell.mix, cell.model, 2 ** 33 + 5, "cpu") for _ in range(2))
    c = TripletPool(cell.mix, cell.model, 2 ** 33 + 6, "cpu")
    assert np.array_equal(a.pos_tokens, b.pos_tokens) and not np.array_equal(a.pos_tokens,
                                                                             c.pos_tokens)
    assert np.array_equal(a.pos_len, c.pos_len)  # the shapes do not follow the seed
    assert [p[0] for p in a.epoch_plans(3)] == [p[0] for p in c.epoch_plans(3)]
    pa, pb = make_params(cell.model, 9, "cpu"), make_params(cell.model, 9, "cpu")
    assert torch.equal(pa["doc"]["layers"][1]["bwd"]["w_hh"], pb["doc"]["layers"][1]["bwd"]["w_hh"])


def _faulty_step(kind):
    from twotowermlretrieval_tpu_torch.train import train_step as ts

    real = ts.make_train_step

    def make(spec, config, *a, **kw):
        step = real(spec, config, *a, **kw)

        def broken(state, batch):
            if kind == "unchanged":  # the state comes back as it went in
                _, metrics = ts.make_grad_step(spec, config)(state, batch)
                return state, metrics
            half = batch.q_tokens.shape[0] // 2  # half the batch, the mean over the rest
            return step(state, type(batch)(*(f[:half] for f in batch)))

        return broken

    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["gru-inbatch.train", "transformer-c5.train"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    from twotowermlretrieval_tpu_torch.train import train_step as ts

    monkeypatch.setattr(ts, "make_train_step", _faulty_step(fault))
    cell, res = run_small(name)
    assert not checks.verdict(res["numbers"], cell.spec["limits"])
    if fault == "unchanged":
        assert res["numbers"]["update_gap"] == pytest.approx(1.0)


def test_an_altered_loss_is_not_correct():
    cell = small_cell("gru-inbatch.train")
    numbers = {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
    assert checks.verdict(numbers, cell.spec["limits"])
    assert not checks.verdict(dict(numbers, loss_gap=float("nan")), cell.spec["limits"])
    assert not checks.verdict(dict(numbers, grad_gap=1.0), cell.spec["limits"])


def test_without_a_card_the_run_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, str(runner.BENCH_DIR / "run.py"), "--workload",
                        "gru-inbatch.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=runner.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and not r.stdout.strip()


def small_search_cell(monkeypatch):
    from benchmarks.harness import corpus

    monkeypatch.setattr(corpus, "BLOCK_ROWS", 2048)
    cell = runner.Cell("gru-inbatch.search")
    cell.model.update(HIDDEN_DIM=16, VOCAB_SIZE=500, EMBED_DIM=8)
    cell.spec.update(index_rows=5000, warm_batches=1, sample_batches=4)
    cell.mix = dict(cell.mix, pool_batches=4)
    return cell


def test_a_search_run_is_correct_and_its_line_has_the_contract_keys(monkeypatch):
    cell = small_search_cell(monkeypatch)
    res = runner.run_cell(cell, 2 ** 31 + 3, 0.3, False, "cpu", 0.0, "/nonexistent")
    line = runner.result_line(cell, res, False, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert set(line["metrics"]) == {"search_qps", "setup_s"}
    assert line["correct"] and line["attempted"] == res["window"]["queries"] > 0
    assert list(line)[-1] == "checks"


def test_a_traced_search_reads_its_host_metrics_only(monkeypatch, tmp_path):
    cell = small_search_cell(monkeypatch)
    cell.spec.update(trace_batches=2)
    res = runner.run_cell(cell, 2 ** 31 + 4, 0.3, True, "cpu", 0.0, str(tmp_path))
    line = runner.result_line(cell, res, True, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert set(line["metrics"]) == {"batch_p95_ms.search", "mfu.search"}
    assert line["device"]["busy_s"] == 0.0


def _broken_search(kind):
    from twotowermlretrieval_tpu_torch.serve import engine

    real = engine._fused_encode_search

    def broken(params, tokens, lengths, spec, k, index):
        if kind == "half_batch":  # the second half of the rows answered with the first's
            half = tokens.shape[0] // 2
            out = real(params, tokens[:half], lengths[:half], spec, k, index)
            return torch.cat([out, out])
        out = real(params, tokens, lengths, spec, k, index).clone()
        ids = out[:, k:].view(torch.int32)
        ids[0, 0] = (ids[0, 0] + 1) % index.num_docs  # one answer altered
        return out

    return broken


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_a_broken_search_is_not_correct(fault, monkeypatch):
    from twotowermlretrieval_tpu_torch.serve import engine

    cell = small_search_cell(monkeypatch)
    monkeypatch.setattr(engine, "_fused_encode_search", _broken_search(fault))
    res = runner.run_cell(cell, 2 ** 31 + 3, 0.3, False, "cpu", 0.0, "/nonexistent")
    assert not checks.verdict(res["numbers"], cell.spec["limits"])


def test_the_95th_percentile_takes_every_batch_and_a_stall_moves_it():
    from benchmarks.harness.search_driver import p95

    steady = [0.004] * 100
    assert p95(steady) == 0.004
    stalled = steady[:94] + [0.050] * 6  # six stalled batches of a hundred
    assert p95(stalled) == 0.050
    assert p95(steady[:96] + [0.050] * 4) == 0.004
