"""The data-parallel driver on the CPU: four gloo ranks, the program's
data-parallel step, rank 0's first steps against the reference at the
global batch with every rank's dropout masks; and the same run with the
exchange between the ranks left out, which is not correct.

``gru-inbatch.train-dp4`` is not in ``BENCHMARK.json`` (``PERF.md`` §7
says why); its files are, and the entries a later PR would add are these."""

import json
import time
from pathlib import Path

from benchmarks.harness import checks, runner, train_dp_driver

FAULT_SITE = Path(__file__).resolve().parent / "fault_site"
DP4 = {"name": "gru-inbatch.train-dp4", "config": "gru-inbatch-dp",
       "traffic": "msmarco-triplets", "chips": 4}
DP_CONFIG = {"name": "gru-inbatch-dp", "file": "benchmarks/configs/gru-inbatch-dp.json"}


def small_dp_cell():
    bench = json.loads((runner.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(DP4)
    bench["configs"].append(DP_CONFIG)
    cell = runner.Cell(DP4["name"], bench)
    cell.model.update(HIDDEN_DIM=16, VOCAB_SIZE=500, EMBED_DIM=8, BATCH_SIZE=16,
                      MAX_QUERY_LEN=8, MAX_DOC_LEN=16, LENGTH_BUCKETS=[8, 16],
                      STEPS_PER_DISPATCH=4)
    cell.mix = dict(cell.mix, pool_batches=6, query_len=dict(mean=4, sd=2, min=2, max=8),
                    passage_len=dict(mean=9, sd=4, min=2, max=16))
    return cell


def _run(cell, tmp_path, trace=False):
    return train_dp_driver.run_cell(cell.spec, cell.model, cell.mix, 2 ** 31 + 5, 0.5, trace,
                                    "cpu", time.perf_counter(), str(tmp_path))


def test_four_ranks_follow_the_reference_at_the_global_batch(tmp_path):
    cell = small_dp_cell()
    res = _run(cell, tmp_path, trace=True)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert len(res["busy_s_per_chip"]) == 4
    # the per-rank masks matter: the reference with one rank's stream reads far off
    assert max(res["numbers"].values()) < 0.05
    line = runner.result_line(cell, res, True, {"platform": "cpu", "kind": "cpu", "count": 4})
    json.loads(json.dumps(line))
    assert line["device"]["busy_s"] == sum(res["busy_s_per_chip"]) / 4


def test_the_exchange_left_out_is_not_correct(tmp_path, monkeypatch):
    cell = small_dp_cell()
    monkeypatch.setenv("BENCH_TEST_FAULT", "no_exchange")
    monkeypatch.setenv("PYTHONPATH", str(FAULT_SITE))
    from twotowermlretrieval_tpu_torch.models import losses
    from twotowermlretrieval_tpu_torch.train import train_step

    monkeypatch.setattr(train_step, "psum_", lambda x, group: x)
    monkeypatch.setattr(losses, "psum", lambda x, group: x)
    monkeypatch.setattr(losses, "all_gather_rows", lambda x, group: x)
    monkeypatch.setattr(losses, "axis_index", lambda group: 0)
    res = _run(cell, tmp_path)
    assert not checks.verdict(res["numbers"], cell.spec["limits"])
