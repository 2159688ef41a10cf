"""The program's spans on the card, in a traced group of the GRU training
cell at its own shape (B=1024): the device time finds its launches through
the correlation id, no kernel starts before its launch (the trace's host and
device clocks agree), and the step's parts with the group's copy account for
the card's busy time. Run on a card machine:

    python -m pytest -m cuda benchmarks/tests/test_bench_spans_card.py
"""

import pytest
import torch

from benchmarks.harness import runner
from benchmarks.harness.spans import Spans
from benchmarks.harness.train_driver import TrainRun


@pytest.mark.cuda
def test_a_traced_gru_group_is_attributed_to_the_programs_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = runner.Cell("gru-inbatch.train")
    run = TrainRun(cell.model, cell.mix, 2 ** 31 + 31, "cuda")
    run.setup()
    path = tmp_path / "trace.json"
    steps = len(run.traced(1, str(path)))
    run.free()
    spans = Spans.load(path)
    assert spans.count("ttr.train.step") == steps > 0
    assert spans.launched_share() >= 0.99
    assert spans.attributed_share() >= 0.99
    lags = spans.launch_lags_us()
    early = [lag for lag in lags if lag < -5.0]
    # fails where the trace's device clock is not aligned with the host's:
    # then an idle gap is named by time less surely (PERF.md section 7)
    assert len(lags) > 100 and not early, (
        f"{len(early)} of {len(lags)} operations start before their launch, "
        f"by up to {-min(lags):.1f} us")
    parts = sum(spans.device_us(f"ttr.train.{p}") for p in ("forward", "backward", "optimizer"))
    parts += spans.device_us("ttr.data.copy")
    assert parts == pytest.approx(spans.busy_us(), rel=0.05)
