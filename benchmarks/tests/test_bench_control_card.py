"""The controls of the cells on the card, at the cells' own sizes:
the reference at fp8 products, put in the program's place, is not correct
on three seeds. Run on a card machine:

    python -m pytest -m cuda benchmarks/tests/test_bench_control_card.py
"""

import pytest
import torch

from benchmarks.harness import checks, runner
from benchmarks.harness.train_driver import TrainRun


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gru-inbatch.train", "transformer-c5.train"])
def test_the_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = runner.Cell(name)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        run = TrainRun(cell.model, cell.mix, seed, "cuda")
        run.setup()
        run.free()
        ref = run.reference()
        ctl = run.reference(precision="fp8")
        numbers = checks.training_gaps(
            {"loss": ctl["loss"], "grad_norms": dict(zip(ctl["names"], ctl["grad_norms"])),
             "change_rows": dict(zip(ctl["names"], ctl["change_rows"]))}, ref)
        assert not checks.verdict(numbers, cell.spec["limits"]), (seed, numbers)
        assert checks.verdict(checks.training_gaps(run.first, ref), cell.spec["limits"])
        del run
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_search_control_is_not_correct():
    """The program's own int8 index (its next precision below bf16) in place
    of the bf16 one, after a short window at the cell's load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmarks.harness.search_driver import SearchRun

    cell = runner.Cell("gru-inbatch.search")
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        run = SearchRun(cell.model, cell.mix, cell.spec, seed, "cuda", storage_dtype="int8")
        run.setup()
        run.window(2.0)
        run.free()
        numbers = run.check(int(cell.spec["sample_batches"]))
        assert not checks.verdict(numbers, cell.spec["limits"]), (seed, numbers)
        del run
        torch.cuda.empty_cache()
