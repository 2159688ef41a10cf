"""Loaded at start-up by the data-parallel ranks of
``test_bench_dp.py``'s fault test (this folder first on PYTHONPATH):
with ``BENCH_TEST_FAULT=no_exchange`` every rank's step runs without the
exchange between ranks (no all-reduce, no gathered negatives)."""

import os

if os.environ.get("BENCH_TEST_FAULT") == "no_exchange":
    from twotowermlretrieval_tpu_torch.models import losses
    from twotowermlretrieval_tpu_torch.train import train_step

    train_step.psum_ = lambda x, group: x
    losses.psum = lambda x, group: x
    losses.all_gather_rows = lambda x, group: x
    losses.axis_index = lambda group: 0  # each rank labels its own rows
