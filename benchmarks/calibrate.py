"""The readings the limits of a training cell are set from.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--device cuda] [--out FILE]

Training cells: for each seed, the program's first steps, driven as a run
drives them (set-up of ``harness/train_driver.py``), against the
reference (``loss_gap``, ``grad_gap``, ``update_gap``): the lower
readings. For each control seed, in the program's place: the reference at
fp8 products (the control) and the reference on half of each batch (a
fault), against the reference: the upper readings; a step that returns
its state unchanged reads 1 by ``update_gap`` and needs no run. A data-parallel cell's
controls and faults follow the global batch with every rank's dropout
masks (the exchange between ranks left out: rank 0's own rows, negatives
and gradient); its program readings come from its runs, on all its cards.

Search cells: for each seed, a run's set-up, a window of ``--seconds`` and
its check (``score_gap``, ``rank_gap``); for each control seed the same
with the program's own int8 index (its next precision below bf16).

One JSON line per reading. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks.harness import checks  # noqa: E402
from benchmarks.harness.runner import Cell  # noqa: E402
from benchmarks.harness.train_driver import TrainRun  # noqa: E402


def search_readings(cell: Cell, seeds, control_seeds, device, emit, seconds):
    import torch

    from benchmarks.harness.search_driver import SearchRun

    for seed in seeds:
        for side, storage in (("program", None), ("control_int8", "int8")):
            if side != "program" and seed not in control_seeds:
                continue
            t0 = time.perf_counter()
            run = SearchRun(cell.model, cell.mix, cell.spec, seed, device, storage_dtype=storage)
            run.setup()
            win = run.window(seconds)
            run.free()
            emit({"cell": cell.name, "seed": seed, "side": side, **run.check(
                int(cell.spec.get("sample_batches", 8))), "batches": win["batches"],
                "seconds": time.perf_counter() - t0})
            del run
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()


def readings(cell: Cell, seeds, control_seeds, device, emit):
    import torch

    control_seeds = set(control_seeds)
    ranks = int(cell.spec.get("world", 1))
    faults = [("control_fp8", {"precision": "fp8"}), ("fault_half_batch", {"half_batch": True})]
    if ranks > 1:
        faults.append(("fault_no_exchange", {"only_rank": 0}))
    for seed in seeds:
        t0 = time.perf_counter()
        run = TrainRun(cell.model, cell.mix, seed, device)
        run.setup()
        run.free()
        ref = run.reference(ranks=ranks)
        if ranks == 1:  # a data-parallel cell's program readings are its runs'
            emit({"cell": cell.name, "seed": seed, "side": "program",
                  **checks.training_gaps(run.first, ref), "loss": run.first["loss"],
                  "seconds": time.perf_counter() - t0})
        if seed in control_seeds:
            for side, kw in faults:
                other = run.reference(ranks=ranks, **kw)
                prog = {"loss": other["loss"],
                        "grad_norms": dict(zip(other["names"], other["grad_norms"])),
                        "change_rows": dict(zip(other["names"], other["change_rows"]))}
                emit({"cell": cell.name, "seed": seed, "side": side,
                      **checks.training_gaps(prog, ref)})
        del run
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seconds", type=float, default=2.0, help="a search cell's short window")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        cell = Cell(args.workload)
        if cell.spec["driver"] == "search":
            search_readings(cell, seeds, set(control), args.device, emit, args.seconds)
        else:
            readings(cell, seeds, control, args.device, emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
