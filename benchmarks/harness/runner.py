"""One run of one cell: ``python3 benchmarks/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration's file, ``workloads/<cell>.json`` (the driver, the limits of
the comparison), ``traffic/<mix>.json`` and, for a traced run,
``metrics/<metric>.py`` for every per-layer metric of the cell. The last
line of standard output is the result's JSON object; the numbers compared
are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# compared by whole top-level module name: the port's name begins with the
# JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "twotowermlretrieval_tpu")


class Cell:
    """A cell's entries and files, found by its name."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        if bench is None:
            bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        self.bench = bench
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.entry = name, by_name[name]
        cfg = {c["name"]: c for c in self.bench["configs"]}[self.entry["config"]]
        config_file = json.loads((ROOT / cfg["file"]).read_text())
        self.model = {**config_file["config"], **config_file.get("values", {})}
        self.spec = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
        self.mix = json.loads((BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json").read_text())

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_metric(name: str):
    """``metrics/<name>.py`` as a module (the name holds dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return " | ".join(r.stdout.split("\n")).strip(" |")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Context:
    """What a per-layer metric's ``read`` sees."""

    def __init__(self, cell: Cell, result: dict, trace):
        self.model = cell.model
        self.spec = cell.spec
        self.window = result.get("window")
        self.traced_steps = result.get("traced_steps", [])
        self.traced_batches = result.get("traced_batches", 0)
        self.trace = trace
        self.chips = int(cell.entry["chips"])
        # the rows of a global batch each card holds (a data-parallel cell)
        self.ranks = int(cell.spec.get("world", 1))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             tmpdir: str) -> dict:
    driver = importlib.import_module(f"benchmarks.harness.{cell.spec['driver']}_driver")
    return driver.run_cell(cell.spec, cell.model, cell.mix, seed, seconds, trace, device,
                           t_start, tmpdir)


def result_line(cell: Cell, result: dict, trace: bool, device_desc: dict) -> dict:
    from benchmarks.harness import checks
    from benchmarks.harness.trace import Trace, short_name

    limits = cell.spec["limits"]
    numbers = result["numbers"]
    correct = checks.verdict(numbers, limits) and result["failed"] == 0
    line = {"correct": bool(correct), "attempted": int(result["attempted"]),
            "failed": int(result["failed"])}
    device = dict(device_desc, memory_peak_bytes=int(result["memory_peak_bytes"]))
    metrics: Dict[str, dict] = {}
    if trace:
        tr = Trace.load(result["trace_path"]) if result.get("trace_path") else None
        ctx = Context(cell, result, tr)
        for m in cell.per_layer():
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            busy = result.get("busy_s_per_chip") or [tr.busy_us / 1e6]
            device["busy_s"] = sum(busy) / len(busy)
            device["window_s"] = tr.window_us / 1e6
            line["breakdown"] = {
                "device_ops": [[short_name(n), s] for n, s in tr.top_ops(10)],
                "idle_gaps": [[n, s] for n, s in tr.idle_gaps(10)],
            }
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": result["e2e"][m["name"]], "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return line


def main(argv=None, t_start: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch

    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    tmpdir = os.environ.get("TMPDIR") or tempfile.gettempdir()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, tmpdir)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the benchmark must not load were loaded: {bad}", file=sys.stderr)
        return 4
    desc = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = result_line(cell, result, bool(args.trace), desc)
    if result.get("trace_path"):
        Path(result["trace_path"]).unlink(missing_ok=True)
    print(f"card: {card_line()}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
