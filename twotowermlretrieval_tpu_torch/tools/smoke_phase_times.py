"""Run a checkout's ``chip_smoke.py`` with each of its phases timed.

    python3 twotowermlretrieval_tpu_torch/tools/smoke_phase_times.py [CHECKOUT] [--out FILE]
        [--kernel-phases | --export]

Loads ``CHECKOUT/chip_smoke.py`` (default: this checkout's), wraps every
module-level ``phase_*`` function so that its wall time is logged to
standard error as it returns, and runs the script's ``main`` with no
arguments, as the script runs alone. The times (``[[phase, seconds], ...]``
in the order the phases returned) are written to FILE as JSON. The exit
code is the script's. Run it on two checkouts in one call on the same
card to see which phases take a difference in the script's total.

``--kernel-phases`` runs only the build and the kernel phases
(:data:`KERNEL_PHASES`, each on the first card) and adds their records
(every kernel check's times, bounds and errors) to FILE under
``"records"``: run two checkouts in turns to compare unchanged kernels'
times within one call. ``--export`` runs only the build and the export
(``phase_export``: 70,000 passages through the reference model's doc
tower, 1024 a batch) and adds its record (``export_s``, the launches):
run two checkouts in turns to compare the export's seconds.

    python3 .../smoke_phase_times.py --compare BASE.json... -- NEW.json...

prints, for every kernel record both sides hold (by phase, kernel and
shape), each side's ``ms`` over its runs and where NEW's median lies
against BASE's range ("inside", "faster", "slower"), then the counts.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


KERNEL_PHASES = ("phase_kernels", "phase_int8_kernels", "phase_wide_s8", "phase_wide_batches",
                 "phase_attention_kernels")


def _plain(x):
    """``x`` without what JSON cannot hold (tensors, arrays)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()
                if isinstance(v, (int, float, str, bool, dict, list, tuple, type(None)))}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _times(path) -> dict:
    """{(phase, kernel, shape): ms} of one ``--kernel-phases`` file."""
    out = {}
    for phase, recs in json.loads(Path(path).read_text())["records"].items():
        groups = recs.items() if "ms" not in recs else [("", [recs])]
        for kernel, lst in groups:
            for r in lst if isinstance(lst, list) else []:
                if isinstance(r, dict) and isinstance(r.get("ms"), (int, float)):
                    out[phase, kernel, r.get("shape", "")] = r["ms"]
    return out


def compare(base_files, new_files) -> dict:
    """Each record key both sides hold: BASE's runs, NEW's runs, and where
    NEW's median lies against BASE's range; printed, and the counts
    returned."""
    base, new = [_times(f) for f in base_files], [_times(f) for f in new_files]
    counts = {"inside": 0, "faster": 0, "slower": 0}
    for key in sorted(set.intersection(*(set(t) for t in base + new))):
        b, n = [t[key] for t in base], [t[key] for t in new]
        med = statistics.median(n)
        where = "faster" if med < min(b) else "slower" if med > max(b) else "inside"
        counts[where] += 1
        print(f"{where:6} new median {med:.4f} ms base {min(b):.4f}-{max(b):.4f} "
              f"(new {min(n):.4f}-{max(n):.4f}) {' / '.join(key)}")
    print(json.dumps(counts))
    return counts


def main(argv) -> int:
    args = list(argv)
    if args[:1] == ["--compare"]:
        cut = args.index("--")
        compare(args[1:cut], args[cut + 1:])
        return 0
    kernel_phases = "--kernel-phases" in args
    if kernel_phases:
        args.remove("--kernel-phases")
    export = "--export" in args
    if export:
        args.remove("--export")
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = Path(args[i + 1])
        del args[i : i + 2]
    root = Path(args[0] if args else Path(__file__).resolve().parents[2]).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    times = []

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times.append([name, time.perf_counter() - t0])
                print(f"[phase-times] {name} {times[-1][1]:.3f} s", file=sys.stderr, flush=True)
        return run

    for name in [n for n in vars(smoke) if n.startswith("phase_")]:
        setattr(smoke, name, timed(name, getattr(smoke, name)))
    result = {"checkout": str(root), "phases": times}
    try:
        if not kernel_phases and not export:
            return smoke.main([])
        import torch

        sys.path.insert(0, str(root))  # the checkout's package, as its main would take it
        dev = torch.device("cuda")
        smoke.phase_build()
        result["card"] = smoke.card_line()
        if export:
            result["export"] = _plain(smoke.phase_export(dev)[0])
            print(f"[phase-times] export {json.dumps(result['export'])}", file=sys.stderr,
                  flush=True)
        else:
            result["records"] = {name: _plain(getattr(smoke, name)(dev))
                                 for name in KERNEL_PHASES}
        return 0
    finally:
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(result, default=str))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
