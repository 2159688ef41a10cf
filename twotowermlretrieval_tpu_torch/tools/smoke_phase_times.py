"""Run a checkout's ``chip_smoke.py`` with each of its phases timed.

    python3 twotowermlretrieval_tpu_torch/tools/smoke_phase_times.py [CHECKOUT] [--out FILE]

Loads ``CHECKOUT/chip_smoke.py`` (default: this checkout's), wraps every
module-level ``phase_*`` function so that its wall time is logged to
standard error as it returns, and runs the script's ``main`` with no
arguments, as the script runs alone. The times (``[[phase, seconds], ...]``
in the order the phases returned) are written to FILE as JSON. The exit
code is the script's. Run it on two checkouts in one call on the same
card to see which phases take a difference in the script's total.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    args = list(argv)
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
    try:
        return smoke.main([])
    finally:
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps({"checkout": str(root), "phases": times}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
