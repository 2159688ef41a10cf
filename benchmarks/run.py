"""Run one cell of the port's benchmark once.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``benchmarks/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernels' and the tokenizer's build, and any other cache, at fixed
# paths inside the checkout
os.environ["TTR_TORCH_BUILD_DIR"] = str(ROOT / "twotowermlretrieval_tpu_torch" / "_build")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's own work is a Python loop
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

from benchmarks.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
