"""The benchmark's own tests: ``python -m pytest benchmarks/tests`` from the
root of a checkout (on a card machine, ``-m cuda`` for the card's)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
