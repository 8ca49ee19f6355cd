"""The benchmark's own tests (not collected by the repository's suite):
``python -m pytest benchmark/tests`` from the root of the checkout."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for path in (BENCH.parent, BENCH):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
