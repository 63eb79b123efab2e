"""The benchmark's own tests (run as `python -m pytest benchmark/tests`;
the repository's suite under tests/ does not collect them). They import
the harness as `run.py` does: benchmark/ and the checkout's root on the
path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "card: needs an NVIDIA card; decides inside the test and skips "
        "without one")
