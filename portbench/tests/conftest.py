"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``card`` need a CUDA card and skip without one, deciding so
inside the test; run them on the card with the same command."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
