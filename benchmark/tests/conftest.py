"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repo root.  A test that needs the card is marked `gpu` and decides inside
itself whether there is one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
