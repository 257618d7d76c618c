"""pytest settings of the benchmark's own tests: `python -m pytest -q
-p no:cacheprovider blgbench` (CPU, ~2 min); on the card add `-m cuda`."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
