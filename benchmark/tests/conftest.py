"""CPU tests of the benchmark's harness and reference; run with
`python -m pytest benchmark/tests -q`.  Tests marked `cuda` need a card
and skip here; on the card: `python -m pytest benchmark/tests -q -m cuda`."""
import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test where "
        "there is none")
