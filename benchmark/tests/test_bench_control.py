"""The control of `correct` on the card, at a size a test run holds: the
fused analyzer with TF32 matmuls switched on (the nearest precision below
the float32 it states) fails the decisions check that the program
passes.  At the cells' own size the control runs through
benchmark/control.py; PERF.md keeps its readings."""
import copy
import time

import pytest
import torch

from evcbench import cell as cells
from evcbench.drive import run_cell

W, H = 640, 368


def _run(name, seed, tf32):
    _c, cfg, traffic, _e, _p = cells.load_cell(name)
    cfg = copy.deepcopy(cfg)
    cfg["params"].update(w=W, h=H)
    traffic = dict(traffic, quality_frames=1, decode={"prefix": 1})

    def on(_enc):
        torch.backends.cuda.matmul.allow_tf32 = True

    try:
        return run_cell(name, cfg, traffic, seed=seed, seconds=2.0,
                        trace=False, device="cuda", t_proc0=time.perf_counter(),
                        fault=on if tf32 else None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["baseline_1080p.ra_gop16",
                                  "baseline_1080p.ai"])
def test_tf32_fails_the_decisions_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (3, 4, 2 ** 33 + 5):
        sound = _run(name, seed, False)
        control = _run(name, seed, True)
        lim = sound["checks"]["decisions_off"]["limit"]
        assert sound["correct"], sound["checks"]
        assert control["checks"]["decisions_off"]["value"] > lim
        assert not control["correct"]
