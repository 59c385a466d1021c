"""A run of each cell with the program broken under the timed path: the
harness skips its look for a card and runs on the CPU at a small frame
size, and `correct` has to come out false for each fault a cell can have
(a coded frame or an analysis altered where it is produced, a coding
step that returns its earlier state), and true without one."""
import copy
import time

import numpy as np
import pytest

from evcbench import cell as cells
from evcbench.drive import run_cell

W, H = 128, 64
CELLS = ["baseline_1080p.ra_gop16", "main_1080p.ra_gop16",
         "baseline_1080p.ai"]


def _run(name, fault=None, seed=2 ** 33 + 1):
    _c, cfg, traffic, _e, _p = cells.load_cell(name)
    cfg = copy.deepcopy(cfg)
    cfg["params"].update(w=W, h=H)
    return run_cell(name, cfg, traffic, seed=seed, seconds=1.0, trace=False,
                    device="cpu", t_proc0=time.perf_counter(), fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["checked"]["decoded"] >= 3 and out["checked"]["analyzed"] >= 2
    run = out["run"]
    assert run["fps"] > 0 and run["kbps"] > 0 and run["psnr_y"] > 25


def _flip_payload(monkeypatch, api, fn_name):
    """Alter one byte of each slice payload the C pass makes after its
    first."""
    real = getattr(api, fn_name)
    calls = []

    def broken(*a, **k):
        out = list(real(*a, **k))
        calls.append(1)
        if len(calls) > 1:
            b = bytearray(out[0])
            b[len(b) // 2] ^= 0x5A
            out[0] = bytes(b)
        return tuple(out)

    monkeypatch.setattr(api, fn_name, broken)


@pytest.mark.parametrize("name", CELLS)
def test_a_coded_frame_altered_where_it_is_produced(name, monkeypatch):
    from xeve_tpu_torch import api
    fn = "encode_intra_frame_native" if name.endswith(".ai") \
        else "encode_frame_native"
    _flip_payload(monkeypatch, api, fn)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["decode_errors"]["value"] > 0


@pytest.mark.parametrize("name,what", [(c, "mode") for c in CELLS]
                         + [(c, "mv") for c in CELLS[:2]])
def test_an_analysis_altered_where_it_is_produced(name, what):
    """Intra modes (every cell) or MVs (the RA cells: an all-intra
    analysis has none) altered where the analysis is parsed."""
    def fault(enc):
        dev = enc._device()
        real = dev._parse

        def broken(hd, vec):
            res = real(hd, vec)
            maps = getattr(res, what, None)
            if maps is not None:
                for lg in maps:
                    m = maps[lg]
                    alt = (m + 1) % 5 if what == "mode" else m ^ 1
                    maps[lg] = np.where(np.arange(m.size).reshape(m.shape)
                                        % 7 == 0, alt, m)
            return res

        dev._parse = broken

    out = _run(name, fault)
    assert not out["correct"]
    key = "decisions_off" if what == "mode" else "mv_off"
    assert out["checks"][key]["value"] > out["checks"][key]["limit"]


@pytest.mark.parametrize("name", CELLS[:2])
def test_a_coding_step_that_returns_its_earlier_state(name):
    """Every P/B slice after the first comes back as the first one was."""
    def fault(enc):
        real = enc._code_slice
        first = []

        def stale(*a, **k):
            if not first:
                first.append(real(*a, **k))
            return first[0]

        enc._code_slice = stale

    out = _run(name, fault)
    assert not out["correct"]
    assert out["checks"]["decode_errors"]["value"] > 0


def test_an_all_intra_step_that_returns_its_earlier_state(monkeypatch):
    from xeve_tpu_torch import api
    real = api.encode_intra_frame_native
    first = []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    monkeypatch.setattr(api, "encode_intra_frame_native", stale)
    out = _run("baseline_1080p.ai")
    assert not out["correct"]
    # the stale frames decode to what the encoder returned, but lie far
    # from their own sources
    assert out["checks"]["far_frames"]["value"] > 0


def test_a_qp_ladder_altered_where_it_is_produced():
    """The RA hierarchy's qp one step off: the stream still decodes, the
    dispatch check sees it."""
    def fault(enc):
        real = enc._ra_qp
        enc._ra_qp = lambda depth: real(depth) + (depth == 3)

    out = _run("baseline_1080p.ra_gop16", fault)
    assert not out["correct"]
    assert out["checks"]["dispatch_errors"]["value"] > 0
