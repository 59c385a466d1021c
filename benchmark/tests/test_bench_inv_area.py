"""native.inv_area_share: the inverse transforms' nonzero rectangles over
their blocks' areas, summed over the window's native.ccall spans; None
where the spans carry no counts."""
import pytest

from evcbench import cell as cells

WINDOW = (10.0, 20.0, 8)


def _ccall(t0, **attrs):
    return {"name": "native.ccall", "thread": "xt-frame_0", "t0": t0,
            "t1": t0 + 0.5, "cpu": 0.5, "id": int(t0 * 10), "parent": None,
            "attrs": {"poc": 1, **attrs}}


def _read(program):
    return cells.reader("native.inv_area_share")(
        {"window": WINDOW, "program": program})


def test_the_share_sums_the_spans_that_open_in_the_window():
    program = [
        _ccall(9.0, inv_n=5, inv_area=900, inv_full=1000),     # before
        _ccall(11.0, inv_n=3, inv_area=100, inv_full=4096),
        _ccall(15.0, inv_n=2, inv_area=156, inv_full=4096),
        _ccall(19.8, inv_n=1, inv_area=0, inv_full=0),         # no inverse
        _ccall(20.5, inv_n=4, inv_area=800, inv_full=1000),    # after
        {"name": "frame.task", "thread": "xt-frame_0", "t0": 12.0,
         "t1": 13.0, "cpu": 1.0, "id": 1, "parent": None,
         "attrs": {"poc": 1, "inv_area": 5, "inv_full": 5}},
    ]
    assert _read(program) == pytest.approx(256 / 8192)


def test_spans_without_the_counts_read_none():
    assert _read([_ccall(11.0), _ccall(15.0)]) is None
    assert _read([]) is None
    assert cells.reader("native.inv_area_share")(
        {"window": WINDOW, "program": None}) is None
