"""xeve_tpu_torch.trace: the recorder's semantics, and the spans of the
device engine's frame pipeline on the CPU (RA GOP16 over one and over two
sub-GOPs, and all-intra, on two frame workers, at the size
test_torch_device_encode.py uses): one task and one C call per coded
frame under its display index, the RA tasks' dependencies and the
sub-GOPs in flight before theirs, children inside their parents, and the
same bitstream with the recorder on and off."""
import threading

import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu_torch import api, trace
from xeve_tpu_torch.native import build
from xeve_tpu_torch.params import EncoderParams

torch.set_num_threads(1)

W, H = 128, 64


def _frames(n):
    out = []
    for t in range(n):
        y, u, v = gen_frame(W, H, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.stop()
    yield
    trace.stop()


def test_off_keeps_nothing_and_returns_the_shared_no_op():
    sp = trace.span("x", poc=1)
    assert sp is trace.OFF and trace.span("y") is sp
    with sp as s:
        s.set(k=2)
    assert trace.now() is None and trace.attr("poc") is None
    assert trace.stop() == []


def test_parents_threads_and_attrs():
    trace.start()
    with trace.span("outer", poc=3) as a:
        a.set(base=0)
        with trace.span("inner", behind=2):
            assert trace.attr("poc") == 3 and trace.attr("base") == 0

        def work():
            with trace.span("worker", poc=4):
                assert trace.attr("poc") == 4

        th = threading.Thread(target=work, name="xt-frame_9")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        t = trace.now()
    recs = trace.stop()
    by = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["outer", "inner", "worker"]
    assert by["outer"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["worker"]["parent"] is None           # no link across threads
    assert by["outer"]["thread"] == by["inner"]["thread"] == \
        threading.current_thread().name
    assert by["worker"]["thread"] == "xt-frame_9"
    assert by["outer"]["attrs"] == {"poc": 3, "base": 0}
    assert by["inner"]["attrs"] == {"behind": 2}
    assert by["outer"]["t0"] <= by["inner"]["t0"] <= by["inner"]["t1"] \
        <= t <= by["outer"]["t1"]
    assert all(r["cpu"] >= 0 for r in recs)


def test_a_span_closed_after_stop_is_dropped_and_start_clears():
    trace.start()
    with trace.span("kept"):
        pass
    late = trace.span("late")
    late.__enter__()
    assert [r["name"] for r in trace.stop()] == ["kept"]
    trace.start()
    late.__exit__(None, None, None)
    with trace.span("new"):
        pass
    assert [r["name"] for r in trace.stop()] == ["new"]


def test_the_c_pass_load_is_a_span(monkeypatch):
    build.get_lib()                 # built at first use, if need be
    monkeypatch.setattr(build, "_lib", None)
    trace.start()
    build.get_lib()
    build.get_lib()                 # loaded: the lock alone, no span
    recs = trace.stop()
    assert [r["name"] for r in recs] == ["native.load"]
    assert recs[0]["attrs"] == {"built": False}


def _encode(cls, p, frames):
    enc = getattr(api, cls)(EncoderParams(**p), analysis="device",
                            device="cpu")
    out = []
    for bs, _rec, poc in enc.encode_stream(iter(frames)):
        st = enc.last_stat
        out.append((bs, poc, (list(st.ref_pocs_l0), list(st.ref_pocs_l1))
                    if st is not None and st.poc == poc else None))
    return enc, out


def _check_nesting(recs):
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["thread"] == r["thread"]
            assert p["t0"] <= r["t0"] <= r["t1"] <= p["t1"], (p, r)


def _ancestor(recs, r, name):
    by_id = {x["id"]: x for x in recs}
    p = by_id.get(r["parent"])
    while p is not None and p["name"] != name:
        p = by_id.get(p["parent"])
    return p


CASES = {
    "ra": ("GopEncoder", dict(w=W, h=H, qp=30, keyint=0, bframes=15), 18),
    "ai": ("Encoder", dict(w=W, h=H, qp=30, keyint=1), 5),
    "ra_subgops": ("GopEncoder", dict(w=W, h=H, qp=30, keyint=0,
                                      bframes=15), 34),
}


@pytest.mark.parametrize("case", list(CASES))
def test_frame_pipeline_spans(case, monkeypatch):
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", "2")
    cls, p, n = CASES[case]
    ra = case.startswith("ra")
    frames = _frames(n)
    _enc, plain = _encode(cls, p, frames)
    trace.start()
    enc, traced = _encode(cls, p, frames)
    recs = trace.stop()
    assert [(bs, poc) for bs, poc, _l in traced] == \
        [(bs, poc) for bs, poc, _l in plain]
    _check_nesting(recs)

    tasks = [r for r in recs if r["name"] == "frame.task"]
    # RA: the frames of the full sub-GOPs
    coded = list(range(1, (n - 1) // 16 * 16 + 1)) if ra else list(range(n))
    assert sorted(r["attrs"]["poc"] for r in tasks) == coded
    assert all(r["thread"].startswith("xt-frame") for r in tasks)
    assert all(r["attrs"]["t_submit"] <= r["t0"] for r in tasks)
    ccall = [r for r in recs if r["name"] == "native.ccall"]
    under = {}
    for r in ccall:
        t = _ancestor(recs, r, "frame.task")
        if t is not None:
            assert r["attrs"]["poc"] == t["attrs"]["poc"]
            under.setdefault(t["attrs"]["poc"], []).append(r)
    assert sorted(under) == coded and all(len(v) == 1
                                          for v in under.values())
    # RA: the I frame and the truncated last sub-GOP code on the main thread
    assert sorted(r["attrs"]["poc"] for r in ccall) == \
        (list(range(n)) if ra else coded)

    for r in recs:
        if r["name"] in ("device_analyzer.queue", "device_analyzer.readback",
                         "native.ccall") and r["thread"] != "MainThread":
            assert _ancestor(recs, r, "frame.task") is not None
    dispatches = [r for r in recs if r["name"] == "device_analyzer.dispatch"]
    assert sorted(r["attrs"]["seq"] for r in dispatches) == \
        list(range(1, enc._device().dispatches + 1))
    kind = {r["attrs"]["poc"]: r["attrs"]["kind"] for r in dispatches}
    # RA: the anchor's two lists hold the I frame alone, a P signature
    assert {kind[poc] for poc in coded} == \
        ({"P", "B"} if ra else {"I"})
    assert all(r["thread"].startswith("xt-dispatch") for r in recs
               if r["name"] == "device_analyzer.upload")
    readback = [r for r in recs if r["name"] == "device_analyzer.readback"]
    assert len(readback) == n and all(r["attrs"]["behind"] >= 0
                                      for r in readback)
    emits = [r for r in recs if r["name"] == "api.emit"]
    assert sorted(r["attrs"]["poc"] for r in emits) == coded
    waits = [r for r in recs if r["name"] == "api.wait"]
    assert len(waits) == len(emits)
    assert all(_ancestor(recs, r, "api.emit")["attrs"]["poc"]
               == r["attrs"]["poc"] for r in waits)
    feeds = [r for r in recs if r["name"] == "api.feed"]
    assert [r["attrs"]["poc"] for r in feeds] == list(range(n))
    sched = [r for r in recs if r["name"] == "api.schedule"]
    assert [r["attrs"] for r in sched] == (
        [{"base": b} for b in range(0, len(coded), 16)] if ra
        else [{"poc": i} for i in range(n)])

    if ra:
        # deps: the POCs of each frame's coded ref lists outside the DPB
        # when its sub-GOP was scheduled: the I frame and the sub-GOPs
        # emitted by then, all but the _SUBGOPS_IN_FLIGHT - 1 before it
        lists = {poc: l for _bs, poc, l in traced if l is not None}
        for r in tasks:
            a = r["attrs"]
            base = (a["poc"] - 1) // 16 * 16
            in_dpb = max(base - 16 * (api._SUBGOPS_IN_FLIGHT - 1), 0)
            l0, l1 = lists[a["poc"]]
            assert a["deps"] == [q for q in l0 + l1 if q > in_dpb]
            assert a["base"] == base
            # sub-GOPs scheduled before this one and not fully emitted
            assert 0 <= a["ahead"] <= min(base // 16,
                                          api._SUBGOPS_IN_FLIGHT - 1)
        assert enc.ahead_tasks == sum(1 for r in tasks if r["attrs"]["ahead"])
        if case == "ra_subgops":
            # sub-GOP 2's anchor depends on sub-GOP 1's and starts before
            # sub-GOP 1's last emission
            anchor = next(r for r in tasks if r["attrs"]["poc"] == 32)
            assert 16 in anchor["attrs"]["deps"]
            assert anchor["attrs"]["ahead"] == 1
            last_emit = max(r["t1"] for r in emits if r["attrs"]["poc"] <= 16)
            assert anchor["attrs"]["t_submit"] < last_emit
        else:
            assert enc.ahead_tasks == 0
