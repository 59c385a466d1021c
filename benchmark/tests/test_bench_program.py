"""The readings of the program's own spans (evcbench/program.py and
program_spans.py) on the CPU at a small frame size, their arithmetic on
planted records, an untraced run that never turns the recorder on, and,
on a card, the recorder's clock against the device trace's."""
import copy
import time

import pytest
import torch

import program_spans
from evcbench import cell as cells
from evcbench import devtrace, program
from evcbench.drive import run_cell
from xeve_tpu_torch import trace

W, H = 128, 64
RA, AI = "baseline_1080p.ra_gop16", "baseline_1080p.ai"
EVERY = {"native.ccall_ms_per_frame", "native.ccall_cpu_share",
         "frame_worker.host_ms_per_frame", "frame_worker.running_mean",
         "frame_worker.ready_wait_ms_per_frame", "api.host_ms_per_frame",
         "api.emit_wait_ms_per_frame",
         "device_analyzer.enqueue_ms_per_frame",
         "device_analyzer.queue_ms_per_frame",
         "device_analyzer.readback_ms_per_frame",
         "device_analyzer.readback_behind_mean",
         "device_analyzer.recoveries_per_frame", "native.load_s",
         "device_analyzer.warm_s"}


def _tiny(name):
    _c, cfg, traffic, _e, _p = cells.load_cell(name)
    cfg = copy.deepcopy(cfg)
    cfg["params"].update(w=W, h=H)
    return cfg, traffic


@pytest.mark.parametrize("name", [RA, AI])
def test_a_run_gives_every_reading(name, monkeypatch):
    from xeve_tpu_torch.native import build
    monkeypatch.setattr(build, "_lib", None)     # set-up loads the C pass
    cfg, traffic = _tiny(name)
    line = program_spans.run(name, cfg, traffic, seed=2 ** 33 + 3,
                             seconds=1.0, device="cpu",
                             t_proc0=time.perf_counter())
    got = line["readings"]
    want = EVERY | ({"api.critical_path_share"} if name == RA else set())
    assert set(got) == want
    assert all(isinstance(v, float) and v >= 0 for v in got.values())
    assert got["device_analyzer.recoveries_per_frame"] == 0
    # a worker's task is its C call, its waits for the analysis and the
    # rest, its own host work
    parts = sum(got[k] for k in ("native.ccall_ms_per_frame",
                                 "frame_worker.host_ms_per_frame",
                                 "device_analyzer.queue_ms_per_frame",
                                 "device_analyzer.readback_ms_per_frame"))
    assert parts == pytest.approx(line["frame_task_ms_per_frame"], rel=1e-9)
    assert got["native.ccall_ms_per_frame"] <= \
        line["benchmark"]["native.cpass_ms_per_frame"]
    assert trace.span("x") is trace.OFF


def test_an_untraced_run_never_turns_the_recorder_on(monkeypatch):
    def refuse():
        raise AssertionError("the recorder was started")

    monkeypatch.setattr(trace, "start", refuse)
    cfg, traffic = _tiny(AI)
    out = run_cell(AI, cfg, traffic, seed=2 ** 33 + 5, seconds=1.0,
                   trace=False, device="cpu", t_proc0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert trace.span("x") is trace.OFF and trace.stop() == []


def _rec(i, name, t0, t1, parent=None, thread="xt-frame_0", cpu=None,
         **attrs):
    return {"id": i, "name": name, "thread": thread, "t0": t0, "t1": t1,
            "cpu": t1 - t0 if cpu is None else cpu, "parent": parent,
            "attrs": attrs}


def test_readings_of_planted_records():
    """Two sub-GOPs of three tasks (anchor a, then b and c on a), each
    emitted on the main thread; window (0, 10], 6 frames."""
    recs, i = [], 0
    for base, s in ((0, 0.0), (16, 5.0)):
        a, b, c = base + 16, base + 8, base + 4
        recs += [
            _rec(i, "frame.task", s + 0.5, s + 2.5, t_submit=s + 0.5,
                 deps=[], base=base, poc=a),
            _rec(i + 1, "native.ccall", s + 1.0, s + 2.0, i, cpu=0.5, poc=a),
            _rec(i + 2, "frame.task", s + 3.0, s + 4.0, t_submit=s + 2.5,
                 deps=[a], base=base, poc=b),
            _rec(i + 3, "frame.task", s + 3.0, s + 3.5, t_submit=s + 2.5,
                 deps=[a], base=base, poc=c, thread="xt-frame_1")]
        for k, p in enumerate((a, b, c)):
            recs.append(_rec(i + 4 + k, "api.emit", s + 4.0 + 0.25 * k,
                             s + 4.25 + 0.25 * k, thread="MainThread",
                             poc=p))
        i += 7
    got = program.readings(recs, (0.0, 10.0, 6), recoveries=0)
    assert got["native.ccall_ms_per_frame"] == pytest.approx(2000 / 6)
    assert got["native.ccall_cpu_share"] == pytest.approx(0.5)
    # tasks 2 + 1 + 0.5 a sub-GOP, less the C calls' 1
    assert got["frame_worker.host_ms_per_frame"] == pytest.approx(5000 / 6)
    assert got["frame_worker.running_mean"] == pytest.approx(0.7)
    assert got["frame_worker.ready_wait_ms_per_frame"] == \
        pytest.approx(2000 / 6)
    # chains 3.0 s over 4.75 s (0 to 4.75), then 3.0 over 5.0
    assert got["api.critical_path_share"] == \
        pytest.approx((3.0 / 4.75 + 3.0 / 5.0) / 2)
    assert got["api.host_ms_per_frame"] == pytest.approx(1500 / 6)
    assert "api.emit_wait_ms_per_frame" not in got
    assert got["device_analyzer.recoveries_per_frame"] == 0
    # a window that closes before the second sub-GOP's emissions
    assert program.critical_path_share(recs, (0.0, 6.0, 3)) == \
        pytest.approx(3.0 / 4.75)


def test_idle_gaps_name_the_spans_open_on_main_and_dispatcher():
    iv = [(0.0, 1.0, "k"), (3.0, 3.5, "k")]
    recs = [_rec(0, "api.emit", 1.2, 2.9, thread="MainThread"),
            _rec(1, "api.wait", 1.3, 2.8, 0, thread="MainThread"),
            _rec(2, "device_analyzer.upload", 1.5, 2.5,
                 thread="xt-dispatch_0"),
            _rec(3, "frame.task", 1.0, 3.0)]
    gaps = program.label_gaps(iv, 0.0, 4.0, {"cpass": [(1.0, 3.0)]}, recs)
    assert gaps[0] == ["cpass|main:api.wait|dispatch:device_analyzer.upload",
                       pytest.approx(2.0)]
    assert gaps[1][0] == "none|main:none|dispatch:none"
    plain = devtrace.summarize(iv, 0.0, 4.0, {"cpass": [(1.0, 3.0)]})
    assert [g[0].split("|")[0] for g in gaps] == \
        [g[0] for g in plain["idle_gaps"]]


@pytest.mark.cuda
def test_the_recorders_clock_is_the_device_traces():
    """A recorder span around a sleeping kernel and the synchronize that
    waits for it holds the kernel's device interval, mapped onto the host
    clock through devtrace's marker, to within 50 us at each edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    devtrace.DeviceTrace.warm(dev)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    tr = devtrace.DeviceTrace()
    trace.start()
    tr.start()
    for _ in range(3):
        with trace.span("sleep"):
            torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize(dev)
        time.sleep(0.01)
    tr.stop()
    spans = [r for r in trace.stop() if r["name"] == "sleep"]
    kernels = sorted(((b - a, a, b) for a, b, _n in tr.device_intervals()),
                     reverse=True)[:3]
    assert len(spans) == 3 and len(kernels) == 3
    for (_d, a, b), r in zip(sorted(kernels, key=lambda k: k[1]), spans):
        assert r["t0"] <= a + 50e-6 and b <= r["t1"] + 50e-6, (a, b, r)
        assert b - a > 0.9 * (r["t1"] - r["t0"])
