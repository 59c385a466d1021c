"""The run record that per-layer readers read, on the CPU: the port's own
spans in a traced run, the program's counters over the window, the
encoder's parameters and every device op with its launches, so that a
kernel's roofline reader is one new file."""
import copy
import json
import os
import time

import pytest

from conftest import ROOT
from evcbench import cell as cells
from evcbench import devtrace, report, roofline
from evcbench.drive import PARAMS, run_cell

RA = "baseline_1080p.ra_gop16"


def test_a_traced_run_keeps_the_ports_spans_counters_and_parameters():
    _c, cfg, traffic, e2e, per_layer = cells.load_cell(RA)
    cfg = copy.deepcopy(cfg)
    cfg["params"].update(w=128, h=64)
    out = run_cell(RA, cfg, traffic, seed=2 ** 33 + 17, seconds=1.0,
                   trace=True, device="cpu", t_proc0=time.perf_counter())
    assert out["correct"], out["checks"]
    run = out["run"]
    t0, t1, n = run["window"]
    names = {r["name"] for r in run["program"]}
    assert {"frame.task", "native.ccall", "device_analyzer.dispatch",
            "device_analyzer.collect"} <= names
    assert run["counters"] == {"me_cuda.LAUNCHES": 0,
                               "DeviceAnalyzer.failures": 0,
                               "Encoder.analysis_calls": 0,
                               "GopEncoder.ahead_tasks":
                                   run["counters"]["GopEncoder.ahead_tasks"]}
    assert run["counters"]["GopEncoder.ahead_tasks"] >= 0
    assert set(run["params"]) == set(PARAMS) | {"engine"}
    assert (run["params"]["w_aligned"], run["params"]["h_aligned"],
            run["params"]["bframes"], run["params"]["engine"]) == \
        (128, 64, 15, "device")
    assert run["device"] is None            # no device to trace here
    line = report.result_line(out, e2e, per_layer, trace=1, chips=1,
                              kind="cpu")
    got = line["metrics"]
    assert 0 < got["frame_worker.running_mean"]["value"] <= 4
    assert got["device_analyzer.enqueue_ms_per_dispatch"]["value"] > 0
    assert not any(k.startswith("device.") for k in got)


def test_the_device_summary_keeps_every_op_with_its_launches():
    long = "void at::native::reduce_kernel<" + "x" * 300 + ">"
    iv = [(0.0, 0.5, long), (0.6, 0.7, long), (1.9, 2.5, "edge")]
    iv += [(0.8 + 0.01 * k, 0.805 + 0.01 * k, f"k{k}") for k in range(12)]
    s = devtrace.summarize(iv, 0.0, 2.0, {})
    assert s["ops"][long] == [pytest.approx(0.6), 2]
    assert s["ops"]["edge"] == [pytest.approx(0.1), 1]     # clipped
    assert len(s["ops"]) == 14 and len(s["device_ops"]) == 10
    assert s["device_ops"][0] == [long[:devtrace.NAME_CHARS],
                                  pytest.approx(0.6)]
    assert sum(v[0] for v in s["ops"].values()) >= \
        sum(v for _n, v in s["device_ops"])


# a kernel's roofline reader, as a later change would add it: the least
# time of the ME kernel's launches over their time on the device
ME_ROOFLINE = '''
from evcbench import roofline


def read(run):
    d, p = run["device"], run["params"]
    ops = [v for k, v in (d["ops"] if d else {}).items()
           if k.startswith("me_full_search_kernel")]
    if not ops:
        return None
    seconds = sum(s for s, _n in ops)
    launches = sum(n for _s, n in ops)
    bound = roofline.me_bound_s(p["w_aligned"], p["h_aligned"],
                                p["search_range"], 80)
    return 100.0 * bound * launches / seconds
'''


def test_a_kernels_roofline_reader_is_one_new_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "me_cuda.roofline_share.py").write_text(
        ME_ROOFLINE)
    kernel = ("me_full_search_kernel(int const*, int const*, int*, int*, "
              "int, int, int, int, int, int)")
    ms = 0.2054e-3
    run = {"window": (0.0, 20.0, 128), "spans": {}, "program": None,
           "device": {"busy_s": 2.0, "window_s": 20.0, "device_ops": [],
                      "idle_gaps": [],
                      "ops": {kernel: [31 * ms, 31],
                              "void at::native::reduce_kernel": [1.9, 900]}},
           "counters": {"me_cuda.LAUNCHES": 31},
           "params": {"w_aligned": 1920, "h_aligned": 1088,
                      "search_range": 16, "engine": "jax"}}
    out = {"run": run, "correct": True, "attempted": 128, "failed": 0,
           "memory_peak_bytes": 1, "checks": {}}
    metric = [{"name": "me_cuda.roofline_share", "unit": "%"}]
    line = report.result_line(out, [], metric, trace=1, chips=1,
                              kind="card", bench_dir=str(tmp_path))
    want = 100.0 * roofline.me_bound_s(1920, 1088, 16, 80) / ms
    assert line["metrics"]["me_cuda.roofline_share"]["value"] == \
        pytest.approx(want)
    assert 60.0 < want < 70.0       # PERF.md: 0.662 of the bound
    # a run that launched no ME kernel leaves the metric out
    run["device"]["ops"].pop(kernel)
    line = report.result_line(out, [], metric, trace=1, chips=1,
                              kind="card", bench_dir=str(tmp_path))
    assert "me_cuda.roofline_share" not in line["metrics"]


def test_the_benchmark_lists_a_reader_for_each_new_metric():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    names = {m["name"]: m for m in spec["per_layer"]}
    for name in ("frame_worker.running_mean",
                 "device_analyzer.enqueue_ms_per_dispatch"):
        assert names[name]["source"] == "program_span"
        assert names[name]["moves"] == "fps"
        assert callable(cells.reader(name))
