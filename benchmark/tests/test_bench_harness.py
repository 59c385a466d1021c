"""The harness's arithmetic and its data-driven look-up, on the CPU."""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from evcbench import cell as cells
from evcbench import content, devtrace, report, timeline

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    cell, cfg, traffic, e2e, per_layer = cells.load_cell(name)
    assert cell["name"] == name and cfg["params"]["w"] == 1920
    assert {m["name"] for m in e2e} == {"setup_s", "fps", "kbps", "psnr_y"}
    for m in per_layer:
        assert callable(cells.reader(m["name"]))
    assert cells.load_limits(name)["decode_errors"] == 0


# mixes that no cell uses yet, written as a later PR would add them:
# files alone, each stating its structure
PLANTED = {
    "ld_burst": {"params": {"keyint": 8, "bframes": 0},
                 "structure": {"encoder": "Encoder", "order": "ld",
                               "intra_period": 8,
                               "qp": {"model": "ladder",
                                      "table": "QP_ADAPT_LD", "i_depth": 0,
                                      "tid_depth": [2]}},
                 "unit": 1, "quality_frames": 16, "decode": {"prefix": 10},
                 "analyzer_frames": 2},
    "ra_abr": {"params": {"keyint": 0, "bframes": 15, "rc_type": "abr",
                          "bitrate_kbps": 60.0},
               "structure": {"encoder": "GopEncoder", "order": "ra",
                             "gop": 16, "qp": {"model": "rc"}},
               "unit": 16, "quality_frames": 33, "decode": {"prefix": 18},
               "analyzer_frames": 2},
}


@pytest.mark.parametrize("mix", list(PLANTED))
def test_a_new_config_traffic_and_metric_are_taken_up_without_an_edit(
        tmp_path, mix):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries are found by name, and the new cell runs through
    run_cell on the CPU and comes out correct."""
    from evcbench.drive import run_cell
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="tiny"))
    name = "tiny." + mix
    spec["workloads"].append({"name": name, "config": "tiny",
                              "traffic": mix, "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "extra.count", "unit": "1",
                              "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "fps",
                              "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    base = json.load(open(os.path.join(BENCH, "configs",
                                       "baseline_1080p.json")))
    base["params"].update(w=128, h=64)
    (bench / "configs" / "tiny.json").write_text(json.dumps(base))
    content_spec = json.load(open(os.path.join(
        BENCH, "traffic", "ra_gop16.json")))["content"]
    (bench / "traffic" / (mix + ".json")).write_text(json.dumps(
        dict(PLANTED[mix], content=content_spec, trace_seconds=1)))
    (bench / "metrics" / "extra.count.py").write_text(
        "def read(run):\n    return run['window'][2] * 2\n")
    cell, cfg, traffic, e2e, per_layer = cells.load_cell(
        name, root=str(tmp_path), bench_dir=str(bench))
    assert cfg["params"]["w"] == 128 and traffic["unit"] == \
        PLANTED[mix]["unit"]
    assert "extra.count" in [m["name"] for m in per_layer]
    assert "extra.count" not in [m["name"] for m in cells.load_cell(
        "baseline_1080p.ai", root=str(tmp_path), bench_dir=str(bench))[4]]
    out = run_cell(name, cfg, traffic, seed=2 ** 33 + 9, seconds=1.0,
                   trace=False, device="cpu", t_proc0=time.perf_counter(),
                   limits=cells.load_limits(name, bench_dir=str(bench)))
    assert out["correct"], out["checks"]
    assert out["checked"]["decoded"] == PLANTED[mix]["decode"]["prefix"]
    assert out["checked"]["analyzed"] == 2
    line = report.result_line(out, e2e, per_layer, trace=1, chips=1,
                              kind="cpu", bench_dir=str(bench))
    assert line["metrics"]["extra.count"]["value"] == \
        2 * out["run"]["window"][2]


def test_window_edges_fall_on_unit_ending_emissions():
    t = [10.0, 11.0, 11.5, 13.0, 14.2, 15.0, 15.1, 16.9, 20.0, 20.5]
    # RA-like units of 4 frames: unit ends at emissions 4 and 8
    assert timeline.window(t, 4, 7.0) == (10.0, 14.2, 4)
    assert timeline.window(t, 4, 10.0) == (10.0, 20.0, 8)
    # every emission ends a unit of 1: the last one in time
    assert timeline.window(t, 1, 6.0) == (10.0, 15.1, 6)
    # no unit ends in time: the first unit's end
    assert timeline.window(t, 4, 1.0) == (10.0, 14.2, 4)
    with pytest.raises(ValueError):
        timeline.window(t[:3], 4, 5.0)


def test_quality_frames_are_whole_subgops_in_coding_order():
    traffic = json.load(open(os.path.join(BENCH, "traffic",
                                          "ra_gop16.json")))
    n = traffic["quality_frames"]
    order = timeline.ra_coding_order(4)
    assert len(order) == n == 1 + 4 * 16
    assert sorted(d for d, _ in order) == list(range(n))
    # one period of the clip, every temporal layer of each sub-GOP inside
    assert n - 1 == traffic["content"]["frames"]
    assert [tid for _d, tid in order[1:17]].count(4) == 8


def test_kbps_and_psnr_arithmetic():
    w, h = 8, 4
    frames = [(1000, 0), (500, w * h * 4)]       # exact, then mse 4
    kbps, psnr = timeline.quality(frames, w, h)
    assert kbps == pytest.approx(8 * 1500 * 30 / 2 / 1000)
    want = 10 * np.log10(1023.0 ** 2 / 4.0)
    assert psnr == pytest.approx((99.0 + want) / 2)


def test_interval_union_and_gaps():
    sp = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert timeline.union(sp) == pytest.approx(3.0)
    assert timeline.total(sp) == pytest.approx(3.6)
    assert timeline.clip(sp, 1.5, 3.2) == [(1.5, 2.0), (3.0, 3.2)]
    assert timeline.gaps(sp, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]


def test_device_summary_labels_gaps_with_open_host_spans():
    iv = [(0.0, 1.0, "k1"), (0.5, 1.5, "k2"), (3.0, 3.5, "k1")]
    host = {"cpass": [(1.6, 2.9)], "collect": [(3.6, 3.9)]}
    s = devtrace.summarize(iv, 0.0, 4.0, host)
    assert s["busy_s"] == pytest.approx(2.0)
    assert s["window_s"] == pytest.approx(4.0)
    assert s["device_ops"][0][0] == "k1"
    assert s["device_ops"][0][1] == pytest.approx(1.5)
    assert [g[0] for g in s["idle_gaps"]] == ["cpass", "collect"]
    assert devtrace.summarize(iv, 5.0, 6.0, host) is None


def _fake_out(with_device):
    run = {"window": (0.0, 2.0, 4), "setup_s": 12.5, "fps": 2.0,
           "kbps": 900.0, "psnr_y": 38.0,
           "spans": {"cpass": [(0.1, 1.9)], "collect": [(0.0, 0.1)]},
           "device": ({"busy_s": 0.5, "window_s": 2.0,
                       "device_ops": [["k", 0.5]],
                       "idle_gaps": [["cpass", 1.5]]}
                      if with_device else None)}
    return {"run": run, "correct": True, "attempted": 4, "failed": 0,
            "memory_peak_bytes": 123,
            "checks": {"decode_errors": {"value": 0, "limit": 0}}}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(trace):
    _c, _cfg, _t, e2e, per_layer = cells.load_cell(
        "baseline_1080p.ra_gop16")
    line = report.result_line(_fake_out(True), e2e, per_layer,
                              trace=trace, chips=1, kind="card")
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    want = per_layer if trace else e2e
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in want:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert ("busy_s" in dev) == bool(trace) == ("breakdown" in line)
    json.dumps(line)
    if trace:
        assert line["metrics"]["device.idle_share"]["value"] == 0.75
        assert line["metrics"]["native.cpass_busy_share"]["value"] == \
            pytest.approx(0.9)


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    _c, _cfg, _t, e2e, per_layer = cells.load_cell("baseline_1080p.ai")
    line = report.result_line(_fake_out(False), e2e, per_layer, trace=1,
                              chips=1, kind="card")
    assert "device.idle_share" not in line["metrics"]
    assert "device.busy_ms_per_frame" not in line["metrics"]
    assert "native.cpass_ms_per_frame" in line["metrics"]


def _spec():
    return json.load(open(os.path.join(BENCH, "traffic",
                                       "ra_gop16.json")))["content"]


def _check_periodic(spec):
    """Raise unless every motion of `spec` closes over the clip: the pan's
    travel over the clip is a whole number of each plasma period."""
    n = int(spec["frames"])
    vx, vy = (float(a) for a in spec["pan"])
    px, py, pd, pu, pv = (float(p) for p in spec["periods"])
    for travel, period in ((vx * n, px), (vy * n, py),
                           ((vx + vy) * n, pd), ((vx - vy) * n, pd),
                           (vx * n, pu), (vy * n, pv)):
        q = travel / period
        if abs(q - round(q)) > 1e-9:
            raise ValueError(f"a travel of {travel} px is not a whole "
                             f"number of {period} px periods")


def test_content_is_periodic():
    _check_periodic(_spec())
    spec = dict(_spec(), noise_luma=0.0)
    y = content.make_clip(spec, 480, 272, 11, "cpu", count=65)[0]
    y = y.astype(np.int64)
    n = spec["frames"]
    # without noise, the frame after the period is the first one again
    # (but for f32 rounding at an edge), and the motion is not still
    assert np.abs(y[n] - y[0]).mean() < 0.05
    assert np.abs(y[1] - y[0]).mean() > 10.0
    bad = dict(_spec(), pan=[2.3, 1.125])
    with pytest.raises(ValueError):
        _check_periodic(bad)


def test_seeded_content_is_deterministic_and_differs_across_seeds():
    spec = dict(_spec(), frames=4, chunk=2)
    a = content.make_clip(spec, 96, 64, 2 ** 33 + 7, "cpu")
    b = content.make_clip(spec, 96, 64, 2 ** 33 + 7, "cpu")
    c = content.make_clip(spec, 96, 64, 2 ** 33 + 8, "cpu")
    for x, y in zip(a, b):
        assert x.dtype == np.int16 and np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (4, 64, 96) and a[1].shape == (4, 32, 48)
    assert 0 <= a[0].min() and a[0].max() <= 1023


def test_seeds_change_content_but_not_its_statistics():
    spec = dict(_spec(), frames=2, chunk=2)
    stats = []
    for seed in range(6):
        y = content.make_clip(spec, 480, 272, seed, "cpu")[0]
        stats.append((y.mean(), y.std()))
    m, s = np.array(stats).T
    assert np.ptp(m) / m.mean() < 0.1 and np.ptp(s) / s.mean() < 0.1


def test_the_feed_replays_the_clip():
    clip = tuple(np.arange(3)[:, None, None] + np.zeros((3, 2, 2))
                 for _ in range(3))
    feed = content.frames(clip)
    got = [int(next(feed)[0][0, 0]) for _ in range(7)]
    assert got == [0, 1, 2, 0, 1, 2, 0]
    assert int(content.source_frame(clip, 5)[0][0, 0]) == 2


def test_torch_generator_takes_large_seeds():
    spec = dict(_spec(), frames=1, chunk=1)
    y = content.make_clip(spec, 32, 32, 2 ** 40 + 3, torch.device("cpu"))[0]
    assert y.shape == (1, 32, 32)


def test_the_me_kernels_yardstick():
    from evcbench import roofline
    p = roofline.peaks()
    assert p["int32_ops_per_s"] == p["sms"] * p["int32_lanes_per_sm"] * \
        p["boost_clock_hz"]
    assert roofline.me_full_search_ops(1920, 1088, 16) == 2274877440
    bound = roofline.me_bound_s(1920, 1088, 16, 80)
    assert bound == pytest.approx(2274877440 / p["int32_ops_per_s"])
    assert roofline.me_full_search_bytes(1920, 1088, 16, 80) / \
        p["hbm_bytes_per_s"] < bound / 10
