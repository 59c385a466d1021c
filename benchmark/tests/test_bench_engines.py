"""The analysis engine as a plug-in of the harness, on the CPU: a cell
finds its route's module under evcbench/engines/ by the configuration's
`engine.analysis`, a cell whose engine has none does not run, and an
analysis sample that comes out empty fails `correct`."""
import copy
import json
import os
import shutil
import subprocess
import sys
import time

from conftest import BENCH, ROOT
from evcbench import cell as cells
from evcbench.drive import run_cell

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

# The "jax" engine's route, written as a later change would add it: its
# analyses run per frame in the calling thread against the DPB's
# reconstructions, so the harness gives the reference the frozen
# decoder's pictures.  The port's numpy engine stands in for its plain
# reference here.
JAX_ENGINE = '''
import numpy as np

from evcbench import check, timeline

REFERENCES = "decoded"


def warm(enc):
    enc.prewarm()


def taps(enc):
    made = []

    def keep(rec, out):
        rec["result"] = out
        made.append(rec)
        return rec

    def intra(out, a, _k):
        return keep(check.record(None, a[3], enc._qp_triplet(a[3])), out)

    def inter(out, a, k):
        refp, qp, qps = a[3], a[4], a[5:8]
        refp1 = k.get("refp1") or []
        pocs = [r["poc"] for r in refp] + [None]
        pocs1 = [r["poc"] for r in refp1] + [None, None]
        return keep(check.record(None, qp, qps, l0=pocs[0], l0b=pocs[1],
                                 l1=pocs1[0], l1b=pocs1[1]), out)

    def frame(_out, a, _k):
        made[-1]["poc"] = a[0]      # the frame's analysis, just made

    return {"analysis": [timeline.Spans(enc, "_analyze_intra", keep=intra),
                         timeline.Spans(enc, "_analyze_inter", keep=inter)],
            "frame": [timeline.Spans(enc, "_encode_ra_frame", keep=frame)]}


def pools(enc):
    return (enc._code_pool,)


def reference(src, refs, q, qps, *, bd, device, params):
    from xeve_tpu_torch.enc.analysis_inter_np import analyze_frame_inter
    from xeve_tpu_torch.enc.analysis_np import analyze_frame
    from xeve_tpu_torch.ops import mc_np

    def i32(a):
        return np.asarray(a, np.int32)

    def pic(k):
        y, u, v = refs[k]
        return {"poc": k, "y_pad": mc_np.pad_picture(i32(y), 80),
                "u_pad": mc_np.pad_picture(i32(u), 40),
                "v_pad": mc_np.pad_picture(i32(v), 40)}

    y, u, v = (i32(a) for a in src)
    if not refs:
        res = analyze_frame(y, u, v, q, *qps, bd,
                            min_log2=params["min_cu_log2"])
    else:
        res = analyze_frame_inter(
            y, u, v, [pic(k) for k in ("l0", "l0b") if k in refs], q, *qps,
            bd, search_range=params["search_range"],
            refp1=[pic(k) for k in ("l1", "l1b") if k in refs] or None,
            min_log2=params["min_cu_log2"])
    return {k: getattr(res, k) for k in ("mode", "split", "mv", "mv1",
                                         "mv0b", "mv1b")
            if getattr(res, k, None) is not None}
'''


def _checkout(tmp_path):
    """BENCHMARK.json and a copy of benchmark/ under tmp_path."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return bench


def test_a_new_engine_is_taken_up_without_an_edit(tmp_path):
    """A configuration on analysis="jax", its engine module and a cell
    added as files and entries: the cell runs through run_cell on the
    CPU, keeps records of its I and B frames, checks its sample against
    the module's reference on the decoded reconstructions, and comes out
    correct."""
    bench = _checkout(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][1], name="tiny_jax"))
    name = "tiny_jax.ra_gop16"
    spec["workloads"].append({"name": name, "config": "tiny_jax",
                              "traffic": "ra_gop16", "chips": 1, "why": "t"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = json.load(open(bench / "configs" / "main_1080p.json"))
    cfg["params"].update(w=128, h=128)
    cfg["engine"]["analysis"] = "jax"
    (bench / "configs" / "tiny_jax.json").write_text(json.dumps(cfg))
    (bench / "evcbench" / "engines" / "jax.py").write_text(JAX_ENGINE)
    limits = json.load(open(bench / "limits" / "default.json"))
    # the numpy engine's splits differ from the torch engine's by float
    # order (PERF.md section 2): a stand-in's limit, not a cell's
    limits["decisions_off"] = 0.02
    (bench / "limits" / (name + ".json")).write_text(json.dumps(limits))

    _c, cfg, traffic, _e, _p = cells.load_cell(
        name, root=str(tmp_path), bench_dir=str(bench))
    assert cells.engine("jax", bench_dir=str(bench)).REFERENCES == "decoded"
    out = run_cell(name, cfg, traffic, seed=2 ** 33 + 11, seconds=1.0,
                   trace=False, device="cpu", t_proc0=time.perf_counter(),
                   bench_dir=str(bench))
    assert out["correct"], out["checks"]
    kinds = out["checked"]["analysis_records"]
    assert kinds["I"] >= 1 and kinds["B"] >= 15, kinds
    assert out["checked"]["analyzed"] == traffic["analyzer_frames"]
    assert out["checks"]["mv_off"]["value"] == 0
    counters = out["run"]["counters"]
    assert counters["Encoder.analysis_calls"] == out["run"]["window"][2]
    assert counters["DeviceAnalyzer.failures"] is None
    assert out["run"]["params"]["engine"] == "jax"


def test_a_cell_whose_engine_has_no_module_does_not_run(tmp_path):
    bench = _checkout(tmp_path)
    cfg = json.load(open(bench / "configs" / "main_1080p.json"))
    cfg["engine"]["analysis"] = "jax"
    (bench / "configs" / "main_1080p.json").write_text(json.dumps(cfg))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "main_1080p.ra_gop16", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no engine module" in p.stderr and "'jax'" in p.stderr


# the device engine's route with taps that miss every analysis call
BLIND = '''
from evcbench import cell

_real = cell.engine("device")
REFERENCES = _real.REFERENCES
warm, pools, reference = _real.warm, _real.pools, _real.reference


def taps(enc):
    return {}
'''


def test_an_empty_analysis_sample_fails_correct(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(BENCH, "limits"), bench / "limits")
    (bench / "evcbench" / "engines").mkdir(parents=True)
    (bench / "evcbench" / "engines" / "device.py").write_text(BLIND)
    name = "baseline_1080p.ai"
    _c, cfg, traffic, _e, _p = cells.load_cell(name)
    cfg = copy.deepcopy(cfg)
    cfg["params"].update(w=128, h=64)
    out = run_cell(name, cfg, traffic, seed=2 ** 33 + 13, seconds=1.0,
                   trace=False, device="cpu", t_proc0=time.perf_counter(),
                   bench_dir=str(bench))
    assert out["checked"]["analyzed"] == 0
    assert out["checks"]["mv_off"]["value"] == traffic["analyzer_frames"]
    assert not out["correct"]
    # the same run with the benchmark's own engine module samples frames
    sound = run_cell(name, cfg, traffic, seed=2 ** 33 + 13, seconds=1.0,
                     trace=False, device="cpu", t_proc0=time.perf_counter())
    assert sound["correct"], sound["checks"]
    assert sound["checked"]["analyzed"] == traffic["analyzer_frames"]
