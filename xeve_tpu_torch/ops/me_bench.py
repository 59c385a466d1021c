"""Time the full-search ME kernel against its plain version, and against
other builds of the same C entry point, on one CUDA card.

    python -m xeve_tpu_torch.ops.me_bench [--against OTHER.cu ...]
        [--reps 20] [--rounds 2] [--out DIR]

Every source (the port's csrc/me_full_search.cu first, then each
--against file, for example an earlier revision of it) is compiled with
nvcc for sm_90a with ptxas's report, checked identical to
enc/me_torch.integer_me_plain at 1920x1088 for R = 16 on a random and a
shifted pair, and timed with CUDA events over --reps launches, in turns
(A B .. B A) for --rounds rounds.  The SM clock is read with nvidia-smi
right after the timing, and sampled again (with the power draw) while
each build runs back to back for a second.  With --out, each build's SASS and opcode counts
are written there.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import threading

import numpy as np
import torch

from ..enc.me_torch import BLK, integer_me_plain
from . import _build
from .mc_np import pad_picture

W, H, PAD, R = 1920, 1088, 80, 16
SMS, INT32_LANES = 132, 64          # H100 SXM: SMs, INT32 lanes per SM


def bound_ms(nby: int, nbx: int, r: int, mhz: float) -> float:
    """Least time for the abs-diff-adds of one launch: one INT32 lane-op
    each (__sad), at SMS x INT32_LANES per clock."""
    ops = nby * nbx * (2 * r + 1) ** 2 * BLK * BLK
    return ops / (SMS * INT32_LANES * mhz * 1e6) * 1e3


def sm_clocks() -> tuple[float, float]:
    """(current, max) SM clock in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    cur, mx = out.strip().splitlines()[0].split(",")
    return float(cur), float(mx)


def sm_clock_under_load(launch, ms_per_launch: float, seconds: float = 1.0):
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reads while
    `launch` runs back to back for about `seconds` on the card."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                                  "power.draw", "--format=csv,noheader,"
                                  "nounits"], capture_output=True, text=True)
            if not stop.is_set() and out.returncode == 0:
                samples.append([float(x) for x in
                                out.stdout.strip().splitlines()[0].split(",")])

    launch()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    for _ in range(max(1, int(seconds * 1e3 / ms_per_launch))):
        launch()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    if not samples:
        raise RuntimeError("nvidia-smi gave no sample under load")
    clk, watts = np.median(np.asarray(samples), axis=0)
    return float(clk), float(watts), len(samples)


def _pairs():
    rng = np.random.default_rng(2024)
    ref = rng.integers(0, 1024, (H, W)).astype(np.int32)
    cur = rng.integers(0, 1024, (H, W)).astype(np.int32)
    # smooth content shifted by (dx, dy) = (-11, 7), with noise
    k = np.ones(9) / 9.0
    sm = rng.integers(0, 1024, (H, W)).astype(np.float64)
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, sm)
    sm = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, sm)
    sm = sm.astype(np.int32)
    shifted = np.clip(np.roll(sm, (-7, 11), axis=(0, 1))
                      + rng.integers(-3, 4, (H, W)), 0, 1023).astype(np.int32)
    return [("random", cur, ref), ("shifted", shifted, sm)]


def _entry(path: str):
    fn = ctypes.CDLL(path).xt_me_full_search
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, c, r, mv, cost):
    err = fn(c.data_ptr(), r.data_ptr(), mv.data_ptr(), cost.data_ptr(),
             H, W, PAD, R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_full_search launch failed: cudaError {err}")


def _diff(cur, refp, mv, cost, mv0, cost0) -> str:
    """The blocks where a build and the plain version differ, each with
    the cost of both MVs recomputed on the host."""
    mv, cost, mv0, cost0 = (t.cpu().numpy() for t in (mv, cost, mv0, cost0))
    ys, xs = np.nonzero((mv != mv0).any(-1) | (cost != cost0))

    def true_cost(by, bx, dx, dy):
        y, x = by * BLK, bx * BLK
        blk = cur[y:y + BLK, x:x + BLK].astype(np.int64)
        cand = refp[PAD + y + dy:PAD + y + dy + BLK,
                    PAD + x + dx:PAD + x + dx + BLK]
        return int(np.abs(blk - cand).sum()) + abs(dx) + abs(dy)

    rows = [f"({by},{bx}) kernel mv {tuple(mv[by, bx])} cost {cost[by, bx]}"
            f" [host {true_cost(by, bx, *mv[by, bx])}], plain mv "
            f"{tuple(mv0[by, bx])} cost {cost0[by, bx]} [host "
            f"{true_cost(by, bx, *mv0[by, bx])}]"
            for by, bx in list(zip(ys, xs))[:8]]
    return f"{len(ys)} blocks; " + "; ".join(rows)


def _opcodes(sass: str) -> dict:
    ops = collections.Counter(
        m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                        r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)",
                                        sass))
    return dict(ops.most_common(25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("me_bench: torch finds no CUDA device")
        return 1
    srcs = [os.path.join(_build.CSRC, "me_full_search.cu"), *a.against]
    tags = ["port"] + [f"against{i}" for i in range(len(a.against))]
    fns, report = {}, {}
    for tag, src in zip(tags, srcs):
        so = os.path.join(_build.BUILD_DIR, "bench", f"libme_{tag}.so")
        info = _build.compile_cu(src, so, ["-Xptxas", "-v"])
        regs = re.findall(r"Used (\d+) registers", info)
        report[tag] = {"source": os.path.relpath(src), "ptxas": regs}
        print(f"{tag}: {src}: ptxas registers {regs}", flush=True)
        if a.out:
            os.makedirs(a.out, exist_ok=True)
            cuobj = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
            sass = subprocess.run([cuobj, "-sass", so], check=True,
                                  capture_output=True, text=True).stdout
            with open(os.path.join(a.out, f"me_{tag}.sass"), "w") as f:
                f.write(info + "\n" + sass)
            report[tag]["opcodes"] = _opcodes(sass)
            print(f"{tag} opcodes: {report[tag]['opcodes']}", flush=True)
        fns[tag] = _entry(so)

    nby, nbx = H // BLK, W // BLK
    mv = torch.empty((nby, nbx, 2), dtype=torch.int32, device="cuda")
    cost = torch.empty((nby, nbx), dtype=torch.int32, device="cuda")
    bad = []
    for name, cur, ref in _pairs():
        # the entry point takes contiguous planes (the wrapper's job)
        refp = np.ascontiguousarray(pad_picture(ref, PAD))
        c = torch.as_tensor(np.ascontiguousarray(cur), device="cuda")
        r = torch.as_tensor(refp, device="cuda")
        mv0, cost0 = integer_me_plain(c, r, R, PAD)
        for tag, fn in fns.items():
            _launch(fn, c, r, mv, cost)
            torch.cuda.synchronize()
            if torch.equal(mv, mv0) and torch.equal(cost, cost0):
                continue
            bad.append(f"{tag}/{name}")
            print(f"{tag}: {name} pair differs from the plain version: "
                  + _diff(cur, refp, mv, cost, mv0, cost0), flush=True)
        print(f"{name} pair checked", flush=True)

    times = {tag: [] for tag in fns}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for _ in range(a.rounds):
        for tag in tags + tags[::-1]:
            _launch(fns[tag], c, r, mv, cost)
            e0.record()
            for _ in range(a.reps):
                _launch(fns[tag], c, r, mv, cost)
            e1.record()
            torch.cuda.synchronize()
            times[tag].append(e0.elapsed_time(e1) / a.reps)
    clk, clk_max = sm_clocks()
    load = {tag: sm_clock_under_load(
        lambda: _launch(fns[tag], c, r, mv, cost), min(times[tag]))
        for tag in tags}
    plain_ms = []
    integer_me_plain(c, r, R, PAD)          # warm
    for _ in range(2):
        e0.record()
        integer_me_plain(c, r, R, PAD)
        e1.record()
        torch.cuda.synchronize()
        plain_ms.append(e0.elapsed_time(e1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    report["mismatches"] = bad
    for tag in tags:
        report[tag]["ms"] = times[tag]
        report[tag]["ms_median"] = float(np.median(times[tag]))
        lclk, watts, n = load[tag]
        report[tag].update(load_sm_clock_mhz=lclk, load_power_w=watts,
                           bound_ms_at_load_clock=bound_ms(nby, nbx, R, lclk))
        print(f"{tag}: {report[tag]['ms_median']:.4f} ms median of "
              f"{times[tag]}; under load (median of {n} samples) SM clock "
              f"{lclk:.0f} MHz, {watts:.1f} W, bound "
              f"{bound_ms(nby, nbx, R, lclk):.4f} ms at that clock",
              flush=True)
    print(json.dumps({
        "card": smi, "shape": [H, W], "R": R, "reps": a.reps,
        "sm_clock_mhz": clk, "sm_clock_max_mhz": clk_max,
        "bound_ms_at_clock": bound_ms(nby, nbx, R, clk),
        "bound_ms_at_max": bound_ms(nby, nbx, R, clk_max),
        "plain_ms": plain_ms, "builds": report}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
