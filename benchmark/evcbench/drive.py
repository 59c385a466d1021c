"""One run of one cell: set-up, the measured window, the checks.

The configuration's analysis engine (`engine.analysis`) names the module
benchmark/evcbench/engines/<engine>.py that warms its route, taps its
analysis calls and gives its plain reference (see engines/device.py).
The window drives the port's public streaming entry, `encode_stream` of
the encoder class that the traffic's structure names (`GopEncoder` in
RA, `Encoder` in AI and LD), on an endless feed of the seeded clip.
Set-up ends when the stream's first frame (its I frame) is emitted; the
window opens there and closes on the last emission that completes a
whole unit of the traffic (a sub-GOP in RA, a frame in AI) within
`seconds`.  The run then pulls on, untimed, until the
frames that kbps, PSNR and the decode check need are out and the stream
stands at a unit's end, so that no coding task is left running.

The run record (`run`) holds what the per-layer readers of
benchmark/metrics/ read: the window, the host spans of the calls into the
program by group, with --trace 1 the device's activity (`device`: busy
seconds, every op's seconds and launches) and the port's own spans
(`program`, xeve_tpu_torch.trace), the program's counters gained over the
window (`counters`) and the encoder's parameters (`params`).
"""
from __future__ import annotations

import gc
import os
import resource
import sys
import time

import numpy as np

from . import check, content, devtrace, timeline
from .cell import BENCH_DIR, engine as find_engine, load_limits

PARAMS = ("w_aligned", "h_aligned", "search_range", "min_cu_log2",
          "ref_pics", "bframes", "keyint", "profile")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _encoder(cfg, structure, traffic, device, engine):
    """The encoder of a cell, of the class the traffic's structure names,
    built and warmed by its engine module (set-up)."""
    from xeve_tpu_torch import api
    from xeve_tpu_torch.native.build import get_lib
    from xeve_tpu_torch.params import EncoderParams

    params = EncoderParams(**cfg["params"], **traffic["params"])
    cls = getattr(api, structure.encoder)
    get_lib()                               # the C pass, built at first use
    eng = cfg["engine"]
    enc = cls(params, analysis=eng["analysis"], coder=eng["coder"],
              device=device)
    _log(f"host: os.cpu_count() {os.cpu_count()}, frame workers "
         f"{enc._frame_workers()}, XEVE_TPU_FRAME_WORKERS "
         f"{os.environ.get('XEVE_TPU_FRAME_WORKERS', 'unset')}")
    engine.warm(enc)
    return enc


def _marks(enc):
    """The process's CPU seconds and the program's counters, now."""
    from xeve_tpu_torch.ops import me_cuda
    ru = resource.getrusage(resource.RUSAGE_SELF)
    dev = enc._dev      # the fused analyzer, where the route built one
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "me_cuda.LAUNCHES": me_cuda.LAUNCHES,
            "DeviceAnalyzer.failures": None if dev is None else dev.failures,
            "Encoder.analysis_calls": enc.analysis_calls,
            "GopEncoder.ahead_tasks": enc.ahead_tasks}


def gained(marks, n):
    """Each counter's gain from the window's opening to its close after
    n frames (None where it was not read at both)."""
    a, b = marks[0], marks[n]
    return {k: None if a[k] is None or b[k] is None else b[k] - a[k]
            for k in a if k != "cpu_s"}


def _stream(enc, engine, clip, *, unit, n_keep, seconds, tracer):
    """Drive encode_stream until the window has closed and n_keep frames
    are out, at a unit's end; then stop the encoder's workers.  Returns
    the emissions [(time, bytes, display index)], the first n_keep
    (bitstream, recon), the host spans of the calls into the program by
    group ("cpass" and the engine's taps), the analysis records the taps
    kept, and the marks (_marks) at the first emission and at each unit's
    end."""
    from xeve_tpu_torch import api
    sp = {"cpass": [timeline.Spans(enc, "_code_slice"),
                    timeline.Spans(api, "encode_intra_frame_native")]}
    taps = engine.taps(enc)
    if set(taps) & set(sp):
        raise ValueError(f"an engine's taps may not be named {set(sp)}")
    sp.update(taps)
    emits, kept, marks = [], {}, {}
    wrappers = [x for v in sp.values() for x in v]
    for x in wrappers:
        x.__enter__()
    try:
        stream = enc.encode_stream(content.frames(clip))
        for bs, rec, disp in stream:
            t = time.perf_counter()
            i = len(emits)
            emits.append((t, len(bs), disp))
            if i < n_keep:
                kept[i] = (bs, rec)
            if i % unit == 0:
                marks[i] = _marks(enc)
            if i == 0:
                deadline = t + seconds
                if tracer is not None:
                    tracer.start()
            elif t > deadline and i % unit == 0:
                if tracer is not None and tracer.running:
                    tracer.stop()
                if i >= n_keep - 1:
                    break
        stream.close()
        for pool in engine.pools(enc):
            if pool is not None:
                pool.shutdown(wait=True)
    finally:
        for x in wrappers:
            x.__exit__()
    spans = {k: [iv for x in v for iv in x.spans] for k, v in sp.items()}
    records = [r for x in wrappers for r in x.kept if r is not None]
    return emits, kept, spans, records, marks


def run_cell(cell, cfg, traffic, *, seed, seconds, trace, device, t_proc0,
             limits=None, fault=None, bench_dir=BENCH_DIR):
    """One run; returns the run's numbers and its checks.  fault: a
    callable that breaks the program under the timed path (the harness's
    own tests, and the control).  bench_dir: where the cell's limits and
    engine module are found."""
    import torch
    import xeve_tpu_torch  # noqa: F401  (the program: fail early without it)
    from xeve_tpu_torch import trace as recorder

    dev_t = torch.device(device)
    cuda = dev_t.type == "cuda"
    unit = int(traffic["unit"])
    structure = check.Structure(traffic["structure"])
    n_quality = int(traffic["quality_frames"])
    dec_spec = traffic["decode"]
    limits = limits or load_limits(cell, bench_dir)
    engine = find_engine(cfg["engine"]["analysis"], bench_dir)
    w, h = cfg["params"]["w"], cfg["params"]["h"]
    if trace:       # the profiler's events are read after a shorter window
        seconds = min(seconds, float(traffic["trace_seconds"]))

    clip = content.make_clip(traffic["content"], w, h, seed, dev_t)
    if trace:
        recorder.start()
    try:
        enc = _encoder(cfg, structure, traffic, device, engine)
        params = enc.p
        if fault is not None:
            fault(enc)
        tracer = None
        if trace and cuda:
            devtrace.DeviceTrace.warm(dev_t)
            tracer = devtrace.DeviceTrace()
        if cuda:
            torch.cuda.synchronize(dev_t)
            torch.cuda.reset_peak_memory_stats(dev_t)
        emits, kept, spans, records, marks = _stream(
            enc, engine, clip, unit=unit, seconds=seconds, tracer=tracer,
            n_keep=max(n_quality, int(dec_spec.get("prefix", 0))))
    finally:
        program = recorder.stop() if trace else None
    mem_peak = torch.cuda.max_memory_allocated(dev_t) if cuda else 0
    setup_s = emits[0][0] - t_proc0

    # the window: from the I frame's emission to the last whole unit
    t0, t1, n_win = timeline.window([t for t, _b, _d in emits], unit,
                                    seconds)
    window_disp = {d for _t, _b, d in emits[1:n_win + 1]}
    _log("unit ends (s after the window opened): " + " ".join(
        f"{t - t0:.3f}" for j, (t, _b, _d) in enumerate(emits)
        if j and j % unit == 0 and (unit > 1 or j % 16 == 0)))
    cpu_s = marks[n_win]["cpu_s"] - marks[0]["cpu_s"]   # per-core speed
    _log(f"host: the process ran {cpu_s:.3f} CPU s in the window's "
         f"{t1 - t0:.3f} s ({cpu_s / max(t1 - t0, 1e-9):.3f} cores, "
         f"{cpu_s / max(n_win, 1) * 1e3:.1f} ms a frame)")
    device_summary = None
    if tracer is not None:
        device_summary = devtrace.summarize(
            tracer.device_intervals(), tracer.t_mark, t1, spans)

    # the decoded prefix, where the traffic decodes one: its pictures are
    # the references of an engine that analyses against reconstructions
    rng = np.random.default_rng(int(seed) % (1 << 63))
    idx = frames = None
    decoded = {}
    if "prefix" in dec_spec:
        idx = list(range(min(int(dec_spec["prefix"]), len(emits))))
        frames = check.decode([kept[i][0] for i in idx])
        decoded = {emits[i][2]: (f.y, f.u, f.v)
                   for i, f in zip(idx, frames or [])}
    elif structure.order != "ai":
        raise ValueError("a decode sample needs all-intra frames")

    # the sample the analyzer check takes; then the program's state goes
    closed = engine.REFERENCES == "decoded"
    pool = [r for r in sorted(records, key=lambda r: r["poc"])
            if r["poc"] in window_disp and r["result"] is not None
            and not (closed and any(
                i is not None and i not in decoded
                for i in structure.frame(r["poc"])[2].values()))]
    want = int(traffic["analyzer_frames"])
    pick = rng.choice(len(pool), min(want, len(pool)), replace=False)
    an_samples = [pool[int(j)] for j in sorted(pick)]
    kinds = {"I": 0, "P": 0, "B": 0}
    for r in records:
        kinds["I" if r["l0"] is None else "P" if r["l1"] is None
              else "B"] += 1
    bd, iqt = params.codec_bit_depth, int(params.tool_iqt)
    dispatch_errors = check.dispatch_errors(records, params.qp, bd, iqt,
                                            structure)
    counters = gained(marks, n_win)
    del enc, fault, records, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    def src(disp):
        return check.pad_frame(*content.source_frame(clip, disp), w, h)

    quality = []
    for i in range(min(n_quality, len(emits))):
        bs, rec = kept[i]
        y = src(emits[i][2])[0][:h, :w].astype(np.int64)
        r = np.asarray(rec[0])[:h, :w].astype(np.int64)
        quality.append((len(bs), int(((y - r) ** 2).sum())))
    kbps, psnr_y = timeline.quality(quality, w, h)
    frame_psnr = [timeline.quality([q], w, h)[1] for q in quality]

    if idx is None:         # a sample of independent (intra) frames
        cand = [i for i in kept if 0 < i < n_quality]
        idx = [0] + sorted(int(i) for i in rng.choice(
            cand, min(int(dec_spec["sample"]), len(cand)), replace=False))
        frames = check.decode([kept[i][0] for i in idx])
    run_params = {k: getattr(params, k) for k in PARAMS}
    run_params["engine"] = cfg["engine"]["analysis"]
    mv_off, decisions_off = check.analyzer_readings(
        an_samples, src, decoded.get if closed else src, params.qp, bd, iqt,
        structure, engine.reference, want=want, device=dev_t,
        params=run_params)
    readings = {
        "order_errors": sum(
            1 for (_t, _b, d), want_d in zip(
                emits, check.expected_order(len(emits), structure))
            if d != want_d),
        "dispatch_errors": dispatch_errors,
        "decode_errors": check.decode_errors(frames,
                                             [kept[i][1] for i in idx]),
        "far_frames": sum(1 for p in frame_psnr
                          if p < limits["psnr_floor_db"]),
        "mv_off": mv_off, "decisions_off": decisions_off}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    run = {"window": (t0, t1, n_win), "spans": spans,
           "device": device_summary, "program": program,
           "counters": counters, "params": run_params, "setup_s": setup_s,
           "fps": n_win / (t1 - t0) if t1 > t0 else None,
           "kbps": kbps, "psnr_y": psnr_y}
    failed = sum(readings[k] for k in ("order_errors", "dispatch_errors",
                                       "decode_errors", "far_frames"))
    return {"run": run, "checks": checks,
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": n_win, "failed": failed,
            "memory_peak_bytes": int(mem_peak),
            "checked": {"decoded": len(idx), "analyzed": len(an_samples),
                        "analysis_records": kinds,
                        "min_frame_psnr_y": min(frame_psnr)}}
