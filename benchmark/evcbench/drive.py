"""One run of one cell: set-up, the measured window, the checks.

The window drives the port's public streaming entry, `encode_stream` of
the encoder class that the traffic's structure names (`GopEncoder` in
RA, `Encoder` in AI and LD), on an endless feed of the seeded clip.
Set-up ends when the stream's first frame (its I frame) is emitted; the
window opens there and closes on the last emission that completes a
whole unit of the traffic (a sub-GOP in RA, a frame in AI) within
`seconds`.  The run then pulls on, untimed, until the
frames that kbps, PSNR and the decode check need are out and the stream
stands at a unit's end, so that no coding task is left running.
"""
from __future__ import annotations

import gc
import os
import resource
import sys
import time

import numpy as np

from . import check, content, devtrace, timeline
from .cell import load_limits


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def warm(enc):
    """Set-up's warm-up of the route the cell runs, once per shape.

    On the fused device analyzer (every route of analysis="device" but
    Main's all-intra one) it does what the device branch of
    Encoder.prewarm does: each dispatch signature the parameters will use
    (I; P unless all intra; P with a second reference where ref_pics > 1;
    B where bframes >= 15, likewise), run once on dummy frames and read
    back, the dummy frames then evicted.  Encoder.prewarm itself would, on
    Main, warm the "jax" engine's analyses, which this route never runs.
    Main's all-intra route runs the EIPD analysis: Encoder.prewarm warms
    that."""
    p = enc.p
    if p.tool_eipd and p.keyint == 1:
        enc.prewarm()
        return
    dev = enc._device()
    z = np.zeros((p.h_aligned, p.w_aligned), np.int16)
    zc = np.zeros((p.h_aligned // 2, p.w_aligned // 2), np.int16)
    base = -(1 << 20)
    for i in range(3):
        dev.put_frame(base + i, z, zc, zc)
    sigs = [{}]
    if p.keyint != 1:
        sigs.append({"ref_poc": base})
        if p.ref_pics > 1:
            sigs.append({"ref_poc": base, "ref0b_poc": base + 1})
    if p.bframes >= 15:
        sigs.append({"ref_poc": base, "ref1_poc": base + 1})
        if p.ref_pics > 1:
            sigs.append({"ref_poc": base, "ref1_poc": base + 1,
                         "ref0b_poc": base + 2, "ref1b_poc": base + 2})
    qps = enc._qp_triplet(p.qp)
    for sig in sigs:
        dev.collect(dev.dispatch(base + 2, p.qp, *qps, **sig))
    for i in range(3):
        dev.ring.pop(base + i, None)
        dev.host_ring.pop(base + i, None)


def _encoder(cfg, structure, traffic, device):
    """The encoder of a cell, of the class the traffic's structure names,
    built and warmed (set-up)."""
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
    warm(enc)
    return enc


def _poc_of(hd):
    """Display index of a dispatch handle (or of its future)."""
    return (hd.result() if hasattr(hd, "result") else hd).args[0]


def _stream(enc, clip, *, unit, n_keep, seconds, tracer):
    """Drive encode_stream until the window has closed and n_keep frames
    are out, at a unit's end; then stop the encoder's workers.  Returns
    the emissions [(time, bytes, display index)], the first n_keep
    (bitstream, recon), the spans and captures of the calls into the
    program, and the process's CPU seconds at the first emission and at
    each unit's end."""
    from xeve_tpu_torch import api
    dev = enc._device()
    sp = {"cpass": [timeline.Spans(enc, "_code_slice"),
                    timeline.Spans(api, "encode_intra_frame_native")],
          "collect": [timeline.Spans(
              dev, "collect", keep=lambda out, a, k: (_poc_of(a[0]), out))],
          "dispatch": [timeline.Spans(dev, "dispatch",
                                      keep=lambda out, a, k: (a, k))]}
    emits, kept, usage = [], {}, {}
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
                ru = resource.getrusage(resource.RUSAGE_SELF)
                usage[i] = ru.ru_utime + ru.ru_stime
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
        for pool in (enc._code_pool, dev._pool):
            if pool is not None:
                pool.shutdown(wait=True)
    finally:
        for x in wrappers:
            x.__exit__()
    spans = {k: [iv for x in v for iv in x.spans] for k, v in sp.items()}
    return (emits, kept, spans, sp["collect"][0].kept,
            sp["dispatch"][0].kept, usage)


def run_cell(cell, cfg, traffic, *, seed, seconds, trace, device, t_proc0,
             limits=None, fault=None):
    """One run; returns the run's numbers and its checks.  fault: a
    callable that breaks the program under the timed path (the harness's
    own tests, and the control)."""
    import torch
    import xeve_tpu_torch  # noqa: F401  (the program: fail early without it)

    dev_t = torch.device(device)
    cuda = dev_t.type == "cuda"
    unit = int(traffic["unit"])
    structure = check.Structure(traffic["structure"])
    n_quality = int(traffic["quality_frames"])
    dec_spec = traffic["decode"]
    limits = limits or load_limits(cell)
    w, h = cfg["params"]["w"], cfg["params"]["h"]
    if trace:       # the profiler's events are read after a shorter window
        seconds = min(seconds, float(traffic["trace_seconds"]))

    clip = content.make_clip(traffic["content"], w, h, seed, dev_t)
    enc = _encoder(cfg, structure, traffic, device)
    params = enc.p
    if fault is not None:
        fault(enc)
    tracer = None
    if trace:
        devtrace.DeviceTrace.warm(dev_t)
        tracer = devtrace.DeviceTrace()
    if cuda:
        torch.cuda.synchronize(dev_t)
        torch.cuda.reset_peak_memory_stats(dev_t)
    emits, kept, spans, collected, dispatched, usage = _stream(
        enc, clip, unit=unit, seconds=seconds, tracer=tracer,
        n_keep=max(n_quality, int(dec_spec.get("prefix", 0))))
    mem_peak = torch.cuda.max_memory_allocated(dev_t) if cuda else 0
    setup_s = emits[0][0] - t_proc0

    # the window: from the I frame's emission to the last whole unit
    t0, t1, n_win = timeline.window([t for t, _b, _d in emits], unit,
                                    seconds)
    window_disp = {d for _t, _b, d in emits[1:n_win + 1]}
    _log("unit ends (s after the window opened): " + " ".join(
        f"{t - t0:.3f}" for j, (t, _b, _d) in enumerate(emits)
        if j and j % unit == 0 and (unit > 1 or j % 16 == 0)))
    cpu_s = usage[n_win] - usage[0]     # per-core speed shows here
    _log(f"host: the process ran {cpu_s:.3f} CPU s in the window's "
         f"{t1 - t0:.3f} s ({cpu_s / max(t1 - t0, 1e-9):.3f} cores, "
         f"{cpu_s / max(n_win, 1) * 1e3:.1f} ms a frame)")
    device_summary = None
    if tracer is not None:
        device_summary = devtrace.summarize(
            tracer.device_intervals(), tracer.t_mark, t1,
            {k: spans[k] for k in ("cpass", "collect")})

    # the sample the analyzer check takes; then the program's state goes
    q_of = {a[0]: a[1] for a, _k in dispatched}
    in_window = [(poc, q_of.get(poc), res) for poc, res in collected
                 if poc in window_disp]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(len(in_window),
                      min(int(traffic["analyzer_frames"]), len(in_window)),
                      replace=False)
    an_samples = [in_window[int(j)] for j in sorted(pick)]
    del enc, fault, collected, in_window
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

    if "prefix" in dec_spec:
        idx = list(range(min(int(dec_spec["prefix"]), len(emits))))
    else:                   # a sample of independent (intra) frames
        if structure.order != "ai":
            raise ValueError("a decode sample needs all-intra frames")
        cand = [i for i in kept if 0 < i < n_quality]
        idx = [0] + sorted(int(i) for i in rng.choice(
            cand, min(int(dec_spec["sample"]), len(cand)), replace=False))
    bd, iqt = params.codec_bit_depth, int(params.tool_iqt)
    mv_off, decisions_off = check.analyzer_readings(
        an_samples, src, params.qp, bd, iqt, structure, dev_t)
    readings = {
        "order_errors": sum(
            1 for (_t, _b, d), want in zip(
                emits, check.expected_order(len(emits), structure))
            if d != want),
        "dispatch_errors": check.dispatch_errors(dispatched, params.qp, bd,
                                                 iqt, structure),
        "decode_errors": check.decode_errors([kept[i][0] for i in idx],
                                             [kept[i][1] for i in idx]),
        "far_frames": sum(1 for p in frame_psnr
                          if p < limits["psnr_floor_db"]),
        "mv_off": mv_off, "decisions_off": decisions_off}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    run = {"window": (t0, t1, n_win), "spans": spans,
           "device": device_summary, "setup_s": setup_s,
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
                        "min_frame_psnr_y": min(frame_psnr)}}
