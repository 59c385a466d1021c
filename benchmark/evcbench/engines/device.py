"""The route of analysis="device": the fused device analyzer
(enc/device_analyzer.DeviceAnalyzer, behind Encoder._device()), whose
dispatches are analysed against the original frames.

An engine module gives the harness (evcbench/drive.py, evcbench/check.py):

  REFERENCES  "source" where the route's analyses reference the original
              frames, "decoded" where they reference reconstructions
  warm(enc)   set-up's warm-up of the route, once per shape it will run
  taps(enc)   {label: [timeline.Spans]} around the route's analysis calls;
              what they keep are analysis records (check.record), one per
              analysed frame, the result set once the program has it
  pools(enc)  the worker pools to shut down after the stream
  reference(src, refs, q, qps, *, bd, device, params)
              the plain reference analysis of one frame in float64: src
              its padded (y, u, v), refs {"l0"|"l1"|"l0b"|"l1b": (y, u, v)},
              the slice qp q and (qp_y, qp_u, qp_v) qps, params the run's
              `params`; returns {key: {lg: map}} of the keys that
              check.decisions compares
"""
import numpy as np
import torch

from evcbench import check, timeline
from evcbench.reference import fused

REFERENCES = "source"


def warm(enc):
    """Each dispatch signature the parameters will use (I; P unless all
    intra; P with a second reference where ref_pics > 1; B where bframes
    >= 15, likewise), run once on dummy frames and read back, the dummy
    frames then evicted: the device branch of Encoder.prewarm.
    Encoder.prewarm itself would, on Main, warm the "jax" engine's
    analyses, which this route never runs.  Main's all-intra route runs
    the EIPD analysis: Encoder.prewarm warms that."""
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


def taps(enc):
    """A record at each dispatch, from the handle's arguments; its result
    at the collect of that handle (a _Handle or a dispatch_bg Future)."""
    dev = enc._device()
    by_seq = {}

    def dispatched(hd, _a, _k):
        poc, qp, qp_y, qp_u, qp_v, r0, r1, r0b, r1b, _refine = hd.args
        rec = by_seq[hd.seq] = check.record(poc, qp, (qp_y, qp_u, qp_v),
                                            l0=r0, l1=r1, l0b=r0b, l1b=r1b)
        return rec

    def collected(out, a, _k):
        hd = a[0].result() if hasattr(a[0], "result") else a[0]
        rec = by_seq.get(hd.seq)
        if rec is not None:
            rec["result"] = out

    return {"collect": [timeline.Spans(dev, "collect", keep=collected)],
            "dispatch": [timeline.Spans(dev, "dispatch", keep=dispatched)]}


def pools(enc):
    return enc._code_pool, enc._device()._pool


def reference(src, refs, q, qps, *, bd, device, params):
    """The frozen fused analysis graph (reference/fused.py) in float64."""
    return fused.analyze(src, refs, q, *qps, bd=bd, dtype=torch.float64,
                         device=device)
