"""Host-clock spans around calls into the program, and the arithmetic of
intervals, the measured window and the coded frames.

`Spans` and `union` are copies of chip_smoke.py's `_Spans` and the union
of `_c_pass_share`.
"""
from __future__ import annotations

import math
import time


class Spans:
    """Host-clock intervals of every call of obj.name while in use, from
    whatever thread makes the call.  `keep(result, args)` may keep
    something of each call (the captured values go to `kept`)."""

    def __init__(self, obj, name, keep=None):
        self.obj, self.name, self.keep = obj, name, keep
        self.spans, self.kept = [], []

    def __enter__(self):
        fn = self.real = getattr(self.obj, self.name)

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                out = fn(*a, **k)
            finally:
                self.spans.append((t, time.perf_counter()))
            if self.keep is not None:
                self.kept.append(self.keep(out, a, k))
            return out

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def clip(spans, t0, t1):
    """The parts of `spans` inside [t0, t1]."""
    out = []
    for a, b in spans:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((a, b))
    return out


def union(spans) -> float:
    """Length of the union of intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def total(spans) -> float:
    return sum(b - a for a, b in spans)


def gaps(spans, t0, t1):
    """The holes of the union of `spans` inside [t0, t1], as (start,
    end)."""
    out, cur = [], t0
    for a, b in sorted(clip(spans, t0, t1)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


def window(emit_times, unit, seconds):
    """The measured window over a run's frame emissions.

    emit_times: host time of each emitted frame, in order; the first
    emission closes set-up and opens the window.  The window closes on
    the last emission that ends a whole unit of `unit` frames at or
    before emit_times[0] + seconds (on the first unit's end where none
    does).  Returns (t0, t1, n): its edges and the frames emitted in
    (t0, t1], a whole number of units."""
    t0 = emit_times[0]
    ends = [(j, t) for j, t in enumerate(emit_times) if j and j % unit == 0]
    if not ends:
        raise ValueError("no whole unit was emitted")
    inside = [e for e in ends if e[1] <= t0 + seconds]
    j, t1 = (inside or ends)[-1 if inside else 0]
    return t0, t1, j


def ra_coding_order(n_subgops: int, gop: int = 16):
    """Display indices of an RA stream of sub-GOPs of `gop` frames in
    coding order: the I frame, then per sub-GOP its anchor and the
    hierarchy, each level in display order.  Each entry is (display
    index, temporal id)."""
    out = [(0, 0)]
    for k in range(n_subgops):
        base = gop * k
        out.append((base + gop, 0))
        step, tid = gop // 2, 1
        while step:
            out += [(base + p, tid) for p in range(step, gop, 2 * step)]
            step, tid = step // 2, tid + 1
    return out


def quality(frames, w, h, fps=30.0, bd=10):
    """(kbps at `fps`, mean luma PSNR in dB) of coded frames, each a
    (bytes, luma sse) pair, over a w x h picture."""
    n = len(frames)
    bits = 8 * sum(nb for nb, _ in frames)
    peak = float((1 << bd) - 1) ** 2
    ps = [99.0 if sse == 0 else 10.0 * math.log10(peak * w * h / sse)
          for _, sse in frames]
    return bits * fps / n / 1000.0, sum(ps) / n
