"""Device activity of the measured window from torch.profiler.

The arithmetic is chip_smoke.py's `_device_profile`: the union of the
CUDA intervals (kernels and copies) is the device's busy time, and the
rest of the window is idle.  A host marker recorded at the window's
opening maps the trace's clock onto the host clock of the benchmark's
spans, so that each idle gap can be labelled with the spans open on the
host during it.
"""
from __future__ import annotations

import time

from . import timeline

MARK = "evcbench.window_open"
NAME_CHARS = 160        # a kernel's name in the breakdown, cut to this


class DeviceTrace:
    """torch.profiler (CPU and CUDA activity) from start() to stop()."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t_mark = None
        self.running = False

    @staticmethod
    def warm(device):
        """One short profile in set-up, so that the profiler's own first
        start (CUPTI) does not land in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1024, device=device).sum().item()

    def start(self):
        from torch.profiler import record_function
        self.prof.start()
        self.running = True
        with record_function(MARK):
            self.t_mark = time.perf_counter()

    def stop(self):
        self.prof.stop()
        self.running = False

    def device_intervals(self):
        """[(start, end, name)] of every device operation, on the host
        clock (perf_counter seconds)."""
        from torch.autograd import DeviceType
        evs = self.prof.events()
        mark = [e for e in evs if e.name == MARK]
        if not mark:
            return []
        base = mark[0].time_range.start
        out = []
        for e in evs:
            if e.device_type == DeviceType.CUDA:
                a = self.t_mark + (e.time_range.start - base) / 1e6
                b = self.t_mark + (e.time_range.end - base) / 1e6
                out.append((a, b, e.name))
        return out


def summarize(intervals, t0, t1, host_spans, top=10):
    """busy seconds, every device op's seconds and launches, the ops that
    took most time, and the longest idle gaps labelled by the host spans
    open at their middle.

    intervals: [(start, end, name)] of device operations; host_spans:
    {label: [(start, end)]}.  `ops` maps each op's full name to [seconds
    inside [t0, t1], launches with a part inside]; `device_ops` lists the
    `top` with most seconds, names cut to NAME_CHARS.  Returns None when
    no device operation ran inside [t0, t1]."""
    iv = timeline.clip([(a, b) for a, b, _ in intervals], t0, t1)
    if not iv:
        return None
    busy = timeline.union(iv)
    ops = {}
    for a, b, name in intervals:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            op = ops.setdefault(name, [0.0, 0])
            op[0] += b - a
            op[1] += 1
    most = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(timeline.gaps(iv, t0, t1), key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        open_ = [lbl for lbl, sp in sorted(host_spans.items())
                 if any(x <= mid <= y for x, y in sp)]
        labelled.append(["+".join(open_) or "none", b - a])
    return {"busy_s": busy, "window_s": t1 - t0, "ops": ops,
            "device_ops": [[n[:NAME_CHARS], s] for n, (s, _k) in most],
            "idle_gaps": labelled}
