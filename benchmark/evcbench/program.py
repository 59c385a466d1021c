"""Per-layer readings from the program's own spans (xeve_tpu_torch.trace).

A run whose recorder was started before its encoder was built gives
`records` (trace.stop()'s list of dicts: name, thread, t0, t1, cpu, id,
parent, attrs).  `readings(records, window, recoveries)` turns them into
one number per reading below, named as a per-layer metric would be, over
the measured window (t0, t1, n): spans are clipped to the window and
summed, a CPU share takes the spans that lie wholly inside it, and a
reading per event (a task's wait for a worker, a readback's place in the
queue) takes the events that start inside it.  A reading with nothing to
read is left out.  `label_gaps` names, for the device's longest idle
gaps, the innermost program span open on the main thread and on the
analyzer's dispatcher thread.  The spans are on the host clock that
timeline.Spans and devtrace.DeviceTrace use (time.perf_counter).
"""
from __future__ import annotations

import statistics

from . import timeline

MAIN = "MainThread"
DISPATCHER = "xt-dispatch"      # DeviceAnalyzer's single dispatcher thread
# children of a frame worker's task that are not its own Python work
TASK_WAITS = ("native.ccall", "device_analyzer.queue",
              "device_analyzer.readback")


def _named(records, name, thread=None):
    return [r for r in records if r["name"] == name
            and (thread is None or r["thread"] == thread)]


def _clipped_s(spans, t0, t1):
    return timeline.total(timeline.clip([(r["t0"], r["t1"]) for r in spans],
                                        t0, t1))


def _under(records, spans, ancestor):
    """The spans of `spans` that have a span named `ancestor` above them."""
    by_id = {r["id"]: r for r in records}

    def has(r):
        p = by_id.get(r["parent"])
        while p is not None:
            if p["name"] == ancestor:
                return True
            p = by_id.get(p["parent"])
        return False
    return [r for r in spans if has(r)]


def _per_frame_ms(spans, window):
    t0, t1, n = window
    if not spans or not n:
        return None
    return _clipped_s(spans, t0, t1) * 1000.0 / n


def _longest_chain(by_poc):
    """Seconds of the longest chain of tasks along their `deps` (the
    deps inside this sub-GOP)."""
    chain = {}

    def longest(p):
        if p not in chain:
            r = by_poc[p]
            chain[p] = r["t1"] - r["t0"] + max(
                [longest(d) for d in r["attrs"]["deps"] if d in by_poc],
                default=0.0)
        return chain[p]
    return max(longest(p) for p in by_poc)


def critical_path_share(records, window):
    """Median over the RA sub-GOPs wholly inside the window of: the longest
    chain of frame.task durations along the tasks' `deps`, over the time
    from the previous sub-GOP's last emission (the window's opening for
    the first) to this sub-GOP's last emission (api.emit ends)."""
    t0, t1, _n = window
    emit_end = {r["attrs"]["poc"]: r["t1"]
                for r in _named(records, "api.emit")}
    subgops = {}
    for r in _named(records, "frame.task"):
        if "base" in r["attrs"]:
            subgops.setdefault(r["attrs"]["base"], {})[r["attrs"]["poc"]] = r
    ends = sorted((max(emit_end[p] for p in by_poc), base)
                  for base, by_poc in subgops.items()
                  if all(p in emit_end for p in by_poc))
    shares, prev = [], t0
    for end, base in ends:
        if end <= t0:
            continue
        if end > t1:
            break
        by_poc = subgops[base]
        if all(r["t0"] >= prev for r in by_poc.values()):
            shares.append(_longest_chain(by_poc) / (end - prev))
        prev = end
    return statistics.median(shares) if shares else None


def readings(records, window, recoveries=None):
    """{name: value} of every reading that finds something to read.
    window: (t0, t1, n) of the run; recoveries: DeviceAnalyzer.failures
    gained over the window, or None where it was not read."""
    t0, t1, n = window
    out = {}

    def put(name, v):
        if v is not None:
            out[name] = v

    ccall = _named(records, "native.ccall")
    put("native.ccall_ms_per_frame", _per_frame_ms(ccall, window))
    inside = [r for r in ccall if t0 <= r["t0"] and r["t1"] <= t1]
    wall = sum(r["t1"] - r["t0"] for r in inside)
    put("native.ccall_cpu_share",
        sum(r["cpu"] for r in inside) / wall if wall > 0 else None)

    tasks = _named(records, "frame.task")
    if tasks and n:
        waits = [r for name in TASK_WAITS
                 for r in _under(records, _named(records, name),
                                 "frame.task")]
        put("frame_worker.host_ms_per_frame",
            (_clipped_s(tasks, t0, t1) - _clipped_s(waits, t0, t1))
            * 1000.0 / n)
        put("frame_worker.running_mean",
            _clipped_s(tasks, t0, t1) / (t1 - t0) if t1 > t0 else None)
        started = [r for r in tasks if t0 < r["t0"] <= t1
                   and r["attrs"].get("t_submit") is not None]
        if started:
            put("frame_worker.ready_wait_ms_per_frame",
                sum(r["t0"] - r["attrs"]["t_submit"] for r in started)
                * 1000.0 / n)
    put("api.critical_path_share", critical_path_share(records, window))

    host = [r for name in ("api.feed", "api.schedule", "api.emit")
            for r in _named(records, name, MAIN)]
    wait = _named(records, "api.wait", MAIN)
    if host and n:
        put("api.host_ms_per_frame",
            (_clipped_s(host, t0, t1) - _clipped_s(wait, t0, t1))
            * 1000.0 / n)
    put("api.emit_wait_ms_per_frame", _per_frame_ms(wait, window))

    put("device_analyzer.enqueue_ms_per_frame",
        _per_frame_ms(_named(records, "device_analyzer.dispatch"), window))
    put("device_analyzer.queue_ms_per_frame",
        _per_frame_ms(_named(records, "device_analyzer.queue"), window))
    readback = _named(records, "device_analyzer.readback")
    put("device_analyzer.readback_ms_per_frame",
        _per_frame_ms(readback, window))
    behind = [r["attrs"]["behind"] for r in readback
              if t0 < r["t0"] <= t1 and r["attrs"].get("behind") is not None]
    put("device_analyzer.readback_behind_mean",
        sum(behind) / len(behind) if behind else None)
    if recoveries is not None and n:
        put("device_analyzer.recoveries_per_frame", recoveries / n)

    load = _named(records, "native.load")
    put("native.load_s", load[0]["t1"] - load[0]["t0"] if load else None)
    warm = [(r["t0"], r["t1"]) for name in ("device_analyzer.dispatch",
                                            "device_analyzer.collect")
            for r in _named(records, name) if r["t0"] < t0]
    put("device_analyzer.warm_s",
        timeline.union(timeline.clip(warm, float("-inf"), t0))
        if warm else None)
    return out


def _innermost(records, thread_prefix, t):
    """Name of the innermost span open at time t on the threads whose
    names start with thread_prefix, or "none"."""
    open_ = [r for r in records if r["thread"].startswith(thread_prefix)
             and r["t0"] <= t <= r["t1"]]
    return max(open_, key=lambda r: r["t0"])["name"] if open_ else "none"


def label_gaps(intervals, t0, t1, host_spans, records, top=10):
    """The longest device-idle gaps of [t0, t1] as devtrace.summarize lists
    them ([label, seconds], the label naming the benchmark's host spans
    open at the gap's middle), each label followed by
    `|main:<span>|dispatch:<span>`: the innermost program span open there
    on the main thread and on the dispatcher thread."""
    iv = timeline.clip([(a, b) for a, b, _ in intervals], t0, t1)
    out = []
    for a, b in sorted(timeline.gaps(iv, t0, t1),
                       key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        outer = "+".join(lbl for lbl, sp in sorted(host_spans.items())
                         if any(x <= mid <= y for x, y in sp)) or "none"
        out.append([f"{outer}|main:{_innermost(records, MAIN, mid)}"
                    f"|dispatch:{_innermost(records, DISPATCHER, mid)}",
                    b - a])
    return out
