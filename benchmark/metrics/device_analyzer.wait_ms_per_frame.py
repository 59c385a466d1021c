"""Host milliseconds blocked in DeviceAnalyzer.collect per frame of the
window (the wait for the fused analysis and its readback), summed over
the threads that call it."""
from evcbench import timeline


def read(run):
    t0, t1, n = run["window"]
    if not n:
        return None
    sp = timeline.clip(run["spans"]["collect"], t0, t1)
    return timeline.total(sp) * 1000.0 / n if sp else None
