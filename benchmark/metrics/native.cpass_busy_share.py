"""Share of the window during which at least one C pass ran (union of
the C-pass spans over the window)."""
from evcbench import timeline


def read(run):
    t0, t1, _n = run["window"]
    sp = timeline.clip(run["spans"]["cpass"], t0, t1)
    return timeline.union(sp) / (t1 - t0) if sp and t1 > t0 else None
