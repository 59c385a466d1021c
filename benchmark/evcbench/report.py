"""The result line of a run."""
from __future__ import annotations

from . import cell as cells


def result_line(out, e2e, per_layer, *, trace, chips, kind, bench_dir=None):
    """The JSON object run.py prints last: `correct`, `attempted`,
    `failed`, `metrics` (end-to-end, or per-layer with trace), `device`,
    with trace `breakdown`, and last `checks`.  A per-layer metric whose
    reader finds nothing is left out."""
    run = out["run"]
    metrics = {}
    for m in (per_layer if trace else e2e):
        if trace:
            kw = {} if bench_dir is None else {"bench_dir": bench_dir}
            v = cells.reader(m["name"], **kw)(run)
        else:
            v = run.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": int(chips),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and run["device"] is not None:
        device["busy_s"] = run["device"]["busy_s"]
        device["window_s"] = run["device"]["window_s"]
        line["breakdown"] = {"device_ops": run["device"]["device_ops"],
                             "idle_gaps": run["device"]["idle_gaps"]}
    line["checks"] = out["checks"]
    return line
