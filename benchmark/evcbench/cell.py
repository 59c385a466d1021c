"""Finding a cell's files by name.

BENCHMARK.json at the root of the checkout names each cell's
configuration and traffic mix; the harness reads

  benchmark/configs/<config>.json      sizes, profile, engine
  benchmark/traffic/<traffic>.json     coding structure (encoder class,
                                       order, qp model), window unit,
                                       checks' samples, content
  benchmark/limits/<cell>.json         limits of the checks (else
                                       benchmark/limits/default.json)
  benchmark/metrics/<metric>.py        one reader per per-layer metric

so that a new cell, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT, bench_dir=BENCH_DIR):
    """(cell entry, configuration, traffic, end-to-end and per-layer
    metric entries that the cell reports) of workload `name`."""
    s = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in s["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = _json(os.path.join(bench_dir, "configs", cell["config"] + ".json"))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 cell["traffic"] + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    return (cell, cfg, traffic, [m for m in s["end_to_end"] if mine(m)],
            [m for m in s["per_layer"] if mine(m)])


def load_limits(cell, bench_dir=BENCH_DIR):
    d = os.path.join(bench_dir, "limits")
    path = os.path.join(d, cell + ".json")
    if not os.path.exists(path):
        path = os.path.join(d, "default.json")
    return {k: v for k, v in _json(path).items() if not k.startswith("_")}


def reader(metric, bench_dir=BENCH_DIR):
    """The `read(run)` function of benchmark/metrics/<metric>.py."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    sp = importlib.util.spec_from_file_location(
        "evcbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
