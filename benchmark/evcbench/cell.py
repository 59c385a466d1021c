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
  benchmark/evcbench/engines/<analysis>.py
                                       the route of the configuration's
                                       analysis engine (`engine.analysis`):
                                       its warm-up, the taps that keep its
                                       analysis records, its worker pools
                                       and its plain reference

so that a new cell, mix, metric or engine is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

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
    return _module(os.path.join(bench_dir, "metrics", metric + ".py"),
                   "evcbench_metric_" + metric.replace(".", "_")).read


def _module(path, name):
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def engine(analysis, bench_dir=BENCH_DIR):
    """The module benchmark/evcbench/engines/<analysis>.py.  Raises
    LookupError where the benchmark has none."""
    path = os.path.join(bench_dir, "evcbench", "engines", f"{analysis}.py")
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", str(analysis)) \
            or not os.path.isfile(path):
        raise LookupError(f"no engine module for analysis engine "
                          f"{analysis!r} (looked for {path})")
    mod = _module(path, "evcbench_engine_" + analysis.replace(".", "_"))
    if mod.REFERENCES not in ("source", "decoded"):
        raise ValueError(f"engine {analysis!r}: REFERENCES is "
                         f"{mod.REFERENCES!r}, not 'source' or 'decoded'")
    return mod
