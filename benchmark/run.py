"""Benchmark of xeve_tpu_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs the cell named in BENCHMARK.json (its configuration and traffic
files under benchmark/) on one CUDA device and prints, as the last line
of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`checks`, each number that decided `correct` beside its limit.  The same
numbers are the last lines of standard error.  It exits non-zero and
prints no result without a card, when the port is missing, or when jax,
jaxlib, flax or the JAX package were loaded.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "xeve_tpu")


def _caches():
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(build, "triton_cache"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [ROOT, HERE]

    import torch
    from evcbench import cell as cells, report
    from evcbench.drive import run_cell

    cell, cfg, traffic, e2e, per_layer = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell asks for {cell['chips']} CUDA device(s); "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = "cuda:0"
    out = run_cell(args.workload, cfg, traffic, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device=device, t_proc0=T_PROC0)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3

    line = report.result_line(out, e2e, per_layer, trace=bool(args.trace),
                              chips=cell["chips"],
                              kind=torch.cuda.get_device_name(0))
    print(f"checked: {json.dumps(out['checked'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
