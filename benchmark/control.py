"""The control of `correct`, and the program's own readings, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --mode tf32|program --seeds <n> [<n> ...]

Runs the cell once per seed in one process, as run.py does, but keeps
only the frames that the analyzer check samples (kbps, PSNR-Y and the
decode check keep their first frame).  With --mode tf32 the program runs
with TF32 matmuls switched on after its set-up has switched them off:
the nearest precision below the float32 that the analyzer states, and
the control that `correct` has to fail.  Prints one JSON line per seed
with every check's reading and limit.  The benchmark's own runs never run
this.
"""
import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def tf32_on(_enc):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("tf32", "program"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]

    import torch
    from evcbench import cell as cells
    from evcbench.drive import run_cell

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("control.py: torch finds no CUDA device", file=sys.stderr)
        return 2
    _cell, cfg, traffic, _e2e, _pl = cells.load_cell(args.workload)
    traffic = copy.deepcopy(traffic)
    traffic["quality_frames"] = 1
    traffic["decode"] = {"prefix": 1}
    for seed in args.seeds:
        out = run_cell(args.workload, cfg, traffic, seed=seed,
                       seconds=args.seconds, trace=False, device=args.device,
                       t_proc0=time.perf_counter(),
                       fault=tf32_on if args.mode == "tf32" else None)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": out["correct"],
                          "checked": out["checked"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
