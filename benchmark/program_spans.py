"""The program's own spans over one cell's window, on the card.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--device cuda:0]

Sets the cell up and runs its window as a traced run of run.py does (the
same encoder, warm-up, feed and window; torch.profiler over the window on
a card), with xeve_tpu_torch.trace recording from before the encoder is
built, and prints one JSON line: the readings of evcbench/program.py, the
benchmark's own per-layer readings of the same window, the sum of the
frame workers' task spans per frame, and the device's longest idle gaps
labelled with the program spans open during them.  It skips the checks
of `correct` and keeps no frames; run.py never runs it.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run(cell, cfg, traffic, *, seed, seconds, device, t_proc0):
    """One cell's set-up and window with the recorder on; returns the
    result line as a dict."""
    import torch
    from evcbench import cell as cells, check, content, devtrace, drive
    from evcbench import program, timeline
    from xeve_tpu_torch import trace

    dev_t = torch.device(device)
    cuda = dev_t.type == "cuda"
    structure = check.Structure(traffic["structure"])
    unit = int(traffic["unit"])
    w, h = cfg["params"]["w"], cfg["params"]["h"]
    engine = cells.engine(cfg["engine"]["analysis"])
    trace.start()
    try:
        clip = content.make_clip(traffic["content"], w, h, seed, dev_t)
        enc = drive._encoder(cfg, structure, traffic, device, engine)
        device_trace = None
        if cuda:
            devtrace.DeviceTrace.warm(dev_t)
            device_trace = devtrace.DeviceTrace()
            torch.cuda.synchronize(dev_t)
        emits, _kept, spans, _r, marks = drive._stream(
            enc, engine, clip, unit=unit, n_keep=1, seconds=seconds,
            tracer=device_trace)
    finally:
        records = trace.stop()
    t0, t1, n = timeline.window([t for t, _b, _d in emits], unit, seconds)
    recoveries = drive.gained(marks, n)["DeviceAnalyzer.failures"]
    line = {"workload": cell, "seed": seed, "device": str(dev_t),
            "window_s": t1 - t0, "frames": n,
            "setup_s": emits[0][0] - t_proc0,
            "readings": program.readings(records, (t0, t1, n), recoveries)}
    line["spans_per_frame"] = sum(1 for r in records
                                  if t0 < r["t0"] <= t1) / n if n else None
    tasks = [(r["t0"], r["t1"]) for r in records if r["name"] == "frame.task"]
    line["frame_task_ms_per_frame"] = (
        timeline.total(timeline.clip(tasks, t0, t1)) * 1000.0 / n
        if tasks and n else None)
    summary = None
    if device_trace is not None:
        iv = device_trace.device_intervals()
        summary = devtrace.summarize(iv, device_trace.t_mark, t1, spans)
        line["idle_gaps"] = program.label_gaps(iv, device_trace.t_mark, t1,
                                               spans, records)
        line["device_name"] = torch.cuda.get_device_name(dev_t)
    bench_run = {"window": (t0, t1, n), "spans": spans, "device": summary}
    line["benchmark"] = {}
    for name in ("native.cpass_ms_per_frame", "native.cpass_busy_share",
                 "device_analyzer.wait_ms_per_frame",
                 "device.busy_ms_per_frame", "device.idle_share"):
        v = cells.reader(name)(bench_run)
        if v is not None:
            line["benchmark"][name] = v
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]

    import torch
    from evcbench import cell as cells

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("program_spans.py: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    _cell, cfg, traffic, _e2e, _pl = cells.load_cell(args.workload)
    line = run(args.workload, cfg, traffic, seed=args.seed,
               seconds=args.seconds, device=args.device, t_proc0=T_PROC0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
