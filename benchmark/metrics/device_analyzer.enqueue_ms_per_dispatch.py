"""Host milliseconds DeviceAnalyzer.dispatch takes to enqueue one fused
analysis: the port's device_analyzer.dispatch spans (xeve_tpu_torch.trace,
recorded in a traced run) that open inside the window, summed, over their
count.  Per dispatch, the dispatches that a window's last sub-GOPs make
for the sub-GOPs after them do not inflate it, as they do a sum over the
window per emitted frame."""


def read(run):
    if not run.get("program"):
        return None
    t0, t1, _n = run["window"]
    spans = [r["t1"] - r["t0"] for r in run["program"]
             if r["name"] == "device_analyzer.dispatch" and t0 < r["t0"] <= t1]
    return sum(spans) * 1000.0 / len(spans) if spans else None
