"""Mean number of frame workers running a task over the window: the
port's frame.task spans (xeve_tpu_torch.trace, recorded in a traced run)
clipped to the window and summed, over its length (evcbench/program.py)."""
from evcbench import program


def read(run):
    if not run.get("program"):
        return None
    return program.readings(run["program"], run["window"]).get(
        "frame_worker.running_mean")
