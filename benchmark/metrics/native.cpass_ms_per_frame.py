"""C-pass host milliseconds per frame of the window: the spans around
the C coding pass's entry points (Encoder._code_slice, api's
encode_intra_frame_native), clipped to the window and summed over the
frame workers."""
from evcbench import timeline


def read(run):
    t0, t1, n = run["window"]
    if not n:
        return None
    sp = timeline.clip(run["spans"]["cpass"], t0, t1)
    return timeline.total(sp) * 1000.0 / n if sp else None
