"""Device milliseconds per frame: the union of the CUDA intervals of the
traced window over the frames emitted in it."""


def read(run):
    d, (_t0, _t1, n) = run["device"], run["window"]
    if d is None or not n:
        return None
    return d["busy_s"] * 1000.0 / n
