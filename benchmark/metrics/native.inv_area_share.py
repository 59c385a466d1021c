"""Share of the inverse DCT-2's work that the C pass still does: over the
port's native.ccall spans (xeve_tpu_torch.trace, recorded in a traced
run) that open inside the window, the sum of `inv_area`, the nonzero
coefficient rectangles that the inverse transforms computed, over the sum
of `inv_full`, the areas of their blocks.  None where no span carries the
attributes: a program whose C pass does not count its inverse
transforms."""


def read(run):
    if not run.get("program"):
        return None
    t0, t1, _n = run["window"]
    area = full = 0
    for r in run["program"]:
        if r["name"] == "native.ccall" and "inv_full" in r["attrs"] \
                and t0 < r["t0"] <= t1:
            area += r["attrs"]["inv_area"]
            full += r["attrs"]["inv_full"]
    return area / full if full else None
