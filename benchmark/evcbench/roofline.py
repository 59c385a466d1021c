"""Operations and bytes of the port's kernels, for roofline shares
against benchmark/peaks.json.  No cell launches a hand-written kernel
yet; these are the yardstick that a later metric of the ME kernel
(`me_cuda.roofline_share`) will use."""
from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def me_full_search_ops(w: int, h: int, r: int) -> int:
    """Abs-diff-accumulates of one full-search integer ME call over a
    w x h luma plane at search range +-r: every pixel against every one of
    the (2r+1)^2 candidates."""
    return w * h * (2 * r + 1) ** 2


def me_full_search_bytes(w: int, h: int, r: int, pad: int) -> int:
    """Bytes one call must move at least: the int32 current plane and the
    padded int32 reference read once, the int32 (dx, dy) and int32 cost of
    each 16x16 block written once."""
    blocks = (h // 16) * (w // 16)
    return 4 * (w * h + (w + 2 * pad) * (h + 2 * pad)) + blocks * 3 * 4


def me_bound_s(w: int, h: int, r: int, pad: int) -> float:
    """The least time the card could take for one call: the larger of the
    operations at the INT32 peak and the bytes at the HBM peak."""
    p = peaks()
    return max(me_full_search_ops(w, h, r) / p["int32_ops_per_s"],
               me_full_search_bytes(w, h, r, pad) / p["hbm_bytes_per_s"])
