"""Shared closed-loop intra neighbour gathering (numpy), used by the
conformance decoder and the encoder's final coding pass.

Semantics: xeve_get_nbr (src_base/xeve_ipred.c:33-102) — per-unit
availability from the COD map, mid-gray fill, up-left from AVAIL_UP_LE.
"""
from __future__ import annotations

import numpy as np


def gather_nb(plane: np.ndarray, map_cod: np.ndarray, x: int, y: int,
              w: int, h: int, x_scu: int, y_scu: int, unit: int,
              w_scu: int, h_scu: int, bd: int):
    """Returns (up[w+h], left[h+w], up_left) reference samples."""
    mid = 1 << (bd - 1)
    n_up = (w + h) // unit
    n_le = (h + w) // unit
    up = np.full(w + h, mid, dtype=np.int32)
    left = np.full(h + w, mid, dtype=np.int32)
    H, W = plane.shape
    if y_scu > 0:
        for i in range(n_up):
            xi = x_scu + i
            if xi < w_scu and map_cod[y_scu - 1, xi]:
                xs = x + i * unit
                seg = plane[y - 1, xs:min(xs + unit, W)]
                up[i * unit:i * unit + len(seg)] = seg
    if x_scu > 0:
        for i in range(n_le):
            yi = y_scu + i
            if yi < h_scu and map_cod[yi, x_scu - 1]:
                ys = y + i * unit
                seg = plane[ys:min(ys + unit, H), x - 1]
                left[i * unit:i * unit + len(seg)] = seg
    ul_ok = x_scu > 0 and y_scu > 0 and map_cod[y_scu - 1, x_scu - 1]
    up_left = int(plane[y - 1, x - 1]) if ul_ok else mid
    return up, left, up_left
