"""Motion vector prediction and inter availability (Baseline, admvp=0).

Reference: xeve_get_avail_inter (xeve_util.c:652), xeve_get_motion
(xeve_util.c:527-575) — the Baseline MVP list is 4 candidates:
left / up / up-right spatial MVs (or (1,1) when unavailable) plus the
temporal co-located MV from the first L0 reference picture.
"""
from __future__ import annotations

import numpy as np

AVAIL_UP = 1 << 0
AVAIL_LE = 1 << 1
AVAIL_RI = 1 << 3
AVAIL_UP_LE = 1 << 5
AVAIL_UP_RI = 1 << 6

MAX_NUM_MVP = 4


def get_avail_inter(x_scu, y_scu, w_scu, h_scu, scuw, scuh,
                    map_cod, map_if):
    """Subset of xeve_get_avail_inter needed for the Baseline MVP list
    (LE, UP, UP_RI bits; single tile)."""
    avail = 0
    if x_scu > 0 and map_cod[y_scu, x_scu - 1] and not map_if[y_scu, x_scu - 1]:
        avail |= AVAIL_LE
    if y_scu > 0:
        if not map_if[y_scu - 1, x_scu]:
            avail |= AVAIL_UP
        if not map_if[y_scu - 1, min(x_scu + scuw - 1, w_scu - 1)]:
            avail |= 1 << 9  # AVAIL_RI_UP (unused by MVP)
        if x_scu + scuw < w_scu and map_cod[y_scu - 1, x_scu + scuw] \
                and not map_if[y_scu - 1, x_scu + scuw]:
            avail |= AVAIL_UP_RI
    return avail


def get_motion(x_scu, y_scu, scuw, lidx, avail, map_mv, ref0_map_mv, w_scu):
    """xeve_get_motion: returns mvp[4][2] (int).

    map_mv: current-frame motion map (h_scu, w_scu, 2 lists, 2) — raw values
    (zeros where never written), matching the reference's map semantics.
    ref0_map_mv: the first L0 reference picture's motion map (for the
    temporal candidate), may be None -> (0, 0).
    """
    mvp = np.zeros((MAX_NUM_MVP, 2), dtype=np.int32)
    if avail & AVAIL_LE:
        mvp[0] = map_mv[y_scu, x_scu - 1, lidx]
    else:
        mvp[0] = (1, 1)
    if avail & AVAIL_UP:
        mvp[1] = map_mv[y_scu - 1, x_scu, lidx]
    else:
        mvp[1] = (1, 1)
    if avail & AVAIL_UP_RI:
        mvp[2] = map_mv[y_scu - 1, x_scu + scuw, lidx]
    else:
        mvp[2] = (1, 1)
    if ref0_map_mv is not None:
        mvp[3] = ref0_map_mv[y_scu, x_scu, 0]
    return mvp
