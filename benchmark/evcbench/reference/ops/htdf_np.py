"""HTDF — Hadamard transform-domain in-loop filter (Main profile).

Applied to each CU's luma reconstruction immediately after recon (so later
CUs predict from filtered pixels): a sliding 2x2 Hadamard transform whose
three AC terms are soft-thresholded through a QP-dependent LUT, with the
four overlapping window contributions averaged per pixel.

Reference: xevem_recon.c:116-363 (xeve_htdf / xeve_htdf_filter_block /
xeve_htdf_skip_condition); invoked for intra CUs (xevem_pintra.c:109,
always) and inter CUs with luma coefficients (xevem_pinter.c:6090,
nnz-gated), both with xeve_get_avail_intra availability and the
slice/tile QP.
"""
from __future__ import annotations

import numpy as np

LUT_QP_NUM = 5
LUT_SIZE_LOG2 = 4
LUT_MIN_QP = 20
LUT_STEP_QP_LOG2 = 3

THR_LOG2 = [6, 7, 7, 8, 8]
TBL = np.array([
    [0, 0, 2, 6, 10, 14, 19, 23, 28, 32, 36, 41, 45, 49, 53, 57],
    [0, 0, 5, 12, 20, 29, 38, 47, 56, 65, 73, 82, 90, 98, 107, 115],
    [0, 0, 1, 4, 9, 16, 24, 32, 41, 50, 59, 68, 77, 86, 94, 103],
    [0, 0, 3, 9, 19, 32, 47, 64, 81, 99, 117, 135, 154, 179, 205, 230],
    [0, 0, 0, 2, 6, 11, 18, 27, 38, 51, 64, 96, 128, 160, 192, 224],
], dtype=np.int64)


def skip_condition(w: int, h: int, intra: bool, qp: int):
    """(skip, adjusted_qp) per xeve_htdf_skip_condition."""
    if qp <= 17:
        return True, qp
    if w * h < 64:
        return True, qp
    mn, mx = min(w, h), max(w, h)
    if mx >= 128:
        return True, qp
    if not intra:
        if mn >= 32:
            return True, qp
    elif w == h and mn >= 32:
        qp -= 1 << LUT_STEP_QP_LOG2
    return False, qp


def _soft_threshold(z, tbl, thr_log2):
    shift = thr_log2 - LUT_SIZE_LOG2
    rnd = (1 << shift) >> 1
    thr = (1 << thr_log2) - (1 << shift)
    az = np.abs(z)
    filt = tbl[np.minimum((az + rnd) >> shift, (1 << LUT_SIZE_LOG2) - 1)]
    keep = az >= thr
    mag = np.where(keep, az, filt)
    return np.where(z < 0, -mag, mag)


def htdf_cu(plane: np.ndarray, x: int, y: int, w: int, h: int, qp: int,
            intra: bool, avail: dict, bd: int):
    """Filter the CU's luma recon in-place.  `avail` keys: le, ri, up,
    up_le, up_ri, lo_le, lo_ri (xeve_get_avail_intra flags)."""
    skip, qp = skip_condition(w, h, intra, qp)
    if skip:
        return
    idx = (qp - LUT_MIN_QP + (1 << (LUT_STEP_QP_LOG2 - 1))) >> LUT_STEP_QP_LOG2
    idx = min(max(idx, 0), LUT_QP_NUM - 1)
    tbl = TBL[idx]
    thr_log2 = THR_LOG2[idx]

    cu = plane[y:y + h, x:x + w].astype(np.int64)
    ext = np.empty((h + 2, w + 2), dtype=np.int64)
    ext[1:h + 1, 1:w + 1] = cu
    ext[1:h + 1, 0] = plane[y:y + h, x - 1] if avail["le"] else cu[:, 0]
    ext[1:h + 1, w + 1] = plane[y:y + h, x + w] if avail["ri"] else cu[:, -1]
    if avail["up"]:
        ext[0, 1:w + 1] = plane[y - 1, x:x + w]
    else:
        ext[0, 1:w + 1] = cu[0, :]
    ext[h + 1, 1:w + 1] = cu[-1, :]   # bottom row always replicated
    ext[0, 0] = plane[y - 1, x - 1] if avail["up_le"] else cu[0, 0]
    ext[0, w + 1] = plane[y - 1, x + w] if avail["up_ri"] else cu[0, -1]
    ext[h + 1, 0] = plane[y + h, x - 1] if avail["lo_le"] else cu[-1, 0]
    ext[h + 1, w + 1] = (plane[y + h, x + w] if avail["lo_ri"]
                         else cu[-1, -1])

    # all 2x2 windows over the extended block
    x0 = ext[:-1, :-1]
    x1 = ext[:-1, 1:]
    x2 = ext[1:, :-1]
    x3 = ext[1:, 1:]
    y0 = x0 + x2
    y1 = x1 + x3
    y2 = x0 - x2
    y3 = x1 - x3
    t0 = y0 + y1
    t1 = _soft_threshold(y0 - y1, tbl, thr_log2)
    t2 = _soft_threshold(y2 + y3, tbl, thr_log2)
    t3 = _soft_threshold(y2 - y3, tbl, thr_log2)
    iy0 = t0 + t2
    iy1 = t1 + t3
    iy2 = t0 - t2
    iy3 = t1 - t3
    c0 = (iy0 + iy1) >> 2   # contribution to window's top-left pixel
    c1 = (iy0 - iy1) >> 2   # top-right
    c2 = (iy2 + iy3) >> 2   # bottom-left
    c3 = (iy2 - iy3) >> 2   # bottom-right
    # accumulate the 4 overlapping contributions per interior pixel
    acc = np.zeros_like(ext)
    acc[:-1, :-1] += c0
    acc[:-1, 1:] += c1
    acc[1:, :-1] += c2
    acc[1:, 1:] += c3
    out = np.clip((acc[1:h + 1, 1:w + 1] + 2) >> 2, 0, (1 << bd) - 1)
    plane[y:y + h, x:x + w] = out.astype(plane.dtype)
