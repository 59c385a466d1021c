"""Batched Main-profile (EIPD) intra prediction over many blocks at once.

The 33-mode predictor set of intra_main_np.py re-expressed as data-parallel
tensor ops: every angular mode reduces to a constant per-(mode,size) gather
table (source row/col, 4 tap indices, 4 filter weights) applied to the
neighbour arrays of N blocks simultaneously; DC/plane/BI are batched exact
integer formulas.  This is the representation the TPU analyzer consumes
(gathers become one-hot matmuls on device) and the numpy analysis oracle.

Reference semantics: xevem_ipred.c:157-790 (cited per function in
intra_main_np.py, whose scalar kernels are the golden reference — equality
is asserted in tests/test_main_intra.py).
"""
from __future__ import annotations

import functools

import numpy as np

from .intra_main_np import (TBL_ADI, TBL_DXDY, LUT_SIZE_PLUS1, _TBL_WC,
                            _IB_MULT, _IB_SHIFT, IPD_DC, IPD_PLN, IPD_BI,
                            IPD_VER, IPD_HOR, IPD_CNT)


def _log2(v):
    return int(v).bit_length() - 1


@functools.lru_cache(maxsize=None)
def ang_tables(ipm: int, w: int, h: int):
    """Exact gather representation of _pred_ang (xevem_ipred.c:462,568,640):
    returns (src, idx, filt) with shapes (h,w), (h,w,4), (h,w,4); src==0
    reads the up row, src==1 the left column; idx is pre-clipped to
    [-1, w+h-1] and offset by +1 for direct indexing of the length
    (w+h+1) neighbour arrays."""
    mt_x, mt_y = int(TBL_DXDY[ipm][0]), int(TBL_DXDY[ipm][1])
    pos_max = w + h - 1
    src = np.zeros((h, w), dtype=np.int32)
    idx = np.zeros((h, w, 4), dtype=np.int32)
    filt = np.zeros((h, w, 4), dtype=np.int64)
    jj = np.arange(h)
    ii = np.arange(w)
    if ipm < IPD_VER:
        t_dx = ((jj + 1) * mt_x) >> 10                       # (h,)
        offset = (((jj + 1) * mt_x) >> 5) - (t_dx << 5)
        xx = ii[None, :] + t_dx[:, None]                     # (h,w)
        for k, d in enumerate((-1, 0, 1, 2)):
            idx[:, :, k] = np.clip(xx + d, -1, pos_max)
        filt[:] = TBL_ADI[offset][:, None, :]
    elif ipm > IPD_HOR:
        src[:] = 1
        t_dy = ((ii + 1) * mt_y) >> 10                       # (w,)
        offset = (((ii + 1) * mt_y) >> 5) - (t_dy << 5)
        yy = jj[:, None] + t_dy[None, :]
        for k, d in enumerate((-1, 0, 1, 2)):
            idx[:, :, k] = np.clip(yy + d, -1, pos_max)
        filt[:] = TBL_ADI[offset][None, :, :]
    else:
        t_dy = ((ii + 1) * mt_y) >> 10                       # (w,)
        up_branch = jj[:, None] < t_dy[None, :]              # (h,w)
        # up branch (reversed taps)
        t_dx = ((jj + 1) * mt_x) >> 10
        off_u = (((jj + 1) * mt_x) >> 5) - (t_dx << 5)
        xx = ii[None, :] - t_dx[:, None]
        # left branch (reversed taps)
        off_l = (((ii + 1) * mt_y) >> 5) - (t_dy << 5)
        yy = jj[:, None] - t_dy[None, :]
        src[:] = np.where(up_branch, 0, 1)
        for k, d in enumerate((1, 0, -1, -2)):
            iu = np.clip(xx + d, -1, pos_max)
            il = np.clip(yy + d, -1, pos_max)
            idx[:, :, k] = np.where(up_branch, iu, il)
        fu = TBL_ADI[off_u][:, None, :]      # (h,1,4)
        fl = TBL_ADI[off_l][None, :, :]      # (1,w,4)
        filt[:] = np.where(up_branch[:, :, None], fu, fl)
    return src, idx + 1, filt


def pred_ang_batch(up, left, ipm, w, h, bd):
    """(N, h, w) angular prediction for N blocks.  up: (N, w+h+1) with
    up[:,0] == index -1; left likewise."""
    src, idx, filt = ang_tables(ipm, w, h)
    vu = up[:, idx]                       # (N,h,w,4)
    vl = left[:, idx]
    v = np.where(src[None, :, :, None] == 0, vu, vl)
    out = (np.einsum('nhwk,hwk->nhw', v.astype(np.int64), filt) + 64) >> 7
    return np.clip(out, 0, (1 << bd) - 1)


def pred_dc_batch(up, left, w, h):
    s = (left[:, 1:1 + h].sum(-1) + up[:, 1:1 + w].sum(-1)
         + ((w + h) >> 1)).astype(np.int64)
    asp = abs(_log2(w) - _log2(h))
    dc = (s * LUT_SIZE_PLUS1[asp]) >> (min(_log2(w), _log2(h)) + 12)
    return np.broadcast_to(dc[:, None, None], (up.shape[0], h, w))


def pred_hor_batch(up, left, w, h):
    return np.broadcast_to(left[:, 1:1 + h, None], (left.shape[0], h, w))


def pred_ver_batch(up, left, w, h):
    return np.broadcast_to(up[:, None, 1:1 + w], (up.shape[0], h, w))


def pred_plane_batch(up, left, w, h, bd):
    """Batched _pred_plane (xevem_ipred.c:265)."""
    N = up.shape[0]
    w2, h2 = w >> 1, h >> 1
    im_h, is_h = _IB_MULT[max(_log2(w) - 2, 0)], _IB_SHIFT[max(_log2(w) - 2, 0)]
    im_v, is_v = _IB_MULT[max(_log2(h) - 2, 0)], _IB_SHIFT[max(_log2(h) - 2, 0)]
    xs = np.arange(1, w2 + 1, dtype=np.int64)
    coef_h = (xs[None, :] * (up[:, 1 + w2 - 1 + xs] - up[:, 1 + w2 - 1 - xs])
              ).sum(-1)
    ys = np.arange(1, h2 + 1, dtype=np.int64)
    coef_v = (ys[None, :] * (left[:, 1 + h2 - 1 + ys] - left[:, 1 + h2 - 1 - ys])
              ).sum(-1)
    a = (left[:, 1 + h - 1] + up[:, 1 + w - 1]).astype(np.int64) << 4
    b = ((coef_h << 5) * im_h + (1 << (is_h - 1))) >> is_h
    c = ((coef_v << 5) * im_v + (1 << (is_v - 1))) >> is_v
    base = a - (h2 - 1) * c - (w2 - 1) * b + 16
    xw = np.arange(w, dtype=np.int64)
    yh = np.arange(h, dtype=np.int64)
    vals = (base[:, None, None] + yh[None, :, None] * c[:, None, None]
            + xw[None, None, :] * b[:, None, None]) >> 5
    return np.clip(vals, 0, (1 << bd) - 1)


def pred_bi_batch(up, left, w, h, bd):
    """Batched _pred_bi (xevem_ipred.c:339)."""
    ish_x, ish_y = _log2(w), _log2(h)
    ish = min(ish_x, ish_y)
    ish_xy = ish_x + ish_y + 1
    offset = 1 << (ish_x + ish_y)
    wc = _TBL_WC[abs(ish_x - ish_y)]
    ref_up = up[:, 1:1 + w].astype(np.int64)
    ref_le = left[:, 1:1 + h].astype(np.int64)
    a = up[:, 1 + w].astype(np.int64)
    b = left[:, 1 + h].astype(np.int64)
    if w == h:
        c = (a + b + 1) >> 1
    else:
        c = (((a << ish_x) + (b << ish_y)) * wc + (1 << (ish + 9))) >> (ish + 10)
    wt = (c << 1) - a - b
    up_d = b[:, None] - ref_up
    ref_up_s = ref_up << ish_y
    le_d = a[:, None] - ref_le
    ref_le_s = ref_le << ish_x
    wy = np.arange(h, dtype=np.int64)[None, :] * wt[:, None]     # (N,h)
    xs = np.arange(1, w + 1, dtype=np.int64)
    ys = np.arange(1, h + 1, dtype=np.int64)
    predx = ref_le_s[:, :, None] + le_d[:, :, None] * xs[None, None, :]
    refu = ref_up_s[:, None, :] + up_d[:, None, :] * ys[None, :, None]
    wxy = wy[:, :, None] * np.arange(w, dtype=np.int64)[None, None, :]
    vals = ((predx << ish_y) + (refu << ish_x) + wxy + offset) >> ish_xy
    return np.clip(vals, 0, (1 << bd) - 1)


def pred_mode_batch(up, left, ipm, w, h, bd):
    """(N, h, w) exact prediction of one EIPD mode for N blocks."""
    if ipm == IPD_VER:
        return pred_ver_batch(up, left, w, h)
    if ipm == IPD_HOR:
        return pred_hor_batch(up, left, w, h)
    if ipm == IPD_DC:
        return pred_dc_batch(up, left, w, h)
    if ipm == IPD_PLN:
        return pred_plane_batch(up, left, w, h, bd)
    if ipm == IPD_BI:
        return pred_bi_batch(up, left, w, h, bd)
    return pred_ang_batch(up, left, ipm, w, h, bd)


def pred_all_modes_main(up, left, w, h, bd, modes=None):
    """(N, M, h, w) predictions for the given EIPD mode subset (default all
    33), exact integers."""
    if modes is None:
        modes = range(IPD_CNT)
    return np.stack([pred_mode_batch(up, left, m, w, h, bd) for m in modes],
                    axis=1)


def open_loop_neighbors(plane: np.ndarray, s: int, bd: int):
    """Main-profile open-loop neighbour arrays for all aligned s×s blocks:
    returns (up, left) of shape (nby, nbx, 2s+1) following xevem_get_nbr
    fill rules with every in-picture unit available (raster order: rows
    above and columns left of the block are original pixels; out-of-picture
    units replicate per xevem_ipred.c:40)."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    mid = 1 << (bd - 1)
    n = 2 * s + 1
    up = np.empty((nby, nbx, n), dtype=np.int64)
    left = np.empty((nby, nbx, n), dtype=np.int64)

    # interior: up row j*s-1, cols x-1 .. x+2s-1 (idx -1..2s-1)
    padr = np.pad(plane, ((0, 0), (0, s)), mode="edge")
    for j in range(nby):
        if j == 0:
            up[0, :, :] = mid
        else:
            row = padr[j * s - 1]
            for i in range(nbx):
                x = i * s
                if x == 0:
                    up[j, i, 0] = row[0]      # corner unavailable -> up[0]=up[1]
                    up[j, i, 1:] = row[x:x + 2 * s]
                else:
                    up[j, i, 0] = row[x - 1]
                    up[j, i, 1:] = row[x:x + 2 * s]
    padb = np.pad(plane, ((0, s), (0, 0)), mode="edge")
    for i in range(nbx):
        if i == 0:
            # left column unavailable: every unit replicates left[-1]=up[-1]
            left[:, 0, :] = up[:, 0, 0:1]
        else:
            col = padb[:, i * s - 1]
            for j in range(nby):
                y = j * s
                left[j, i, 1:] = col[y:y + 2 * s]
                left[j, i, 0] = up[j, i, 0]
    return up, left
