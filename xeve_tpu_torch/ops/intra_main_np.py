"""Main-profile (EIPD) intra prediction: 33 luma modes, 5 chroma modes.

Exact-integer reference kernels shared by the encoder analysis and the
conformance decoder.  Semantics follow ISO/IEC 23094-1; structure cross-
checked against the reference encoder:
  - neighbour gather:      xevem_ipred.c:40  (xevem_get_nbr)
  - DC/HOR/VER:            xevem_ipred.c:157-263
  - plane / bi-linear:     xevem_ipred.c:265-460
  - angular (4-tap ADI):   xevem_ipred.c:462-790
  - MPM / extended MPM:    xevem_ipred.c:904-1355 (xevem_get_mpm)
  - chroma mode mapping:   xevem_ipred.h:43-58

Only the left-available layouts (LR_00 / LR_10) are implemented; the
right-available variants appear with SUCO ordering and will land with it.
"""
from __future__ import annotations

import numpy as np

# luma prediction directions
IPD_DC, IPD_PLN, IPD_BI = 0, 1, 2
IPD_VER, IPD_HOR = 12, 24
IPD_DIA_R, IPD_DIA_L, IPD_DIA_U = 18, 6, 30
IPD_CNT = 33
# chroma prediction directions
IPD_DM_C, IPD_BI_C, IPD_DC_C, IPD_HOR_C, IPD_VER_C = 0, 1, 2, 3, 4
IPD_CHROMA_CNT = 5
# left/right availability (bit0 = left, bit1 = right)
LR_00, LR_10, LR_01, LR_11 = 0, 1, 2, 3

# 4-tap ADI interpolation filter, 1/32-pel phases (xevem_tbl.c:54 — the
# rows are the linear ramp {32-k, 64-k, 32+k, k})
TBL_ADI = np.array([[32 - k, 64 - k, 32 + k, k] for k in range(32)],
                   dtype=np.int64)

# {dx/dy, dy/dx} in Q10/Q? fixed point per mode (xevem_tbl.c:90); the
# tangent ladder 128..8192 mirrored around the pure V (12) and H (24) axes
_TAN = [2816, 2048, 1408, 1024, 744, 512, 372, 256, 128]
_COT = [372, 512, 744, 1024, 1408, 2048, 2816, 4096, 8192]
TBL_DXDY = np.zeros((IPD_CNT, 2), dtype=np.int64)
for _i in range(9):                      # modes 3..11: up-right fan
    TBL_DXDY[3 + _i] = (_TAN[_i], _COT[_i])
for _i in range(11):                     # modes 13..23: between V and H
    _dx = ([128, 256, 372, 512, 744, 1024, 1408, 2048, 2816, 4096, 8192])[_i]
    _dy = ([8192, 4096, 2816, 2048, 1408, 1024, 744, 512, 372, 256, 128])[_i]
    TBL_DXDY[13 + _i] = (_dx, _dy)
for _i in range(8):                      # modes 25..32: down-left fan
    TBL_DXDY[25 + _i] = (_COT[8 - _i], _TAN[8 - _i])

# 1/(w+1) reciprocal LUT, Q12 (xevem_ipred.c:157)
LUT_SIZE_PLUS1 = [2048, 1365, 819, 455, 241, 124, 63, 32]

# third-tier default mode ranking (xevem_ipred.c:896, intra_mode_list)
INTRA_MODE_LIST = [
    IPD_DC, IPD_BI, IPD_VER, IPD_PLN, IPD_HOR, IPD_VER - 1, IPD_VER + 1,
    IPD_VER - 2, IPD_VER + 2, IPD_VER - 3, IPD_VER + 3, IPD_HOR - 1,
    IPD_HOR + 1, IPD_HOR - 2, IPD_HOR + 2, IPD_HOR - 3, IPD_HOR + 3,
    IPD_DIA_R, IPD_DIA_L, IPD_DIA_L - 3, IPD_DIA_L - 2, IPD_DIA_L - 1,
    IPD_DIA_U, IPD_DIA_U + 1, IPD_DIA_U + 2, IPD_VER + 5, IPD_VER + 4,
    IPD_HOR - 4, IPD_HOR - 5, IPD_VER - 5, IPD_VER - 4, IPD_HOR + 5,
    IPD_HOR + 4,
]


def conv_luma_to_chroma(ipm_l: int):
    """(converted chroma mode, was-convertible) per XEVE_IPRED_CONV_L2C_CHK."""
    if ipm_l == IPD_VER:
        return IPD_VER_C, True
    if ipm_l == IPD_HOR:
        return IPD_HOR_C, True
    if ipm_l == IPD_DC:
        return IPD_DC_C, True
    if ipm_l == IPD_BI:
        return IPD_BI_C, True
    return ipm_l, False


# ---------------------------------------------------------------------------
# neighbour gather (xevem_get_nbr) — returns arrays indexable from -1
# ---------------------------------------------------------------------------

class Nbr:
    """up[i] for i in [-1, w+h-1]; left[i] for i in [-1, h+w-1];
    right[i] for i in [-2, h+w-1] (SUCO layouts)."""

    __slots__ = ("up", "left", "avail_lr", "right")

    def __init__(self, up, left, avail_lr, right=None):
        self.up = up        # ndarray of len w+h+1; up[0] is index -1
        self.left = left
        self.avail_lr = avail_lr
        self.right = right  # ndarray of len h+w+2; right[0] is index -2

    def u(self, i):
        return self.up[i + 1]

    def l(self, i):
        return self.left[i + 1]

    def r(self, i):
        return self.right[i + 2]


def get_nbr_main(plane, x, y, w, h, x_scu, y_scu, map_cod, w_scu, h_scu,
                 unit, bd):
    """Main-profile neighbour fill: unavailable units replicate the last
    available pixel (not mid-gray as in Baseline).  `unit` is pixels per
    SCU step on this plane (4 luma, 2 chroma 4:2:0)."""
    mid = 1 << (bd - 1)
    H, W = plane.shape
    n_units = (w + h) // unit
    up = np.empty(w + h + 1, dtype=np.int64)
    left = np.empty(h + w + 1, dtype=np.int64)

    # corner (AVAIL_UP_LE): both up and left rows exist and up-left coded
    corner_ok = (x_scu > 0 and y_scu > 0 and map_cod[y_scu - 1, x_scu - 1])
    up[0] = plane[y - 1, x - 1] if corner_ok else mid
    # up row: per-unit availability, replicate-left on holes
    for i in range(n_units):
        ok = (y_scu > 0 and x_scu + i < w_scu and
              map_cod[y_scu - 1, x_scu + i])
        base = 1 + i * unit
        if ok:
            seg = plane[y - 1, x + i * unit:x + (i + 1) * unit]
            up[base:base + unit] = seg
        else:
            up[base:base + unit] = up[base - 1]
    # up-left extension (xevem_get_nbr:93-108): the final up[-1] is the
    # above-left pixel when coded, else a copy of up[0] — never mid-gray
    if corner_ok:
        up[0] = plane[y - 1, x - 1]
    else:
        up[0] = up[1]
    # left column
    left[0] = up[0]
    for i in range(n_units):
        ok = (x_scu > 0 and y_scu + i < h_scu and
              map_cod[y_scu + i, x_scu - 1])
        base = 1 + i * unit
        if ok:
            seg = plane[y + i * unit:y + (i + 1) * unit, x - 1]
            left[base:base + unit] = seg
        else:
            left[base:base + unit] = left[base - 1]

    # right column (xevem_get_nbr:131-155, SUCO layouts): per-unit
    # availability of the column at x+w; holes replicate downward from
    # the sample above; right[-1] = up[w]
    scuw = w // unit
    right = np.empty(h + w + 2, dtype=np.int64)
    right[1] = up[1 + w] if w < up.shape[0] - 1 else up[-1]
    right[0] = right[1]
    for i in range(n_units):
        ok = (x_scu + scuw < w_scu and y_scu + i < h_scu and
              map_cod[y_scu + i, x_scu + scuw])
        base = 2 + i * unit
        if ok:
            seg = plane[y + i * unit:y + (i + 1) * unit, x + w]
            right[base:base + unit] = seg
        else:
            right[base:base + unit] = right[base - 1]

    avail_l = x_scu > 0 and map_cod[y_scu, x_scu - 1]
    avail_r = (x_scu + scuw < w_scu and map_cod[y_scu, x_scu + scuw])
    avail_lr = (LR_10 if avail_l else LR_00) | (LR_01 if avail_r else 0)
    return Nbr(up, left, avail_lr, right)


# ---------------------------------------------------------------------------
# predictors (left-available layouts)
# ---------------------------------------------------------------------------

def _log2(v):
    return int(v).bit_length() - 1


def _get_dc(numerator, w, h):
    lw, lh = _log2(w), _log2(h)
    basic = min(lw, lh)
    asp = abs(lw - lh)
    return (numerator * LUT_SIZE_PLUS1[asp]) >> (basic + 12)


def _pred_dc(nb: Nbr, w, h):
    dc = int(sum(nb.l(i) for i in range(h)) + sum(nb.u(j) for j in range(w)))
    dc = _get_dc(dc + ((w + h) >> 1), w, h)
    return np.full((h, w), dc, dtype=np.int64)


def _pred_hor(nb: Nbr, w, h):
    col = np.array([nb.l(i) for i in range(h)], dtype=np.int64)
    return np.repeat(col[:, None], w, axis=1)


def _pred_ver(nb: Nbr, w, h):
    row = np.array([nb.u(j) for j in range(w)], dtype=np.int64)
    return np.repeat(row[None, :], h, axis=0)


_IB_MULT = [13, 17, 5, 11, 23, 47]
_IB_SHIFT = [7, 10, 11, 15, 19, 23]


def _pred_plane(nb: Nbr, w, h, bd):
    w2, h2 = w >> 1, h >> 1
    idx_w = max(_log2(w) - 2, 0)
    idx_h = max(_log2(h) - 2, 0)
    im_h, is_h = _IB_MULT[idx_w], _IB_SHIFT[idx_w]
    im_v, is_v = _IB_MULT[idx_h], _IB_SHIFT[idx_h]
    coef_h = sum(x * (nb.u(w2 - 1 + x) - nb.u(w2 - 1 - x))
                 for x in range(1, w2 + 1))
    coef_v = sum(y * (nb.l(h2 - 1 + y) - nb.l(h2 - 1 - y))
                 for y in range(1, h2 + 1))
    a = (nb.l(h - 1) + nb.u(w - 1)) << 4
    b = ((coef_h << 5) * im_h + (1 << (is_h - 1))) >> is_h
    c = ((coef_v << 5) * im_v + (1 << (is_v - 1))) >> is_v
    base = a - (h2 - 1) * c - (w2 - 1) * b + 16
    xs = np.arange(w, dtype=np.int64)
    ys = np.arange(h, dtype=np.int64)
    vals = (base + ys[:, None] * c + xs[None, :] * b) >> 5
    return np.clip(vals, 0, (1 << bd) - 1)


_TBL_WC = [-1, 341, 205, 114, 60, 31]


def _pred_bi(nb: Nbr, w, h, bd):
    ish_x, ish_y = _log2(w), _log2(h)
    ish = min(ish_x, ish_y)
    ish_xy = ish_x + ish_y + 1
    offset = 1 << (ish_x + ish_y)
    wc = _TBL_WC[abs(ish_x - ish_y)]
    ref_up = np.array([nb.u(j) for j in range(w)], dtype=np.int64)
    ref_le = np.array([nb.l(i) for i in range(h)], dtype=np.int64)
    a = int(nb.u(w))
    b = int(nb.l(h))
    if w == h:
        c = (a + b + 1) >> 1
    else:
        c = (((a << ish_x) + (b << ish_y)) * wc + (1 << (ish + 9))) >> (ish + 10)
    wt = (c << 1) - a - b
    up_d = b - ref_up                   # per-column increment
    ref_up_s = ref_up << ish_y
    le_d = a - ref_le                   # per-row increment
    ref_le_s = ref_le << ish_x
    wy = np.arange(h, dtype=np.int64) * wt
    xs = np.arange(1, w + 1, dtype=np.int64)
    ys = np.arange(1, h + 1, dtype=np.int64)
    predx = ref_le_s[:, None] + le_d[:, None] * xs[None, :]
    refu = ref_up_s[None, :] + up_d[None, :] * ys[:, None]
    wxy = wy[:, None] * np.arange(w, dtype=np.int64)[None, :]
    vals = ((predx << ish_y) + (refu << ish_x) + wxy + offset) >> ish_xy
    return np.clip(vals, 0, (1 << bd) - 1)


def _ang_filter(src, idx, offset):
    """4-tap ADI at integer positions idx-1..idx+2 with phase offset."""
    f = TBL_ADI[offset]
    return (src[0] * f[0] + src[1] * f[1] + src[2] * f[2] + src[3] * f[3]
            + 64) >> 7


def _pred_ang(nb: Nbr, w, h, ipm, bd):
    """Angular modes, no-right layouts (xevem_ipred.c:462,568,640)."""
    mt_x, mt_y = int(TBL_DXDY[ipm][0]), int(TBL_DXDY[ipm][1])
    pos_max = w + h - 1
    maxv = (1 << bd) - 1
    dst = np.empty((h, w), dtype=np.int64)

    def clip(p):
        return max(-1, min(pos_max, p))

    if ipm < IPD_VER:
        # up-right fan: reads the up row shifted right per row
        for j in range(h):
            t_dx = ((j + 1) * mt_x) >> 10
            offset = (((j + 1) * mt_x) >> 5) - (t_dx << 5)
            f = TBL_ADI[offset]
            for i in range(w):
                xx = i + t_dx
                p = [nb.u(clip(xx - 1)), nb.u(clip(xx)),
                     nb.u(clip(xx + 1)), nb.u(clip(xx + 2))]
                v = (p[0] * f[0] + p[1] * f[1] + p[2] * f[2] + p[3] * f[3]
                     + 64) >> 7
                dst[j, i] = min(max(v, 0), maxv)
    elif ipm > IPD_HOR:
        # down-left fan: reads the left column shifted down per column
        for j in range(h):
            for i in range(w):
                t_dy = ((i + 1) * mt_y) >> 10
                offset = (((i + 1) * mt_y) >> 5) - (t_dy << 5)
                f = TBL_ADI[offset]
                yy = j + t_dy
                p = [nb.l(clip(yy - 1)), nb.l(clip(yy)),
                     nb.l(clip(yy + 1)), nb.l(clip(yy + 2))]
                v = (p[0] * f[0] + p[1] * f[1] + p[2] * f[2] + p[3] * f[3]
                     + 64) >> 7
                dst[j, i] = min(max(v, 0), maxv)
    else:
        # diagonal band between V and H: up row for the top-right part,
        # left column for the rest (ipred_ang_no_right)
        for j in range(h):
            for i in range(w):
                t_dy = ((i + 1) * mt_y) >> 10
                if j < t_dy:
                    t_dx = ((j + 1) * mt_x) >> 10
                    offset = (((j + 1) * mt_x) >> 5) - (t_dx << 5)
                    xx = i - t_dx
                    p = [nb.u(clip(xx + 1)), nb.u(clip(xx)),
                         nb.u(clip(xx - 1)), nb.u(clip(xx - 2))]
                else:
                    offset = (((i + 1) * mt_y) >> 5) - (t_dy << 5)
                    yy = j - t_dy
                    p = [nb.l(clip(yy + 1)), nb.l(clip(yy)),
                         nb.l(clip(yy - 1)), nb.l(clip(yy - 2))]
                f = TBL_ADI[offset]
                v = (p[0] * f[0] + p[1] * f[1] + p[2] * f[2] + p[3] * f[3]
                     + 64) >> 7
                dst[j, i] = min(max(v, 0), maxv)
    return dst


def _pred_hor_lr(nb: Nbr, w, h):
    if nb.avail_lr == LR_11:
        multi_w = LUT_SIZE_PLUS1[_log2(w)]
        le = np.array([nb.l(i) for i in range(h)], dtype=np.int64)
        ri = np.array([nb.r(i) for i in range(h)], dtype=np.int64)
        xs = np.arange(w, dtype=np.int64)
        return ((le[:, None] * (w - xs)[None, :]
                 + ri[:, None] * (xs + 1)[None, :]
                 + (w >> 1)) * multi_w) >> 12
    # LR_01: replicate the right column
    col = np.array([nb.r(i) for i in range(h)], dtype=np.int64)
    return np.repeat(col[:, None], w, axis=1)


def _pred_dc_lr(nb: Nbr, w, h):
    if nb.avail_lr == LR_11:
        dc = int(sum(nb.l(i) for i in range(h))
                 + sum(nb.r(i) for i in range(h))
                 + sum(nb.u(j) for j in range(w)))
        dc = _get_dc(dc + ((w + h + h) >> 1), w, h << 1)
    else:   # LR_01
        dc = int(sum(nb.r(i) for i in range(h))
                 + sum(nb.u(j) for j in range(w)))
        dc = _get_dc(dc + ((w + h) >> 1), w, h)
    return np.full((h, w), dc, dtype=np.int64)


def _pred_plane_r(nb: Nbr, w, h, bd):
    """ipred_plane, LR_01/LR_11 branch (mirrored around the right ref)."""
    w2, h2 = w >> 1, h >> 1
    idx_w = max(_log2(w) - 2, 0)
    idx_h = max(_log2(h) - 2, 0)
    im_h, is_h = _IB_MULT[idx_w], _IB_SHIFT[idx_w]
    im_v, is_v = _IB_MULT[idx_h], _IB_SHIFT[idx_h]
    coef_h = sum(x * (nb.u(w2 - x) - nb.u(w2 + x))
                 for x in range(1, w2 + 1))
    coef_v = sum(y * (nb.r(h2 - 1 + y) - nb.r(h2 - 1 - y))
                 for y in range(1, h2 + 1))
    a = (nb.r(h - 1) + nb.u(0)) << 4
    b = ((coef_h << 5) * im_h + (1 << (is_h - 1))) >> is_h
    c = ((coef_v << 5) * im_v + (1 << (is_v - 1))) >> is_v
    base = a - (h2 - 1) * c - (w2 - 1) * b + 16
    xs = np.arange(w, dtype=np.int64)
    ys = np.arange(h, dtype=np.int64)
    # temp2 starts at x = w-1 and gains b per step towards x = 0
    vals = (base + ys[:, None] * c + (w - 1 - xs)[None, :] * b) >> 5
    return np.clip(vals, 0, (1 << bd) - 1)


def _pred_bi_lr(nb: Nbr, w, h, bd):
    ish_x, ish_y = _log2(w), _log2(h)
    ref_up = np.array([nb.u(j) for j in range(w)], dtype=np.int64)
    ref_le = np.array([nb.l(i) for i in range(h)], dtype=np.int64)
    ref_ri = np.array([nb.r(i) for i in range(h)], dtype=np.int64)
    maxv = (1 << bd) - 1
    if nb.avail_lr == LR_11:
        multi_w = LUT_SIZE_PLUS1[ish_x]
        xs = np.arange(w, dtype=np.int64)
        ys = np.arange(h, dtype=np.int64)
        dst_tmp = ((ref_le[:, None] * (w - xs)[None, :]
                    + ref_ri[:, None] * (xs + 1)[None, :]
                    + (w >> 1)) * multi_w) >> 12
        tmp = (ref_up[None, :] * (h - 1 - ys)[:, None]
               + dst_tmp[h - 1][None, :] * (ys + 1)[:, None]
               + (h >> 1)) >> ish_y
        return (dst_tmp + tmp + 1) >> 1
    # LR_01 (mirrored ipred_bi)
    ish = min(ish_x, ish_y)
    ish_xy = ish_x + ish_y + 1
    offset = 1 << (ish_x + ish_y)
    wc = _TBL_WC[abs(ish_x - ish_y)]
    a = int(nb.u(-1))
    b = int(nb.r(h))
    if w == h:
        c = (a + b + 1) >> 1
    else:
        c = (((a << ish_x) + (b << ish_y)) * wc + (1 << (ish + 9))) >> (ish + 10)
    wt = (c << 1) - a - b
    up_d = b - ref_up
    ref_up_s = ref_up << ish_y
    ri_d = a - ref_ri
    ref_ri_s = ref_ri << ish_x
    wy = np.arange(h, dtype=np.int64) * wt
    # x runs w-1 -> 0; predx/ref_up accumulate per processed column
    ks = np.arange(1, w + 1, dtype=np.int64)        # processing order
    ys = np.arange(1, h + 1, dtype=np.int64)
    predx = ref_ri_s[:, None] + ri_d[:, None] * ks[None, :]
    refu_at = ref_up_s[None, :] + up_d[None, :] * ys[:, None]   # by column x
    wxy = wy[:, None] * (np.arange(w, dtype=np.int64))[None, :]  # per k-1
    vals = np.empty((h, w), dtype=np.int64)
    # column processed k-th (k=1..w) is x = w-k; wxy uses (k-1)*wy
    for k in range(1, w + 1):
        x = w - k
        vals[:, x] = ((predx[:, k - 1] << ish_y)
                      + (refu_at[:, x] << ish_x)
                      + wy * (k - 1) + offset) >> ish_xy
    return np.clip(vals, 0, maxv)


def _pred_ang_r(nb: Nbr, w, h, ipm, bd):
    """Angular modes, right-available layouts (xevem_ipred.c:503,619,746):
    fan < VER and the diagonal band switch to the right column per the
    reference's on_right/only_right variants."""
    mt_x, mt_y = int(TBL_DXDY[ipm][0]), int(TBL_DXDY[ipm][1])
    pos_max = w + h - 1
    maxv = (1 << bd) - 1
    dst = np.empty((h, w), dtype=np.int64)

    def clip(p):
        return max(-1, min(pos_max, p))

    def filt(p, offset):
        f = TBL_ADI[offset]
        v = (p[0] * f[0] + p[1] * f[1] + p[2] * f[2] + p[3] * f[3]
             + 64) >> 7
        return min(max(v, 0), maxv)

    if ipm < IPD_VER:
        # ipred_ang_less_ver_on_right
        for j in range(h):
            t_dx = ((j + 1) * mt_x) >> 10
            offset = (((j + 1) * mt_x) >> 5) - (t_dx << 5)
            for i in range(w):
                if i < w - t_dx:
                    xx = i + t_dx
                    p = [nb.u(clip(xx - 1)), nb.u(clip(xx)),
                         nb.u(clip(xx + 1)), nb.u(clip(xx + 2))]
                    dst[j, i] = filt(p, offset)
                else:
                    t_dy = ((w - i) * mt_y) >> 10
                    off2 = (((w - i) * mt_y) >> 5) - (t_dy << 5)
                    yy = j - t_dy
                    p = [nb.r(clip(yy + 1)), nb.r(clip(yy)),
                         nb.r(clip(yy - 1)), nb.r(clip(yy - 2))]
                    dst[j, i] = filt(p, off2)
    elif ipm > IPD_HOR:
        # ipred_ang_gt_hor_on_right
        for j in range(h):
            for i in range(w):
                t_dy = ((w - i) * mt_y) >> 10
                if j < t_dy:
                    t_dx = ((w - i) * mt_x) >> 10
                    offset = (((w - i) * mt_x) >> 5) - (t_dx << 5)
                    xx = i + t_dx
                    p = [nb.u(clip(xx - 1)), nb.u(clip(xx)),
                         nb.u(clip(xx + 1)), nb.u(clip(xx + 2))]
                else:
                    offset = (((w - i) * mt_y) >> 5) - (t_dy << 5)
                    yy = j - t_dy
                    p = [nb.r(clip(yy + 1)), nb.r(clip(yy)),
                         nb.r(clip(yy - 1)), nb.r(clip(yy - 2))]
                dst[j, i] = filt(p, offset)
    else:
        # ipred_ang_only_right (diagonal band, LR_01 only)
        for j in range(h):
            for i in range(w):
                t_dy = ((i + 1) * mt_y) >> 10
                if j < t_dy:
                    t_dx = ((j + 1) * mt_x) >> 10
                    offset = (((j + 1) * mt_x) >> 5) - (t_dx << 5)
                    xx = i - t_dx
                    p = [nb.u(clip(xx + 1)), nb.u(clip(xx)),
                         nb.u(clip(xx - 1)), nb.u(clip(xx - 2))]
                else:
                    t_dy = ((w - i) * mt_y) >> 10
                    offset = (((w - i) * mt_y) >> 5) - (t_dy << 5)
                    yy = j + t_dy
                    p = [nb.r(clip(yy - 1)), nb.r(clip(yy)),
                         nb.r(clip(yy + 1)), nb.r(clip(yy + 2))]
                dst[j, i] = filt(p, offset)
    return dst


def _ang_dispatch(nb: Nbr, w, h, ipm, bd):
    """xevem_ipred default branch: family + LR variant selection."""
    fam = 0 if ipm < IPD_VER else (1 if ipm > IPD_HOR else 2)
    if fam < 2:
        use_r = bool(nb.avail_lr & 2)
    else:
        use_r = nb.avail_lr == LR_01
    if use_r:
        return _pred_ang_r(nb, w, h, ipm, bd)
    return _pred_ang(nb, w, h, ipm, bd)


def ipred_main(ipm, nb: Nbr, w, h, bd):
    lr = nb.avail_lr
    if ipm == IPD_VER:
        return _pred_ver(nb, w, h)
    if ipm == IPD_HOR:
        return _pred_hor_lr(nb, w, h) if lr in (LR_01, LR_11)             else _pred_hor(nb, w, h)
    if ipm == IPD_DC:
        return _pred_dc_lr(nb, w, h) if lr in (LR_01, LR_11)             else _pred_dc(nb, w, h)
    if ipm == IPD_PLN:
        return _pred_plane_r(nb, w, h, bd) if lr in (LR_01, LR_11)             else _pred_plane(nb, w, h, bd)
    if ipm == IPD_BI:
        return _pred_bi_lr(nb, w, h, bd) if lr in (LR_01, LR_11)             else _pred_bi(nb, w, h, bd)
    return _ang_dispatch(nb, w, h, ipm, bd)


def ipred_uv_main(ipm_c, ipm_l, nb: Nbr, w, h, bd):
    """Chroma prediction (xevem_ipred.c:828, xevem_ipred_uv)."""
    if ipm_c == IPD_DM_C:
        conv, ok = conv_luma_to_chroma(ipm_l)
        if ok:
            ipm_c = conv
    lr = nb.avail_lr
    right = lr in (LR_01, LR_11)
    if ipm_c == IPD_DM_C:
        if ipm_l == IPD_PLN:
            return _pred_plane_r(nb, w, h, bd) if right \
                else _pred_plane(nb, w, h, bd)
        return _ang_dispatch(nb, w, h, ipm_l, bd)
    if ipm_c == IPD_DC_C:
        return _pred_dc_lr(nb, w, h) if right else _pred_dc(nb, w, h)
    if ipm_c == IPD_HOR_C:
        return _pred_hor_lr(nb, w, h) if right else _pred_hor(nb, w, h)
    if ipm_c == IPD_VER_C:
        return _pred_ver(nb, w, h)
    if ipm_c == IPD_BI_C:
        return _pred_bi_lr(nb, w, h, bd) if right \
            else _pred_bi(nb, w, h, bd)
    raise ValueError(f"bad chroma mode {ipm_c}")


# ---------------------------------------------------------------------------
# MPM / extended MPM / full ranking (xevem_get_mpm)
# ---------------------------------------------------------------------------

def _fill_from_list(mpm_ext, cnt, cand_list, mpm):
    for cand in cand_list:
        if cnt > 7:
            break
        if cand in mpm or cand in mpm_ext[:cnt]:
            continue
        mpm_ext[cnt] = cand
        cnt += 1
    return cnt


_DEFAULT_TAIL = [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN, IPD_DIA_L, IPD_DIA_U,
                 IPD_VER + 4, IPD_HOR - 4]


def get_mpm_main(x_scu, y_scu, scuw, map_cod, map_if, map_ipm, w_scu):
    """Returns (mpm[2], mpm_ext[8], pims[33]).

    ipm_r (right-neighbour mode) participates only under SUCO coding
    order; in raster order the right SCU is never coded first, but the
    derivation still guards on the coded map exactly like the reference.
    """
    ipm_l = ipm_u = IPD_DC
    valid_l = valid_u = valid_r = False
    ipm_r = IPD_DC
    if x_scu > 0 and map_if[y_scu, x_scu - 1] and map_cod[y_scu, x_scu - 1]:
        ipm_l = int(map_ipm[y_scu, x_scu - 1])
        valid_l = True
    if y_scu > 0 and map_if[y_scu - 1, x_scu] and map_cod[y_scu - 1, x_scu]:
        ipm_u = int(map_ipm[y_scu - 1, x_scu])
        valid_u = True
    if (x_scu + scuw < w_scu and map_if[y_scu, x_scu + scuw] and
            map_cod[y_scu, x_scu + scuw]):
        ipm_r = int(map_ipm[y_scu, x_scu + scuw])
        if valid_l and valid_u:
            if ipm_l == ipm_u:
                ipm_u = ipm_r
            else:
                valid_r = True
        elif not valid_l:
            ipm_l = ipm_r
        else:
            ipm_u = ipm_r
        if valid_r and (ipm_l == ipm_r or ipm_u == ipm_r):
            valid_r = False

    mpm = [min(ipm_l, ipm_u), max(ipm_l, ipm_u)]
    if mpm[0] == mpm[1]:
        m1 = mpm[1]
        mpm[0] = IPD_DC
        mpm[1] = IPD_BI if m1 == IPD_DC else m1

    ext = [0] * 8

    def first_two_nonang():
        # both MPMs non-angular: seed with the missing one of DC/BI/PLN
        if mpm[0] == IPD_DC:
            ext[0] = IPD_PLN if mpm[1] == IPD_BI else IPD_BI
        elif mpm[0] == IPD_PLN:
            ext[0] = IPD_DC

    if valid_r:
        if mpm[0] < 3 and mpm[1] < 3:
            if ipm_r < 3:
                first_two_nonang()
                ext[1:8] = [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L,
                            IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4]
            else:
                lst = [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_PLN, IPD_DIA_L,
                       IPD_DIA_U, IPD_VER + 4, IPD_HOR - 4, IPD_VER - 4,
                       IPD_HOR + 4]
                first_two_nonang()
                ext[1] = ipm_r
                ext[2] = ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2
                ext[3] = (ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                          else ipm_r + 2)
                _fill_from_list(ext, 4, lst, mpm)
        elif mpm[0] < 3:
            if ipm_r < 3:
                if mpm[0] == IPD_PLN:
                    ext[0], ext[1] = IPD_BI, IPD_DC
                else:
                    ext[0] = IPD_DC if mpm[0] == IPD_BI else IPD_BI
                    ext[1] = IPD_PLN
                m1 = mpm[1]
                if m1 > IPD_CNT - 3:
                    ext[2] = IPD_CNT - 2 if m1 == IPD_CNT - 1 else IPD_CNT - 1
                    ext[3:8] = [IPD_CNT - 3, IPD_CNT - 4, IPD_CNT - 5,
                                IPD_HOR, IPD_DIA_R]
                elif m1 < 5:
                    ext[2] = 4 if m1 == 3 else 3
                    ext[3:8] = [5, 6, 7, IPD_VER, IPD_DIA_R]
                else:
                    ext[2:6] = [m1 + 2, m1 - 2, m1 + 1, m1 - 1]
                    if 13 <= m1 <= 23:
                        ext[6], ext[7] = m1 - 5, m1 + 5
                    elif m1 > 23:
                        ext[6], ext[7] = m1 - 5, m1 - 10
                    else:
                        ext[6], ext[7] = m1 + 5, m1 + 10
            else:
                m1 = mpm[1]
                lst = [
                    ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2,
                    (ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                     else ipm_r + 2),
                    m1 + 1 if m1 in (3, 4) else m1 - 2,
                    m1 - 1 if m1 in (IPD_CNT - 1, IPD_CNT - 2) else m1 + 2,
                    (ipm_r + m1 + 1) >> 1,
                ]
                lst.append((lst[4] + ipm_r + 1) >> 1)
                lst.append((lst[4] + m1 + 1) >> 1)
                lst += _DEFAULT_TAIL
                if mpm[0] == IPD_PLN:
                    ext[0], ext[1] = IPD_BI, IPD_DC
                else:
                    ext[0] = IPD_DC if mpm[0] == IPD_BI else IPD_BI
                    ext[1] = IPD_PLN
                ext[2] = ipm_r
                _fill_from_list(ext, 3, lst, mpm)
        else:
            if ipm_r < 3:
                m0, m1 = mpm
                lst = [
                    m0 + 1 if m0 in (3, 4) else m0 - 2,
                    m0 - 1 if m0 == IPD_CNT - 2 else m0 + 2,
                    m1 + 1 if m1 == 4 else m1 - 2,
                    m1 - 1 if m1 in (IPD_CNT - 1, IPD_CNT - 2) else m1 + 2,
                    (m0 + m1 + 1) >> 1,
                ]
                lst.append((lst[4] + m0 + 1) >> 1)
                lst.append((lst[4] + m1 + 1) >> 1)
                lst += _DEFAULT_TAIL
                ext[0] = ipm_r
                ext[1] = IPD_DC if ipm_r == IPD_BI else IPD_BI
                _fill_from_list(ext, 2, lst, mpm)
            else:
                m0, m1 = mpm
                lst = [
                    m0 + 1 if m0 in (3, 4) else m0 - 2,
                    m0 - 1 if m0 == IPD_CNT - 2 else m0 + 2,
                    m1 + 1 if m1 == 4 else m1 - 2,
                    m1 - 1 if m1 in (IPD_CNT - 1, IPD_CNT - 2) else m1 + 2,
                    ipm_r + 1 if ipm_r in (3, 4) else ipm_r - 2,
                    (ipm_r - 1 if ipm_r in (IPD_CNT - 1, IPD_CNT - 2)
                     else ipm_r + 2),
                    ((m0 + ipm_r + 1) >> 1 if ipm_r < m1
                     else (m0 + m1 + 1) >> 1),
                    ((m0 + m1 + 1) >> 1 if ipm_r < m0
                     else (m1 + ipm_r + 1) >> 1),
                ]
                lst += _DEFAULT_TAIL
                ext[0], ext[1], ext[2] = IPD_BI, IPD_DC, ipm_r
                _fill_from_list(ext, 3, lst, mpm)
    else:
        if mpm[0] < 3 and mpm[1] < 3:
            first_two_nonang()
            ext[1:8] = [IPD_VER, IPD_HOR, IPD_DIA_R, IPD_DIA_L, IPD_DIA_U,
                        IPD_VER + 4, IPD_HOR - 4]
        elif mpm[0] < 3:
            if mpm[0] == IPD_PLN:
                ext[0], ext[1] = IPD_BI, IPD_DC
            else:
                ext[0] = IPD_DC if mpm[0] == IPD_BI else IPD_BI
                ext[1] = IPD_PLN
            m1 = mpm[1]
            if m1 > IPD_CNT - 3:
                ext[2] = IPD_CNT - 2 if m1 == IPD_CNT - 1 else IPD_CNT - 1
                ext[3:8] = [IPD_CNT - 3, IPD_CNT - 4, IPD_CNT - 5,
                            IPD_HOR, IPD_DIA_R]
            elif m1 < 5:
                ext[2] = 4 if m1 == 3 else 3
                ext[3:8] = [5, 6, 7, IPD_VER, IPD_DIA_R]
            else:
                ext[2:6] = [m1 + 2, m1 - 2, m1 + 1, m1 - 1]
                if 13 <= m1 <= 23:
                    ext[6], ext[7] = m1 - 5, m1 + 5
                elif m1 > 23:
                    ext[6], ext[7] = m1 - 5, m1 - 10
                else:
                    ext[6], ext[7] = m1 + 5, m1 + 10
        else:
            m0, m1 = mpm
            lst = [
                m0 + 1 if m0 in (3, 4) else m0 - 2,
                m0 - 1 if m0 == IPD_CNT - 2 else m0 + 2,
                m1 + 1 if m1 == 4 else m1 - 2,
                m1 - 1 if m1 in (IPD_CNT - 1, IPD_CNT - 2) else m1 + 2,
                (m0 + m1 + 1) >> 1,
            ]
            lst.append((lst[4] + m0 + 1) >> 1)
            lst.append((lst[4] + m1 + 1) >> 1)
            lst += _DEFAULT_TAIL
            ext[0], ext[1] = IPD_BI, IPD_DC
            _fill_from_list(ext, 2, lst, mpm)

    # full 33-mode ranking: mpm, then ext, then the default list
    included = [False] * IPD_CNT
    pims = []
    for m in list(mpm) + ext + INTRA_MODE_LIST:
        if not included[m]:
            included[m] = True
            pims.append(m)
    assert len(pims) == IPD_CNT
    return mpm, ext, pims
