"""Exact-integer reference kernels (numpy) for the EVC Baseline tool-set.

These are the *bit-exact semantics* of the codec's pixel/coefficient math:
  - forward / inverse DCT-2 (reference: src_base/xeve_tq.c:40-404,
    src_base/xeve_itdq.c:34-500)
  - quantization (xeve_tq.c:651-730) and dequantization (xeve_itdq.c:441-460)
  - intra prediction, 5 Baseline modes (src_base/xeve_ipred.c:104-228)
  - reconstruction clip (src_base/xeve_recon.c:35)
  - deblocking filter (src_base/xeve_df.c:89-251)

They serve as golden oracles for the JAX/Pallas TPU kernels, and as the
reconstruction path of the conformance decoder.  Everything operates on
int32/int64 numpy arrays; no floats in the normative paths.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    TM, SCAN, QUANT_SCALE, DQUANT_SCALE_B, DF_ST,
    MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT, QUANT_IQUANT_SHIFT,
    IPD_DC_B, IPD_HOR_B, IPD_VER_B, IPD_UL_B, IPD_UR_B,
    SLICE_I,
)

# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def tx_shift1(log2_w: int, bit_depth: int) -> int:
    return log2_w - 1 + bit_depth - 8


def tx_shift2(log2_h: int) -> int:
    return log2_h + 6


def forward_dct2(resi: np.ndarray, bit_depth: int) -> np.ndarray:
    """Forward 2-D DCT-2 on an (h, w) residual block, output int (s16 range).

    Matches xeve_trans (xeve_tq.c:396): rows first at shift 0 into 32-bit,
    then columns with the combined shift (rounded).
    """
    h, w = resi.shape
    tw = TM[w]  # (w, w)
    th = TM[h]
    s = tx_shift1(w.bit_length() - 1, bit_depth) + tx_shift2(h.bit_length() - 1)
    # stage 1: horizontal transform of each row: tmp[u, j] -> rows j, freq u
    # reference computes dst[u*line + j] = sum_k tm_w[u][k] * src[j*w + k]
    tmp = tw.astype(np.int64) @ resi.astype(np.int64).T  # (w, h): [u, j]
    # stage 2: vertical transform over j with combined shift
    out = th.astype(np.int64) @ tmp.T  # (h, w): [v, u]
    add = 1 << (s - 1) if s > 0 else 0
    out = (out + add) >> s
    return out.astype(np.int32)  # (h, w) coef[v][u] raster = freq row v, col u


def inverse_dct2(coef: np.ndarray, bit_depth: int) -> np.ndarray:
    """Inverse 2-D DCT-2, matches xeve_itrans (xeve_itdq.c:465): columns
    first at shift 0 (32-bit, clipped), then rows with shift 7+(12-(bd-8)),
    output clipped to signed 16-bit."""
    h, w = coef.shape
    th = TM[h]
    tw = TM[w]
    # stage 1 (columns): dst[j*h? ...] = sum_v tm_h[v][k] * coef[v][j]
    tmp = th.astype(np.int64).T @ coef.astype(np.int64)  # (h, w): [k, j]
    tmp = np.clip(tmp, -(2 ** 31) + 1, 2 ** 31 - 1)      # ITX_CLIP_32
    s = 7 + (12 - (bit_depth - 8))
    add = 1 << (s - 1)
    out = (tmp @ tw.astype(np.int64)) + add              # (h, w): [k, n]
    out >>= s
    out = np.clip(out, -(1 << MAX_TX_DYNAMIC_RANGE), (1 << MAX_TX_DYNAMIC_RANGE) - 1)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def quant(coef: np.ndarray, qp: int, slice_type: int, bit_depth: int,
          tool_iqt: int = 0) -> tuple[np.ndarray, int]:
    """Scalar (deadzone) quantization, matches xeve_quant_nnz's non-RDOQ path
    (xeve_tq.c:704-727).  Returns (levels, nnz)."""
    h, w = coef.shape
    log2_size = ((w.bit_length() - 1) + (h.bit_length() - 1)) >> 1
    scale = int(QUANT_SCALE[tool_iqt][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    shift = QUANT_SHIFT + tr_shift + qp // 6
    offset = (171 if slice_type == SLICE_I else 85) << (shift - 9)
    c = coef.astype(np.int64)
    lev = (np.abs(c) * scale + offset) >> shift
    lev = np.clip(lev, 0, 32767)
    out = np.where(c < 0, -lev, lev).astype(np.int32)
    return out, int(np.count_nonzero(out))


def dequant(levels: np.ndarray, qp: int, bit_depth: int,
            iqt: int = 0) -> np.ndarray:
    """Matches xeve_dquant + scale derivation (xeve_itdq.c:441,546; IQT
    scale table xevem_tbl.c:53)."""
    from ..constants import DQUANT_SCALE_MAIN
    h, w = levels.shape
    log2_size = ((w.bit_length() - 1) + (h.bit_length() - 1)) >> 1
    ns_shift = 8 if ((w.bit_length() - 1) + (h.bit_length() - 1)) & 1 else 0
    ns_scale = 181 if ((w.bit_length() - 1) + (h.bit_length() - 1)) & 1 else 1
    tbl = DQUANT_SCALE_MAIN if iqt else DQUANT_SCALE_B
    scale = int(tbl[qp % 6]) << (qp // 6)
    tr_shift = MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    shift = QUANT_IQUANT_SHIFT - QUANT_SHIFT - tr_shift + ns_shift
    offset = 0 if shift == 0 else 1 << (shift - 1)
    lev = (levels.astype(np.int64) * (scale * ns_scale) + offset) >> shift
    return np.clip(lev, -32768, 32767).astype(np.int32)


def forward_ats(resi: np.ndarray, ats_mode: int, bit_depth: int) -> np.ndarray:
    """Forward DST7/DCT8 2-D transform (xeve_t_MxN_ats_intra shifts,
    xevem_tq.c:684-687): horizontal stage then vertical, int16 intermediate.
    ats_mode bit1 selects the horizontal transform, bit0 the vertical."""
    from ..constants_ats import TR_DST7, TR_DCT8
    h, w = resi.shape
    tm_h = (TR_DCT8 if (ats_mode >> 1) else TR_DST7)[w]
    tm_v = (TR_DCT8 if (ats_mode & 1) else TR_DST7)[h]
    s1 = (w.bit_length() - 1) - 1 + bit_depth - 8
    s2 = (h.bit_length() - 1) + 6
    a = resi.astype(np.int64)
    t = (a @ tm_h.T + (1 << (s1 - 1))) >> s1
    t = np.clip(t, -32768, 32767)
    c = (tm_v @ t + (1 << (s2 - 1))) >> s2
    return np.clip(c, -32768, 32767).astype(np.int32)


def inverse_ats(coef: np.ndarray, ats_mode: int, bit_depth: int) -> np.ndarray:
    """Inverse DST7/DCT8 2-D transform (xeve_it_MxN_ats_intra,
    xevem_itdq.c:278): ats_mode bit1 selects the horizontal transform,
    bit0 the vertical; bit==0 -> DST-7, bit==1 -> DCT-8."""
    from ..constants_ats import TR_DST7, TR_DCT8
    h, w = coef.shape
    tm_v = (TR_DCT8 if (ats_mode & 1) else TR_DST7)[h]
    tm_h = (TR_DCT8 if (ats_mode >> 1) else TR_DST7)[w]
    a = coef.astype(np.int64)
    b1 = (a.T @ tm_v + (1 << 6)) >> 7
    b1 = np.clip(b1, -32768, 32767)
    s2 = 20 - bit_depth
    out = (b1.T @ tm_h + (1 << (s2 - 1))) >> s2
    return np.clip(out, -32768, 32767).astype(np.int32)


def ats_inter_trs(ats_inter_info: int, log2_cuw: int, log2_cuh: int):
    """(use_ats, ats_mode) for an SBT sub-TB (get_ats_inter_trs,
    xevem_util.c:2805)."""
    if ats_inter_info == 0:
        return 0, 0
    if log2_cuw > 5 or log2_cuh > 5:
        return 0, 0
    idx = ats_inter_info & 0xF
    pos = (ats_inter_info >> 4) & 0xF
    if idx in (2, 4):   # horizontal split
        t_h = 0
        t_v = 1 if pos == 0 else 0
    else:
        t_v = 0
        t_h = 1 if pos == 0 else 0
    return 1, (t_h << 1) | t_v


def ats_inter_tu_size(ats_inter_info: int, log2_cuw: int, log2_cuh: int):
    """Sub-TB dims (get_tu_size, xevem_util.c:2892)."""
    idx = ats_inter_info & 0xF
    if idx == 0:
        return log2_cuw, log2_cuh
    quad = idx in (3, 4)
    if idx in (2, 4):   # horizontal
        return log2_cuw, log2_cuh - (2 if quad else 1)
    return log2_cuw - (2 if quad else 1), log2_cuh


def inverse_dct2_iqt(coef: np.ndarray, bit_depth: int) -> np.ndarray:
    """IQT inverse 2-D DCT-2 (xevem_itdq.c:553 xeve_itrans, iqt path):
    per-stage rounding shifts with 16-bit clamps between stages."""
    h, w = coef.shape
    tm_h = TM[h].astype(np.int64)
    tm_w = TM[w].astype(np.int64)
    a = coef.astype(np.int64)
    # stage 1 over the height transform: B1[j][n] = sum_k A[k][j]*TMh[k][n]
    b1 = (a.T @ tm_h + (1 << 6)) >> 7
    b1 = np.clip(b1, -32768, 32767)
    s2 = 12 - (bit_depth - 8)
    out = (b1.T @ tm_w + (1 << (s2 - 1))) >> s2
    return np.clip(out, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Intra prediction (Baseline): 5 modes, operating on gathered neighbours
# ---------------------------------------------------------------------------


def gather_neighbors(rec: np.ndarray, x: int, y: int, w: int, h: int,
                     avail_up_row: np.ndarray, avail_left_col: np.ndarray,
                     avail_up_left: bool, bit_depth: int,
                     unit: int = 4) -> tuple[np.ndarray, np.ndarray, int]:
    """Gather up / left / up-left reference samples for one block, following
    xeve_get_nbr (xeve_ipred.c:33-102).

    avail_up_row: bool per `unit`-wide segment of the (w+h) up samples.
    avail_left_col: bool per `unit`-tall segment of the (h+w) left samples.
    Returns (up[w+h], left[h+w], up_left) already defaulted to mid-gray when
    unavailable.
    """
    mid = 1 << (bit_depth - 1)
    n_up = w + h
    n_le = h + w
    up = np.full(n_up, mid, dtype=np.int32)
    left = np.full(n_le, mid, dtype=np.int32)
    H, W = rec.shape
    for i in range(n_up // unit):
        if avail_up_row[i]:
            xs = x + i * unit
            up[i * unit:(i + 1) * unit] = rec[y - 1, xs:xs + unit]
    for i in range(n_le // unit):
        if avail_left_col[i]:
            ys = y + i * unit
            left[i * unit:(i + 1) * unit] = rec[ys:ys + unit, x - 1]
    up_left = int(rec[y - 1, x - 1]) if avail_up_left else mid
    return up, left, up_left


def ipred(mode: int, up: np.ndarray, left: np.ndarray, up_left: int,
          w: int, h: int) -> np.ndarray:
    """Baseline intra prediction from gathered neighbours (xeve_ipred.c)."""
    if mode == IPD_VER_B:
        return np.broadcast_to(up[:w], (h, w)).astype(np.int32)
    if mode == IPD_HOR_B:
        return np.broadcast_to(left[:h, None], (h, w)).astype(np.int32)
    if mode == IPD_DC_B:
        dc = (int(left[:h].sum()) + int(up[:w].sum()) + w) >> ((w.bit_length() - 1) + 1)
        return np.full((h, w), dc, dtype=np.int32)
    if mode == IPD_UL_B:
        out = np.empty((h, w), dtype=np.int32)
        ii = np.arange(h)[:, None]
        jj = np.arange(w)[None, :]
        diag = ii - jj
        # diag > 0 -> left[diag-1]; diag == 0 -> up_left; diag < 0 -> up[-diag-1]
        le = left[np.clip(diag - 1, 0, len(left) - 1)]
        upv = up[np.clip(-diag - 1, 0, len(up) - 1)]
        out = np.where(diag > 0, le, np.where(diag == 0, up_left, upv))
        return out.astype(np.int32)
    if mode == IPD_UR_B:
        ii = np.arange(h)[:, None]
        jj = np.arange(w)[None, :]
        idx = ii + jj + 1
        return ((up[idx] + left[idx]) >> 1).astype(np.int32)
    raise ValueError(f"bad intra mode {mode}")


def recon_block(pred: np.ndarray, resi: np.ndarray | None, bit_depth: int) -> np.ndarray:
    """xeve_recon_blk (xeve_recon.c:35)."""
    if resi is None:
        t = pred
    else:
        # reference adds in s16: coef + pred wraps at 16 bits before clip
        t = ((resi + pred).astype(np.int16)).astype(np.int32)
    return np.clip(t, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Deblocking (Baseline, H.264-like simple filter). xeve_df.c:89-251
# ---------------------------------------------------------------------------


def _df_delta(A, B, C, D):
    """d = (A - 4B + 4C - D) / 8 with C-style truncation toward zero."""
    num = A - 4 * B + 4 * C - D
    return np.sign(num) * (np.abs(num) // 8)


def deblock_line_luma(A, B, C, D, st, bit_depth):
    """Filter across one 4-sample luma edge segment; arrays int32.
    Returns new (A, B, C, D)."""
    d = _df_delta(A, B, C, D)
    aabs = np.abs(d)
    sign = np.sign(d)
    t16 = np.maximum(0, (aabs - st) << 1)
    clip = np.maximum(0, aabs - t16)
    d1 = sign * clip
    clip2 = clip >> 1
    ad = A - D
    ad4 = np.sign(ad) * (np.abs(ad) // 4)
    d2 = np.clip(ad4, -clip2, clip2)
    An = A - d2
    Bn = B + d1
    Cn = C - d1
    Dn = D + d2
    mx = (1 << bit_depth) - 1
    return (np.clip(An, 0, mx), np.clip(Bn, 0, mx),
            np.clip(Cn, 0, mx), np.clip(Dn, 0, mx))


def deblock_line_chroma(A, B, C, D, st, bit_depth):
    d = _df_delta(A, B, C, D)
    aabs = np.abs(d)
    sign = np.sign(d)
    t16 = np.maximum(0, (aabs - st) << 1)
    clip = np.maximum(0, aabs - t16)
    d1 = sign * clip
    mx = (1 << bit_depth) - 1
    return (A, np.clip(B + d1, 0, mx), np.clip(C - d1, 0, mx), D)


def df_strength(qp: int, idx: int, bit_depth: int) -> int:
    return int(DF_ST[idx][qp]) << (bit_depth - 8)
