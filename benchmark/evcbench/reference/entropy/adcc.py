"""ADCC — advanced coefficient coding (Main profile).

Sig-map + greater-A/B flags + Golomb-Rice remainders over 4x4 coefficient
groups, with a context-coded last-position prefix.  Semantics per
ISO/IEC 23094-1; structure cross-checked against the reference encoder
(xevem_eco.c:1018-1277 xeve_eco_adcc/code_positionLastXY, context
templates xevem_util.c:2579-2750).

Both directions live here: `decode_block` for the conformance decoder,
`encode_block` for the encoder's entropy stage.
"""
from __future__ import annotations

import numpy as np

from ..constants import SCAN

LOG2_CG_SIZE = 4
CAFLAG_NUMBER = 8
GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7] + [8] * 8 + \
    [9] * 8 + [10] * 16 + [11] * 16
MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96]
GO_RICE_RANGE = [6, 5, 6, 3, 3, 3, 3, 3, 3, 3]
GO_RICE_PARA = [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3]

NUM_CTX_LAST_SIG_COEFF_LUMA = 18
NUM_CTX_SIG_COEFF_LUMA = 39
NUM_CTX_SIG_COEFF_LUMA_TU = 13
NUM_CTX_GTX_LUMA = 13

_INV_SCAN = {}


def _scans(w, h):
    scan = SCAN[(w, h)]
    key = (w, h)
    if key not in _INV_SCAN:
        inv = np.empty_like(scan)
        inv[scan] = np.arange(len(scan))
        _INV_SCAN[key] = inv
    return scan, _INV_SCAN[key]


def _log2(v):
    # XEVE_LOG2 is table-based with log2(0) == 0 (xeve_tbl.c:50); the
    # chroma last-position shift relies on that for 8-wide TBs
    return max(int(v).bit_length() - 1, 0)


def last_pos_xy_para(ch_type, width, height):
    """Context offsets/shifts for the last-position prefix (cm_init only;
    xevem_util.c:2579)."""
    cw = max(_log2(width) - 2, 0)
    ch = max(_log2(height) - 2, 0)
    if ch_type != 0:
        return 0, 0, cw - _log2(width >> 4), ch - _log2(height >> 4)
    off_x = cw * 3 + ((cw + 1) >> 2)
    off_y = ch * 3 + ((ch + 1) >> 2)
    sh_x = (cw + 3) >> 2
    sh_y = (ch + 3) >> 2
    if cw >= 4:
        off_x += ((width >> 6) << 1) + (width >> 7)
        sh_x = 2
    if ch >= 4:
        off_y += ((height >> 6) << 1) + (height >> 7)
        sh_y = 2
    return off_x, off_y, sh_x, sh_y


def _ctx_template(coef, blkpos, width, height, pred):
    """Sum of `pred` over the 5-position template right/below blkpos."""
    log2_w = _log2(width)
    pos_y = blkpos >> log2_w
    pos_x = blkpos - (pos_y << log2_w)
    n = 0
    if pos_x < width - 1:
        n += pred(coef[blkpos + 1])
        if pos_x < width - 2:
            n += pred(coef[blkpos + 2])
        if pos_y < height - 1:
            n += pred(coef[blkpos + width + 1])
    if pos_y < height - 1:
        n += pred(coef[blkpos + width])
        if pos_y < height - 2:
            n += pred(coef[blkpos + 2 * width])
    return n


def ctx_sig_coeff_inc(coef, blkpos, width, height, ch_type):
    log2_w = _log2(width)
    pos_y = blkpos >> log2_w
    pos_x = blkpos - (pos_y << log2_w)
    diag = pos_x + pos_y
    n = _ctx_template(coef, blkpos, width, height, lambda v: int(v != 0))
    ctx_idx = min(n, 4) + 1
    if diag < 2:
        ctx_idx = min(ctx_idx, 2)
    if ch_type == 0:
        ctx_ofs = 0 if diag < 2 else (2 if diag < 5 else 7)
    else:
        ctx_ofs = 0 if diag < 2 else 2
    return ctx_ofs + ctx_idx


def ctx_gtx_inc(coef, blkpos, width, height, ch_type, thr):
    log2_w = _log2(width)
    pos_y = blkpos >> log2_w
    pos_x = blkpos - (pos_y << log2_w)
    diag = pos_x + pos_y
    n = _ctx_template(coef, blkpos, width, height,
                      lambda v: int(abs(int(v)) > thr))
    n = min(n, 3) + 1
    if ch_type == 0:
        n += 0 if diag < 3 else (4 if diag < 10 else 8)
    return n


def rice_para(coef, blkpos, width, height, base_level):
    s = _ctx_template(coef, blkpos, width, height, lambda v: abs(int(v)))
    s = max(min(s - 5 * base_level, 31), 0)
    return GO_RICE_PARA[s]


# ---------------------------------------------------------------------------
# encode (xevem_eco.c:1103 xeve_eco_adcc)
#
# Contexts are computed on the FINAL coefficient array.  This is bit-exact
# vs the decoder's staged evaluation because the 5-position template only
# references strictly-later zigzag positions, which at every evaluation
# point hold values whose predicate (!=0 / >1 / >2 / abs) already equals
# the final one (proof: sig pass sees !=0 of final; gtA templates are
# gtA-updated before use; gtB templates are all abs==1; rice templates are
# remainder-finalized in loop order).
# ---------------------------------------------------------------------------


def _write_remain_exgolomb(sbac, symbol: int, rparam: int):
    """code_coef_remain_exgolomb (xevem_eco.c:1018)."""
    rng = GO_RICE_RANGE[rparam]
    if symbol < (rng << rparam):
        length = symbol >> rparam
        sbac.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
        if rparam:
            sbac.encode_bins_ep(symbol & ((1 << rparam) - 1), rparam)
    else:
        length = rparam
        code_number = symbol - (rng << rparam)
        while code_number >= (1 << length):
            code_number -= (1 << length)
            length += 1
        n = rng + length + 1 - rparam
        sbac.encode_bins_ep((1 << n) - 2, n)
        if length:
            sbac.encode_bins_ep(code_number, length)


def _encode_last_xy(sbac, ctx, last_x, last_y, width, height, ch_type,
                    cm_init):
    """code_positionLastXY (xevem_eco.c:1042)."""
    off = 0 if ch_type == 0 else (NUM_CTX_LAST_SIG_COEFF_LUMA if cm_init
                                  else 11)
    if cm_init:
        bx, by, sx, sy = last_pos_xy_para(ch_type, width, height)
    else:
        bx = by = sx = sy = 0
    gx = GROUP_IDX[last_x]
    gy = GROUP_IDX[last_y]
    for b in range(gx):
        sbac.encode_bin(1, ctx.last_sig_coeff_x_prefix, off + bx + (b >> sx))
    if gx < GROUP_IDX[width - 1]:
        sbac.encode_bin(0, ctx.last_sig_coeff_x_prefix, off + bx + (gx >> sx))
    for b in range(gy):
        sbac.encode_bin(1, ctx.last_sig_coeff_y_prefix, off + by + (b >> sy))
    if gy < GROUP_IDX[height - 1]:
        sbac.encode_bin(0, ctx.last_sig_coeff_y_prefix, off + by + (gy >> sy))
    if gx > 3:
        cnt = (gx - 2) >> 1
        sbac.encode_bins_ep(last_x - MIN_IN_GROUP[gx], cnt)
    if gy > 3:
        cnt = (gy - 2) >> 1
        sbac.encode_bins_ep(last_y - MIN_IN_GROUP[gy], cnt)


def encode_block(sbac, ctx, levels: np.ndarray, ch_type: int):
    """Encode one TB of quantized levels ((h, w) int array, at least one
    nonzero).  Exact inverse of decode_block."""
    cm_init = ctx.cm_init
    h, w = levels.shape
    scan, _ = _scans(w, h)
    log2_w = _log2(w)
    log2_block_size = min(log2_w, _log2(h))
    coef = levels.reshape(-1).astype(np.int32)

    nz_scan = np.nonzero(coef[scan])[0]
    last_pos_in_scan = int(nz_scan[-1])
    last_blkpos = int(scan[last_pos_in_scan])
    last_y = last_blkpos >> log2_w
    last_x = last_blkpos - (last_y << log2_w)
    _encode_last_xy(sbac, ctx, last_x, last_y, w, h, ch_type, cm_init)

    if cm_init:
        offset0 = (0 if log2_block_size <= 2 else
                   NUM_CTX_SIG_COEFF_LUMA_TU << min(1, log2_block_size - 3))
        sig_base = offset0 if ch_type == 0 else NUM_CTX_SIG_COEFF_LUMA
        gtx_base = 0 if ch_type == 0 else NUM_CTX_GTX_LUMA
    else:
        sig_base = 0 if ch_type == 0 else 1
        gtx_base = 0 if ch_type == 0 else 1

    last_scan_set = last_pos_in_scan >> LOG2_CG_SIZE
    ipos = last_pos_in_scan
    pos_last = last_blkpos
    for sub_set in range(last_scan_set, -1, -1):
        sub_pos = sub_set << LOG2_CG_SIZE
        pos = []
        abs_coef = []
        signs = 0
        while ipos >= sub_pos:
            blkpos = int(scan[ipos])
            sig = 1 if coef[blkpos] else 0
            if ipos != last_pos_in_scan:
                c = (ctx_sig_coeff_inc(coef, blkpos, w, h, ch_type)
                     if cm_init else 0)
                sbac.encode_bin(sig, ctx.sig_coeff_flag, sig_base + c)
            if sig:
                pos.append(blkpos)
                abs_coef.append(abs(int(coef[blkpos])))
                signs = (signs << 1) | (1 if coef[blkpos] < 0 else 0)
            ipos -= 1
        num_nz = len(pos)
        if num_nz == 0:
            continue
        n_ca = min(num_nz, CAFLAG_NUMBER)
        first_c2_idx = -1
        escape = False
        for idx in range(n_ca):
            gtA = 1 if abs_coef[idx] > 1 else 0
            c = 0
            if pos[idx] != pos_last and cm_init:
                c = ctx_gtx_inc(coef, pos[idx], w, h, ch_type, 1)
            sbac.encode_bin(gtA, ctx.coeff_abs_level_greaterAB_flag,
                            gtx_base + c)
            if gtA:
                if first_c2_idx == -1:
                    first_c2_idx = idx
                else:
                    escape = True
        if first_c2_idx != -1:
            gtB = 1 if abs_coef[first_c2_idx] > 2 else 0
            c = 0
            if pos[first_c2_idx] != pos_last and cm_init:
                c = ctx_gtx_inc(coef, pos[first_c2_idx], w, h, ch_type, 2)
            sbac.encode_bin(gtB, ctx.coeff_abs_level_greaterAB_flag,
                            gtx_base + c)
            if gtB:
                escape = True
        escape = escape or (num_nz > CAFLAG_NUMBER)
        if escape:
            i_first_c2 = 1
            for idx in range(num_nz):
                base_level = (2 + i_first_c2) if idx < CAFLAG_NUMBER else 1
                if abs_coef[idx] >= base_level:
                    rp = rice_para(coef, pos[idx], w, h, base_level)
                    _write_remain_exgolomb(sbac, abs_coef[idx] - base_level,
                                           rp)
                if abs_coef[idx] >= 2:
                    i_first_c2 = 0
        sbac.encode_bins_ep(signs, num_nz)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _read_remain_exgolomb(sbac, rparam):
    ones = 0
    while sbac.decode_bin_ep():
        ones += 1
    rng = GO_RICE_RANGE[rparam]
    if ones < rng:
        return (ones << rparam) + sbac.decode_bins_ep(rparam) if rparam \
            else (ones << rparam)
    extra = ones - rng
    length = rparam + extra
    base = (rng << rparam) + (1 << length) - (1 << rparam)
    return base + (sbac.decode_bins_ep(length) if length else 0)


def _decode_last_xy(sbac, ctx, width, height, ch_type, cm_init):
    off = 0 if ch_type == 0 else (NUM_CTX_LAST_SIG_COEFF_LUMA if cm_init
                                  else 11)
    if cm_init:
        bx, by, sx, sy = last_pos_xy_para(ch_type, width, height)
    else:
        bx = by = sx = sy = 0
    gmax_x = GROUP_IDX[width - 1]
    gmax_y = GROUP_IDX[height - 1]
    gx = 0
    while gx < gmax_x and sbac.decode_bin(
            ctx.last_sig_coeff_x_prefix, off + bx + (gx >> sx)):
        gx += 1
    gy = 0
    while gy < gmax_y and sbac.decode_bin(
            ctx.last_sig_coeff_y_prefix, off + by + (gy >> sy)):
        gy += 1
    last_x = MIN_IN_GROUP[gx]
    if gx > 3:
        cnt = (gx - 2) >> 1
        last_x += sbac.decode_bins_ep(cnt)
    last_y = MIN_IN_GROUP[gy]
    if gy > 3:
        cnt = (gy - 2) >> 1
        last_y += sbac.decode_bins_ep(cnt)
    return last_x, last_y


def decode_block(sbac, ctx, w, h, ch_type):
    """Decode one TB; returns (h, w) int32 coefficients."""
    cm_init = ctx.cm_init
    scan, inv_scan = _scans(w, h)
    log2_w = _log2(w)
    log2_block_size = min(log2_w, _log2(h))
    coef = np.zeros(w * h, dtype=np.int32)

    last_x, last_y = _decode_last_xy(sbac, ctx, w, h, ch_type, cm_init)
    last_blkpos = (last_y << log2_w) + last_x
    last_scan_pos = int(inv_scan[last_blkpos])

    if cm_init:
        offset0 = (0 if log2_block_size <= 2 else
                   NUM_CTX_SIG_COEFF_LUMA_TU << min(1, log2_block_size - 3))
        sig_base = offset0 if ch_type == 0 else NUM_CTX_SIG_COEFF_LUMA
        gtx_base = 0 if ch_type == 0 else NUM_CTX_GTX_LUMA
    else:
        sig_base = 0 if ch_type == 0 else 1
        gtx_base = 0 if ch_type == 0 else 1

    last_scan_set = last_scan_pos >> LOG2_CG_SIZE
    ipos = last_scan_pos
    pos_last = last_blkpos
    for sub_set in range(last_scan_set, -1, -1):
        sub_pos = sub_set << LOG2_CG_SIZE
        pos = []
        while ipos >= sub_pos:
            blkpos = int(scan[ipos])
            if ipos == last_scan_pos:
                sig = 1
            else:
                c = (ctx_sig_coeff_inc(coef, blkpos, w, h, ch_type)
                     if cm_init else 0)
                sig = sbac.decode_bin(ctx.sig_coeff_flag, sig_base + c)
            if sig:
                coef[blkpos] = 1
                pos.append(blkpos)
            ipos -= 1
        num_nz = len(pos)
        if num_nz == 0:
            continue
        # greater-A flags for the first 8 significant coefficients
        n_ca = min(num_nz, CAFLAG_NUMBER)
        first_c2_idx = -1
        escape = False
        for idx in range(n_ca):
            c = 0
            if pos[idx] != pos_last and cm_init:
                c = ctx_gtx_inc(coef, pos[idx], w, h, ch_type, 1)
            gtA = sbac.decode_bin(ctx.coeff_abs_level_greaterAB_flag,
                                  gtx_base + c)
            if gtA:
                coef[pos[idx]] = 2
                if first_c2_idx == -1:
                    first_c2_idx = idx
                else:
                    escape = True
        if first_c2_idx != -1:
            c = 0
            if pos[first_c2_idx] != pos_last and cm_init:
                c = ctx_gtx_inc(coef, pos[first_c2_idx], w, h, ch_type, 2)
            gtB = sbac.decode_bin(ctx.coeff_abs_level_greaterAB_flag,
                                  gtx_base + c)
            if gtB:
                coef[pos[first_c2_idx]] = 3
                escape = True
        escape = escape or (num_nz > CAFLAG_NUMBER)
        if escape:
            i_first_c2 = 1
            for idx in range(num_nz):
                base_level = (2 + i_first_c2) if idx < CAFLAG_NUMBER else 1
                v = int(coef[pos[idx]])
                # remainder present iff the staged value reached base_level
                if v >= base_level:
                    rp = rice_para(coef, pos[idx], w, h, base_level)
                    v = base_level + _read_remain_exgolomb(sbac, rp)
                    coef[pos[idx]] = v
                if v >= 2:
                    i_first_c2 = 0
        # signs, MSB-first in decode order
        signs = sbac.decode_bins_ep(num_nz) if num_nz else 0
        for idx in range(num_nz):
            if (signs >> (num_nz - 1 - idx)) & 1:
                coef[pos[idx]] = -coef[pos[idx]]
    return coef.reshape(h, w)
