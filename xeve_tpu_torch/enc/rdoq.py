"""Rate-distortion optimized quantization (run-length), exact semantics of
xeve_rdoq_run_length_cc (src_base/xeve_tq.c:497-649) with context-state
derived bit estimates (src_base/xeve_mode.c:304-373).
"""
from __future__ import annotations

import numpy as np

from ..constants import (SCAN, QUANT_SCALE, MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT,
                         SLICE_I)
from ..entropy.sbac import SbacCtx

SCALE_BITS = 15
ERR_SCALE_PRECISION_BITS = 20
GET_IEP_RATE = 32768

# entropy_bits table (xeve_mode.c:304)
_ENTROPY_BITS = np.empty(1024, dtype=np.int64)
for _i in range(1024):
    _p = (512 * (_i + 0.5)) / 1024
    _ENTROPY_BITS[_i] = int(-32768 * (np.log(_p) / np.log(2.0) - 9))


def biari_no_bits(symbol: int, model: int) -> int:
    mps = model & 1
    state = model >> 1
    state = state if (1 if symbol else 0) != mps else 512 - state
    return int(_ENTROPY_BITS[state << 1])


def bit_est_tables(ctx: SbacCtx):
    """Per-LCU refresh of RDOQ rate estimates from current context states."""
    est = {}
    est['cbf_luma'] = [biari_no_bits(b, ctx.cbf_luma[0]) for b in (0, 1)]
    est['cbf_cb'] = [biari_no_bits(b, ctx.cbf_cb[0]) for b in (0, 1)]
    est['cbf_cr'] = [biari_no_bits(b, ctx.cbf_cr[0]) for b in (0, 1)]
    est['cbf_all'] = [biari_no_bits(b, ctx.cbf_all[0]) for b in (0, 1)]
    est['run'] = [[biari_no_bits(b, m) for b in (0, 1)] for m in ctx.run]
    est['level'] = [[biari_no_bits(b, m) for b in (0, 1)] for m in ctx.level]
    est['last'] = [[biari_no_bits(b, m) for b in (0, 1)] for m in ctx.last]
    est['sig'] = [[biari_no_bits(b, m) for b in (0, 1)]
                  for m in ctx.sig_coeff_flag]
    est['gtAB'] = [[biari_no_bits(b, m) for b in (0, 1)]
                   for m in ctx.coeff_abs_level_greaterAB_flag]
    est['lastx'] = [[biari_no_bits(b, m) for b in (0, 1)]
                    for m in ctx.last_sig_coeff_x_prefix]
    est['lasty'] = [[biari_no_bits(b, m) for b in (0, 1)]
                    for m in ctx.last_sig_coeff_y_prefix]
    return est


def err_scale(qp_rem: int, log2_size: int, bit_depth: int, tool_iqt: int = 0) -> int:
    """xeve_init_err_scale (xeve_tq.c:406); log2_size in 1..7."""
    q_value = int(QUANT_SCALE[tool_iqt][qp_rem])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    es = float(1 << SCALE_BITS) * (2.0 ** (-tr_shift))
    es = es / q_value / (1 << (bit_depth - 8))
    return int(es * float(1 << ERR_SCALE_PRECISION_BITS))


def _rate_cost(abs_level, run, ctx_run, ctx_level, lam, est):
    if abs_level == 0:
        rate = est['run'][ctx_run if run == 0 else ctx_run + 1][1]
    else:
        rate = GET_IEP_RATE
        rate += est['run'][ctx_run if run == 0 else ctx_run + 1][0]
        if abs_level == 1:
            rate += est['level'][ctx_level][0]
        else:
            rate += est['level'][ctx_level][1]
            rate += est['level'][ctx_level + 1][1] * (abs_level - 2)
            rate += est['level'][ctx_level + 1][0]
    return rate * lam


def rdoq_block(coef: np.ndarray, qp: int, lam_f: float, slice_type: int,
               ch_type: int, is_intra: bool, bit_depth: int, est,
               tool_iqt: int = 0):
    """Exact RDOQ for one transform block.  Returns (levels, nnz)."""
    h, w = coef.shape
    log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
    qp_rem = qp % 6
    ns_shift = 7 if (log2_w + log2_h) & 1 else 0
    ns_scale = 181 if (log2_w + log2_h) & 1 else 1
    ns_offset = (1 << (ns_shift - 1)) if ns_shift else 0
    q_value = (int(QUANT_SCALE[tool_iqt][qp_rem]) * ns_scale + ns_offset) >> ns_shift
    log2_size = (log2_w + log2_h) >> 1
    tr_shift = MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    q_bits = QUANT_SHIFT + tr_shift + qp // 6
    lam = int(lam_f * (1 << SCALE_BITS) + 0.5)
    es = err_scale(qp_rem, log2_size, bit_depth, tool_iqt)
    scan = SCAN[(w, h)]
    flat = coef.reshape(-1).astype(np.int64)
    num = w * h

    # fast zero-block check (xeve_quant_nnz rdoq pre-check, xeve_tq.c:666)
    offset_fast = (201 if slice_type == SLICE_I else 153) << (q_bits + ns_shift - 9)
    thr = (1 << (q_bits + ns_shift)) - offset_fast
    lev_all = np.abs(flat) * int(QUANT_SCALE[tool_iqt][qp_rem]) * ns_scale
    if not (lev_all >= thr).any():
        return np.zeros((h, w), dtype=np.int32), 0

    # per-coefficient quantization bounds
    level_double = np.minimum(np.abs(flat) * q_value,
                              (2 ** 31 - 1) - (1 << (q_bits - 1)))
    max_abs = (level_double >> q_bits).astype(np.int64)
    lower = (level_double - (max_abs << q_bits)) < (1 << (q_bits - 1))
    max_abs = np.where(lower, max_abs, max_abs + 1)

    err0 = (level_double * es) >> ERR_SCALE_PRECISION_BITS
    block_uncoded_cost = int((err0 * err0).sum())

    if not is_intra and ch_type == 0:
        best_cost = block_uncoded_cost + est['cbf_all'][0] * lam
        base_cost = block_uncoded_cost + est['cbf_all'][1] * lam
    else:
        key = ('cbf_luma', 'cbf_cb', 'cbf_cr')[ch_type]
        best_cost = block_uncoded_cost + est[key][0] * lam
        base_cost = block_uncoded_cost + est[key][1] * lam

    ctx_rl = 0 if ch_type == 0 else 2
    ctx_last = 0 if ch_type == 0 else 1
    cost_last0 = est['last'][ctx_last][0] * lam
    cost_last1 = est['last'][ctx_last][1] * lam

    levels = np.zeros(num, dtype=np.int64)
    run = 0
    best_last_p1 = 0
    ld_s = level_double[scan]
    ma_s = max_abs[scan]
    sgn_s = flat[scan] < 0
    for sp in range(num):
        ld = int(ld_s[sp])
        ma = int(ma_s[sp])
        # get_coded_level_rl (xeve_tq.c:458): uncoded = err1^2 (distortion
        # only); coded starts at uncoded + rate(level 0) and is minimized
        # over {max_abs, max_abs-1}
        err1 = (ld * es) >> ERR_SCALE_PRECISION_BITS
        uncoded = err1 * err1
        best_lvl, coded = 0, uncoded + _rate_cost(0, run, ctx_rl, ctx_rl, lam, est)
        mn = ma - 1 if ma > 1 else 1
        for lvl in range(ma, mn - 1, -1):
            delta = ld - (lvl << q_bits)
            err = (delta * es) >> ERR_SCALE_PRECISION_BITS
            c = err * err + _rate_cost(lvl, run, ctx_rl, ctx_rl, lam, est)
            if c < coded:
                best_lvl, coded = lvl, c
        base_cost += coded - uncoded
        levels[sp] = best_lvl
        if best_lvl:
            cur_last_cost = base_cost + cost_last1
            base_cost += cost_last0
            if cur_last_cost < best_cost:
                best_cost = cur_last_cost
                best_last_p1 = sp + 1
            run = 0
        else:
            run += 1

    levels[best_last_p1:] = 0
    out = np.zeros(num, dtype=np.int32)
    signed = np.where(sgn_s, -levels, levels)
    out[scan] = signed
    nnz = int(np.count_nonzero(levels[:best_last_p1]))
    return out.reshape(h, w), nnz


def _ic_rate_adcc(est, abs_level, ctx_gtA, ctx_gtB, rparam, c1_idx, c2_idx):
    """Coded-level rate under the ADCC model (xevem_tq.c get_ic_rate)."""
    from ..entropy.adcc import GO_RICE_RANGE
    rate = GET_IEP_RATE
    base_level = (2 + (1 if c2_idx < 1 else 0)) if c1_idx < 8 else 1
    if abs_level >= base_level:
        symbol = abs_level - base_level
        if symbol < (GO_RICE_RANGE[rparam] << rparam):
            length = symbol >> rparam
            rate += (length + 1 + rparam) << 15
        else:
            length = rparam
            symbol -= GO_RICE_RANGE[rparam] << rparam
            while symbol >= (1 << length):
                symbol -= 1 << length
                length += 1
            rate += (GO_RICE_RANGE[rparam] + length + 1 - rparam
                     + length) << 15
        if c1_idx < 8:
            rate += est['gtAB'][ctx_gtA][1]
            if c2_idx < 1:
                rate += est['gtAB'][ctx_gtB][1]
    elif abs_level == 1:
        rate += est['gtAB'][ctx_gtA][0]
    elif abs_level == 2:
        rate += est['gtAB'][ctx_gtA][1] + est['gtAB'][ctx_gtB][0]
    else:
        rate = 0
    return rate


def _rate_last_xy_adcc(est, pos_x, pos_y, w, h, ch_type, lam):
    from ..entropy.adcc import GROUP_IDX, last_pos_xy_para
    off = 0 if ch_type == 0 else 18
    bx, by, sx, sy = last_pos_xy_para(ch_type, w, h)
    gx, gy = GROUP_IDX[pos_x], GROUP_IDX[pos_y]
    rate = 0
    for b in range(gx):
        rate += est['lastx'][off + bx + (b >> sx)][1]
    if gx < GROUP_IDX[w - 1]:
        rate += est['lastx'][off + bx + (gx >> sx)][0]
    for b in range(gy):
        rate += est['lasty'][off + by + (b >> sy)][1]
    if gy < GROUP_IDX[h - 1]:
        rate += est['lasty'][off + by + (gy >> sy)][0]
    if gx > 3:
        rate += ((gx - 2) >> 1) * GET_IEP_RATE
    if gy > 3:
        rate += ((gy - 2) >> 1) * GET_IEP_RATE
    return rate * lam


def rdoq_block_adcc(coef: np.ndarray, qp: int, lam_f: float, ch_type: int,
                    cu_is_intra: bool, bit_depth: int, est,
                    tool_iqt: int = 1):
    """ADCC-aware RDOQ for one square transform block: level decisions are
    optimized against the sig-map + gtA/gtB + remainder exp-Golomb rate
    model the ADCC coder actually uses (xevem_tq.c xeve_rdoq_method_adcc)
    instead of the run-length model.  Returns (levels, nnz)."""
    from ..entropy.adcc import (ctx_sig_coeff_inc, ctx_gtx_inc, rice_para)
    h, w = coef.shape
    log2_w = w.bit_length() - 1
    qp_rem = qp % 6
    q_value = int(QUANT_SCALE[tool_iqt][qp_rem])
    log2_size = log2_w
    tr_shift = MAX_TX_DYNAMIC_RANGE - bit_depth - log2_size
    q_bits = QUANT_SHIFT + tr_shift + qp // 6
    lam = int(lam_f * (1 << SCALE_BITS) + 0.5)
    es = err_scale(qp_rem, log2_size, bit_depth, tool_iqt)
    scan = SCAN[(w, h)]
    flat = coef.reshape(-1).astype(np.int64)
    num = w * h

    level_double = np.minimum(np.abs(flat) * q_value,
                              (2 ** 31 - 1) - (1 << (q_bits - 1)))
    max_abs = np.minimum(32767,
                         (level_double + (1 << (q_bits - 1))) >> q_bits)
    err0 = (level_double * es) >> ERR_SCALE_PRECISION_BITS
    pd_coeff0 = err0 * err0
    block_uncoded = int(pd_coeff0.sum())
    if int(max_abs.sum()) == 0:
        return np.zeros((h, w), dtype=np.int32), 0

    ma_s = max_abs[scan]
    nz_sp = np.nonzero(ma_s)[0]
    last_sp = int(nz_sp[-1])
    last_bp = int(scan[last_sp])
    num_nz = len(nz_sp)

    offset1 = 0 if ch_type == 0 else 13
    offset0 = ((0 if log2_size <= 2 else 13 << min(1, log2_size - 3))
               if ch_type == 0 else 39)

    cdst2 = max_abs.copy()      # evolving level map (raster)
    pd_coeff = np.zeros(num, dtype=np.int64)
    pd_sig = np.zeros(num, dtype=np.int64)
    is_last_nz = 0
    ipos = last_sp
    BIG = 1 << 62
    for sub_set in range(last_sp >> 4, -1, -1):
        sub_pos = sub_set << 4
        c1_idx = c2_idx = 0
        while ipos >= sub_pos:
            bp = int(scan[ipos])
            ld = int(level_double[bp])
            ma = int(cdst2[bp])
            bypass = (bp == last_bp)
            gA = ctx_gtx_inc(cdst2, bp, w, h, ch_type, 1)
            gB = ctx_gtx_inc(cdst2, bp, w, h, ch_type, 2)
            ctx_sig = ctx_sig_coeff_inc(cdst2, bp, w, h, ch_type) + offset0
            if ma != 0 and is_last_nz == 0:
                gA = gB = 0
            gA += offset1
            gB += offset1
            base_level = (2 + (1 if c2_idx < 1 else 0)) if c1_idx < 8 else 1
            rparam = rice_para(cdst2, bp, w, h, base_level)
            best_lvl = 0
            cost_sig1 = 0
            if not bypass and ma < 3:
                pd_sig[bp] = est['sig'][ctx_sig][0] * lam
                pd_coeff[bp] = int(pd_coeff0[bp]) + pd_sig[bp]
                if ma == 0:
                    cdst2[bp] = 0
                    ipos -= 1
                    continue
            else:
                pd_coeff[bp] = BIG
            if not bypass:
                cost_sig1 = est['sig'][ctx_sig][1] * lam
            mn = ma - 1 if ma > 1 else 1
            for lvl in range(ma, mn - 1, -1):
                errd = ld - (lvl << q_bits)
                rate = _ic_rate_adcc(est, lvl, gA, gB, rparam,
                                     c1_idx, c2_idx)
                errd = (errd * es) >> ERR_SCALE_PRECISION_BITS
                c = errd * errd + rate * lam + cost_sig1
                if c < pd_coeff[bp]:
                    best_lvl = lvl
                    pd_coeff[bp] = c
                    pd_sig[bp] = cost_sig1
            cdst2[bp] = best_lvl
            if best_lvl > 0:
                is_last_nz = 1
                c1_idx += 1
                if best_lvl > 1:
                    c2_idx += 1
            elif ma:
                num_nz -= 1
                if num_nz == 0:
                    return np.zeros((h, w), dtype=np.int32), 0
            ipos -= 1
    if num_nz == 0:
        return np.zeros((h, w), dtype=np.int32), 0

    cost_base = block_uncoded
    for sp in range(last_sp, -1, -1):
        bp = int(scan[sp])
        cost_base += int(pd_coeff[bp]) - int(pd_coeff0[bp])
    if not cu_is_intra and ch_type == 0:
        cost_best = block_uncoded + est['cbf_all'][0] * lam
        cost_base += est['cbf_all'][1] * lam
    else:
        key = ('cbf_luma', 'cbf_cb', 'cbf_cr')[ch_type]
        cost_best = block_uncoded + est[key][0] * lam
        cost_base += est[key][1] * lam

    best_last_p1 = 0
    for sp in range(last_sp, -1, -1):
        bp = int(scan[sp])
        if cdst2[bp] > 0:
            pos_y = bp >> log2_w
            pos_x = bp - (pos_y << log2_w)
            cost_last = _rate_last_xy_adcc(est, pos_x, pos_y, w, h,
                                           ch_type, lam)
            total = cost_base + cost_last - int(pd_sig[bp])
            if total < cost_best:
                best_last_p1 = sp + 1
                cost_best = total
            if cdst2[bp] > 1:
                break
            cost_base += int(pd_coeff0[bp]) - int(pd_coeff[bp])
        else:
            cost_base -= int(pd_sig[bp])

    out = np.zeros(num, dtype=np.int32)
    nnz = 0
    for sp in range(best_last_p1):
        bp = int(scan[sp])
        if cdst2[bp]:
            out[bp] = -int(cdst2[bp]) if flat[bp] < 0 else int(cdst2[bp])
            nnz += 1
    return out.reshape(h, w), nnz
