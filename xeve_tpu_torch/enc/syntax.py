"""SBAC syntax writer for Baseline (mirror of dec/decoder.py parsing).

Reference semantics: src_base/xeve_eco.c:674-1654 and xeve_enc.c:35-101.
"""
from __future__ import annotations

import numpy as np

from ..constants import SCAN, MPM_TBL, MIN_CU_LOG2
from ..entropy.sbac import SbacEncoder, SbacCtx


def write_split_flag(sbac: SbacEncoder, ctx: SbacCtx, split: int):
    sbac.encode_bin(1 if split else 0, ctx.split_cu_flag, 0)


def write_intra_dir(sbac: SbacEncoder, ctx: SbacCtx, rank: int):
    sbac.write_unary_sym(rank, ctx.intra_dir, 0, 2)


def write_cbf_intra(sbac: SbacEncoder, ctx: SbacCtx, cbf_y, cbf_u, cbf_v):
    sbac.encode_bin(cbf_u, ctx.cbf_cb, 0)
    sbac.encode_bin(cbf_v, ctx.cbf_cr, 0)
    sbac.encode_bin(cbf_y, ctx.cbf_luma, 0)


def write_dqp(sbac: SbacEncoder, ctx: SbacCtx, dqp: int):
    abs_dqp = abs(dqp)
    sbac.write_unary_sym(abs_dqp, ctx.delta_qp, 0, 1)
    if abs_dqp > 0:
        sbac.encode_bin_ep(1 if dqp < 0 else 0)


def write_coef_block(sbac: SbacEncoder, ctx: SbacCtx, coef: np.ndarray,
                     ch_type: int):
    """xeve_eco_run_length_cc (xeve_eco.c:707), sps_cm_init_flag == 0."""
    h, w = coef.shape
    flat = coef.reshape(-1)
    scan = SCAN[(w, h)]
    num_coeff = w * h
    scanned = flat[scan]
    sig_positions = np.nonzero(scanned)[0]
    num_sig = len(sig_positions)
    assert num_sig > 0
    t0 = 0 if ch_type == 0 else 2
    ctx_last = 0 if ch_type == 0 else 1
    run = 0
    prev = -1
    for k, pos in enumerate(sig_positions):
        run = int(pos) - prev - 1
        prev = int(pos)
        level = int(scanned[pos])
        sbac.write_unary_sym(run, ctx.run, t0, 2)
        sbac.write_unary_sym(abs(level) - 1, ctx.level, t0, 2)
        sbac.encode_bin_ep(1 if level < 0 else 0)
        if pos == num_coeff - 1:
            break
        last = 1 if k == num_sig - 1 else 0
        sbac.encode_bin(last, ctx.last, ctx_last)
        if last:
            break


def mpm_rank_table(map_cod, map_if, map_ipm, x_scu: int, y_scu: int):
    """Return the rank table (ipm -> rank) for a CU at (x_scu, y_scu),
    following xeve_get_mpm (xeve_ipred.c:230)."""
    ipm_l = 0
    ipm_u = 0
    if x_scu > 0 and map_if[y_scu, x_scu - 1] and map_cod[y_scu, x_scu - 1]:
        ipm_l = int(map_ipm[y_scu, x_scu - 1]) + 1
    if y_scu > 0 and map_if[y_scu - 1, x_scu] and map_cod[y_scu - 1, x_scu]:
        ipm_u = int(map_ipm[y_scu - 1, x_scu]) + 1
    return MPM_TBL[ipm_l, ipm_u]


# ---------------------------------------------------------------------------
# Inter syntax (Baseline, admvp=0; xeve_eco.c:674-706, 1123-1279)
# ---------------------------------------------------------------------------


def write_skip_flag(sbac: SbacEncoder, ctx: SbacCtx, flag: int):
    sbac.encode_bin(flag, ctx.skip_flag, 0)   # ctx 0 with cm_init off


def write_pred_mode(sbac: SbacEncoder, ctx: SbacCtx, is_intra: int):
    sbac.encode_bin(is_intra, ctx.pred_mode, 0)


def write_mvp_idx(sbac: SbacEncoder, ctx: SbacCtx, idx: int):
    sbac.write_truncate_unary_sym(idx, ctx.mvp_idx, 0, 3, 4)


def write_refi(sbac: SbacEncoder, ctx: SbacCtx, refi: int, num_refp: int):
    if num_refp <= 1:
        return
    if refi == 0:
        sbac.encode_bin(0, ctx.refi, 0)
        return
    sbac.encode_bin(1, ctx.refi, 0)
    if num_refp > 2:
        for i in range(2, num_refp):
            bin_v = 0 if i == refi + 1 else 1
            if i == 2:
                sbac.encode_bin(bin_v, ctx.refi, 1)
            else:
                sbac.encode_bin_ep(bin_v)
            if bin_v == 0:
                break


def _write_abs_mvd(sbac: SbacEncoder, ctx: SbacCtx, val: int):
    nn = (val + 1) >> 1
    len_i = 0
    while len_i < 16 and nn != 0:
        nn >>= 1
        len_i += 1
    info = val + 1 - (1 << len_i)
    code = (1 << len_i) | (info & ((1 << len_i) - 1))
    len_c = (len_i << 1) + 1
    for i in range(len_c):
        bin_v = (code >> (len_c - 1 - i)) & 1
        if i <= 1:
            sbac.encode_bin(bin_v, ctx.mvd, 0)
        else:
            sbac.encode_bin_ep(bin_v)


def write_mvd(sbac: SbacEncoder, ctx: SbacCtx, mvd_x: int, mvd_y: int):
    for v in (mvd_x, mvd_y):
        a = -v if v < 0 else v
        _write_abs_mvd(sbac, ctx, a)
        if a:
            sbac.encode_bin_ep(1 if v < 0 else 0)


def write_cbf_inter(sbac: SbacEncoder, ctx: SbacCtx, cbf_y, cbf_u, cbf_v):
    """Inter (non-intra) branch of xeve_eco_cbf (xeve_eco.c:813-864),
    single TB, run all components."""
    cbf_all = 1 if (cbf_y or cbf_u or cbf_v) else 0
    sbac.encode_bin(cbf_all, ctx.cbf_all, 0)
    if not cbf_all:
        return
    sbac.encode_bin(cbf_u, ctx.cbf_cb, 0)
    sbac.encode_bin(cbf_v, ctx.cbf_cr, 0)
    if cbf_u + cbf_v != 0:
        sbac.encode_bin(cbf_y, ctx.cbf_luma, 0)
    else:
        assert cbf_y == 1, "cbf_all=1 with no chroma implies luma cbf"


def mvd_bits_est(mvd_x: int, mvd_y: int) -> int:
    """Bin-count estimate for an MVD pair (for RD decisions)."""
    bits = 0
    for v in (mvd_x, mvd_y):
        a = abs(v)
        nn = (a + 1) >> 1
        len_i = 0
        while len_i < 16 and nn != 0:
            nn >>= 1
            len_i += 1
        bits += 2 * len_i + 1 + (1 if a else 0)
    return bits
