"""ADDB — advanced deblocking filter (Main profile, xevem_df.c).

AVC-style alpha/beta/clip filtering on the 8x8 grid with a 5-level
boundary strength: INTRA_STRONG(4) across CTU borders, INTRA(3), CODED(2),
DIFF_REFS(1), OTHERS(0).  Luma filters 4 samples per side per line (strong
mode rewrites 3), chroma 2.  Shared by the decoder and the encoder
oracle; native/xt_core.c carries the exact C twin.

Reference: xevem_df.c:70 (get_bs), :252-420 (line filters),
:527/:780 (per-CU hor/ver drivers), tables xevem_tbl.c:713-723.
"""
from __future__ import annotations

import numpy as np

from ..constants import chroma_qp_dynamic

TC_OFF = 2
ALPHA_TBL = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6,
    7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
    50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226,
    255, 255], dtype=np.int64)
BETA_TBL = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int64)
CLIP_TBL = np.array([
    [0, 0, 0, 0, 0]] * 17 +
    [[0, 0, 0, 1, 1], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1],
     [0, 0, 1, 1, 1], [0, 0, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 1, 1],
     [0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 2, 2], [0, 1, 1, 2, 2],
     [0, 1, 1, 2, 2], [0, 1, 1, 2, 2], [0, 1, 2, 3, 3], [0, 1, 2, 3, 3],
     [0, 2, 2, 3, 3], [0, 2, 2, 4, 4], [0, 2, 3, 4, 4], [0, 2, 3, 4, 4],
     [0, 3, 3, 5, 5], [0, 3, 4, 6, 6], [0, 3, 4, 6, 6], [0, 4, 5, 7, 7],
     [0, 4, 5, 8, 8], [0, 4, 6, 9, 9], [0, 5, 7, 10, 10],
     [0, 6, 8, 11, 11], [0, 6, 8, 13, 13], [0, 7, 10, 14, 14],
     [0, 8, 11, 16, 16], [0, 9, 12, 18, 18], [0, 10, 13, 20, 20],
     [0, 11, 15, 23, 23], [0, 13, 17, 25, 25]], dtype=np.int64)

BS_INTRA_STRONG, BS_INTRA, BS_CODED, BS_DIFF_REFS, BS_OTHERS = 4, 3, 2, 1, 0


def _cmp_mvs(a, b):
    return abs(int(a[0]) - int(b[0])) < 4 and abs(int(a[1]) - int(b[1])) < 4


def _get_bs(scu0, xy0, scu1, xy1, map_if, map_cbf_l, map_refi, map_mv,
            ref_pocs, log2_ctu=6):
    """scu = (ys, xs); xy = pixel coords; ref_pocs = (list0_pocs,
    list1_pocs) of the CURRENT slice (xevem_df.c get_bs, :70);
    log2_ctu sizes the INTRA_STRONG cross-LCU test (128 CTUs with btt)."""
    if map_if[scu0] or map_if[scu1]:
        same_lcu = ((xy0[0] >> log2_ctu) == (xy1[0] >> log2_ctu) and
                    (xy0[1] >> log2_ctu) == (xy1[1] >> log2_ctu))
        return BS_INTRA if same_lcu else BS_INTRA_STRONG
    if map_cbf_l[scu0] or map_cbf_l[scu1]:
        return BS_CODED

    def pics_and_mvs(scu):
        pics = []
        mvs = []
        for lidx in (0, 1):
            r = int(map_refi[scu][lidx])
            lst = ref_pocs[lidx]
            if 0 <= r < len(lst):
                pics.append(lst[r])
                mvs.append((int(map_mv[scu][lidx][0]),
                            int(map_mv[scu][lidx][1])))
            else:
                pics.append(None)
                mvs.append((0, 0))
        return pics, mvs

    p0, m0 = pics_and_mvs(scu0)
    p1, m1 = pics_and_mvs(scu1)
    if (p0[0] == p1[0] and p0[1] == p1[1]) or \
       (p0[0] == p1[1] and p0[1] == p1[0]):
        if p0[0] == p0[1]:
            same = (_cmp_mvs(m0[0], m1[0]) and _cmp_mvs(m0[1], m1[1]) and
                    _cmp_mvs(m0[0], m1[1]) and _cmp_mvs(m0[1], m1[0]))
        elif p0[0] == p1[0] and p0[1] == p1[1]:
            same = _cmp_mvs(m0[0], m1[0]) and _cmp_mvs(m0[1], m1[1])
        else:
            same = _cmp_mvs(m0[0], m1[1]) and _cmp_mvs(m0[1], m1[0])
        return BS_OTHERS if same else BS_DIFF_REFS
    return BS_DIFF_REFS


def _filt_line_luma(get, put, bs, alpha, beta, c1, bd):
    p = [get(-(i + 1)) for i in range(4)]
    q = [get(i) for i in range(4)]
    if not (bs and abs(p[0] - q[0]) < alpha and abs(p[1] - p[0]) < beta
            and abs(q[1] - q[0]) < beta):
        return
    po, qo = list(p), list(q)
    ap = 1 if abs(p[0] - p[2]) < beta else 0
    aq = 1 if abs(q[0] - q[2]) < beta else 0
    if bs == BS_INTRA_STRONG:
        strong_ok = abs(p[0] - q[0]) < ((alpha >> 2) + 2)
        if ap and strong_ok:
            po[0] = (p[2] + 2 * (p[1] + p[0] + q[0]) + q[1] + 4) >> 3
            po[1] = (p[2] + p[1] + p[0] + q[0] + 2) >> 2
            po[2] = (2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3
        else:
            po[0] = (2 * p[1] + p[0] + q[1] + 2) >> 2
        if aq and strong_ok:
            qo[0] = (q[2] + 2 * (q[1] + q[0] + p[0]) + p[1] + 4) >> 3
            qo[1] = (q[2] + q[1] + q[0] + p[0] + 2) >> 2
            qo[2] = (2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3
        else:
            qo[0] = (2 * q[1] + q[0] + p[1] + 2) >> 2
    else:
        mx = (1 << bd) - 1
        c0 = c1 + ((ap + aq) << max(0, bd - 9))
        d0 = max(-c0, min(c0, (4 * (q[0] - p[0]) + p[1] - q[1] + 4) >> 3))
        po[0] = max(0, min(mx, p[0] + d0))
        qo[0] = max(0, min(mx, q[0] - d0))
        if ap:
            d1 = max(-c1, min(c1,
                              ((p[2] + p[0] + q[0]) * 3 - 8 * p[1] - q[1])
                              >> 4))
            po[1] = p[1] + d1
        if aq:
            d1 = max(-c1, min(c1,
                              ((q[2] + q[0] + p[0]) * 3 - 8 * q[1] - p[1])
                              >> 4))
            qo[1] = q[1] + d1
    mx = (1 << bd) - 1
    for i in range(4):
        put(-(i + 1), max(0, min(mx, po[i])))
        put(i, max(0, min(mx, qo[i])))


def _filt_line_chroma(get, put, bs, alpha, beta, c0, bd):
    p = [get(-(i + 1)) for i in range(2)]
    q = [get(i) for i in range(2)]
    if not (bs and abs(p[0] - q[0]) < alpha and abs(p[1] - p[0]) < beta
            and abs(q[1] - q[0]) < beta):
        return
    po, qo = list(p), list(q)
    if bs == BS_INTRA_STRONG:
        po[0] = (2 * p[1] + p[0] + q[1] + 2) >> 2
        qo[0] = (2 * q[1] + q[0] + p[1] + 2) >> 2
    else:
        mx = (1 << bd) - 1
        d0 = max(-c0, min(c0, (4 * (q[0] - p[0]) + p[1] - q[1] + 4) >> 3))
        po[0] = max(0, min(mx, p[0] + d0))
        qo[0] = max(0, min(mx, q[0] - d0))
    mx = (1 << bd) - 1
    for i in range(2):
        put(-(i + 1), max(0, min(mx, po[i])))
        put(i, max(0, min(mx, qo[i])))


def deblock_frame_addb(rec_y, rec_u, rec_v, leaf_cus, map_if, map_cbf_l,
                       map_qp, map_refi, map_mv, ref_pocs,
                       qp_u_off, qp_v_off, bd, bd_chroma_minus8,
                       alpha_off=0, beta_off=0, main_qp_table=1,
                       map_tidx=None, log2_ctu=6):
    """In-place ADDB over the frame: vertical (left) edges of every leaf
    CU first, then horizontal (top) edges — the reference's is_hor=0/1
    double pass (xeve_enc.c:2363).  Edges only on the 8x8 grid."""
    bsc = bd - 8

    def idx_a(qp):
        return max(0, min(51, qp + alpha_off))

    def idx_b(qp):
        return max(0, min(51, qp + beta_off))

    def seg_params_luma(qp, bs):
        alpha = int(ALPHA_TBL[idx_a(qp)]) << bsc
        beta = int(BETA_TBL[idx_b(qp)]) << bsc
        c1 = int(CLIP_TBL[idx_a(qp)][bs]) << max(0, bd - 9)
        return alpha, beta, c1

    def seg_params_chroma(qp_c, bs):
        alpha = int(ALPHA_TBL[idx_a(qp_c)]) << bsc
        beta = int(BETA_TBL[idx_b(qp_c)]) << bsc
        c0 = (int(CLIP_TBL[idx_a(qp_c)][bs]) + 1) << max(0, bd - 9)
        return alpha, beta, c0

    def chroma_qps(qp):
        qu = int(np.clip(qp + qp_u_off, -6 * bd_chroma_minus8, 57))
        qv = int(np.clip(qp + qp_v_off, -6 * bd_chroma_minus8, 57))
        return (chroma_qp_dynamic(qu, main_qp_table),
                chroma_qp_dynamic(qv, main_qp_table))

    def filt_edge(x, y, n_scu, hor):
        """One CU edge at (x, y): vertical (hor=False, left edge, segments
        down) or horizontal (hor=True, top edge, segments right)."""
        for i in range(n_scu):
            if hor:
                sx, sy = x + 4 * i, y
                scu = (sy >> 2, sx >> 2)
                nscu = ((sy >> 2) - 1, sx >> 2)
                xy0, xy1 = (sx, sy), (sx, sy - 1)
            else:
                sx, sy = x, y + 4 * i
                scu = (sy >> 2, sx >> 2)
                nscu = (sy >> 2, (sx >> 2) - 1)
                xy0, xy1 = (sx, sy), (sx - 1, sy)
            bs = _get_bs(scu, xy0, nscu, xy1, map_if, map_cbf_l,
                         map_refi, map_mv, ref_pocs, log2_ctu=log2_ctu)
            qp = (int(map_qp[scu]) + int(map_qp[nscu]) + 1) >> 1
            alpha, beta, c1 = seg_params_luma(qp, bs)
            for k in range(4):
                if hor:
                    col = sx + k

                    def get(o, r=sy, c=col):
                        return int(rec_y[r + o, c])

                    def put(o, v, r=sy, c=col):
                        rec_y[r + o, c] = v
                else:
                    row = sy + k

                    def get(o, r=row, c=sx):
                        return int(rec_y[r, c + o])

                    def put(o, v, r=row, c=sx):
                        rec_y[r, c + o] = v
                _filt_line_luma(get, put, bs, alpha, beta, c1, bd)
            qcu, qcv = chroma_qps(qp)
            for plane, qc in ((rec_u, qcu), (rec_v, qcv)):
                alpha, beta, c0 = seg_params_chroma(qc, bs)
                for k in range(2):
                    if hor:
                        col = (sx >> 1) + k
                        r0 = sy >> 1

                        def get(o, r=r0, c=col, p=plane):
                            return int(p[r + o, c])

                        def put(o, v, r=r0, c=col, p=plane):
                            p[r + o, c] = v
                    else:
                        row = (sy >> 1) + k
                        c0_ = sx >> 1

                        def get(o, r=row, c=c0_, p=plane):
                            return int(p[r, c + o])

                        def put(o, v, r=row, c=c0_, p=plane):
                            p[r, c + o] = v
                    _filt_line_chroma(get, put, bs, alpha, beta, c0, bd)

    def tidx_ok(a, b):
        return map_tidx is None or map_tidx[a] == map_tidx[b]

    # pass 1: vertical edges (left edge of each CU on the 8-grid)
    for (x, y, cuw, cuh) in leaf_cus:
        if x > 0 and x % 8 == 0 and tidx_ok((y >> 2, x >> 2),
                                            (y >> 2, (x >> 2) - 1)):
            filt_edge(x, y, cuh >> 2, hor=False)
    # pass 2: horizontal edges (top edge of each CU on the 8-grid)
    for (x, y, cuw, cuh) in leaf_cus:
        if y > 0 and y % 8 == 0 and tidx_ok((y >> 2, x >> 2),
                                            ((y >> 2) - 1, x >> 2)):
            filt_edge(x, y, cuw >> 2, hor=True)
