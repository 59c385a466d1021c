"""Frame-level Baseline deblocking shared by encoder and decoder (numpy).

Reference: src_base/xeve_df.c + xeve_loop_filter (xeve_enc.c:2355): the
vertical-edge pass runs over all leaf CUs in z-order first, then the
horizontal-edge pass.  With single-tile z-order traversal this reduces to:
filter each leaf CU's left edge (x>0) in the vertical pass and its top edge
(y>0) in the horizontal pass.
"""
from __future__ import annotations

import numpy as np

from . import reference_kernels as rk
from ..constants import chroma_qp_dynamic


def deblock_frame(rec_y: np.ndarray, rec_u: np.ndarray, rec_v: np.ndarray,
                  leaf_cus, map_if: np.ndarray, map_cbf_l: np.ndarray,
                  map_qp: np.ndarray, qp_u_off: int, qp_v_off: int,
                  bit_depth: int, bd_chroma_minus8: int,
                  map_refi=None, map_mv=None, main_qp_table: int = 0,
                  map_tidx=None):
    """In-place deblock of the three planes. leaf_cus: z-order (x,y,w,h).
    map_refi/map_mv enable the inter strength rules (get_tbl_qp_to_st,
    xeve_df.c:34-87).  map_tidx (SCU tile ids) skips edges crossing tile
    boundaries (loop_filter_across_tiles_enabled_flag == 0)."""
    bd = bit_depth

    def strength_idx(a, b):
        if map_if[a] or map_if[b]:
            return 0
        if map_cbf_l[a] or map_cbf_l[b]:
            return 1
        if map_refi is None:
            return 3
        r0, r1 = map_refi[a], map_refi[b]
        m0 = [list(map_mv[a][0]), list(map_mv[a][1])]
        m1 = [list(map_mv[b][0]), list(map_mv[b][1])]
        if r0[0] < 0:
            m0[0] = [0, 0]
        if r0[1] < 0:
            m0[1] = [0, 0]
        if r1[0] < 0:
            m1[0] = [0, 0]
        if r1[1] < 0:
            m1[1] = [0, 0]
        if r0[0] == r1[0] and r0[1] == r1[1]:
            return 2 if (abs(m0[0][0] - m1[0][0]) >= 4 or
                         abs(m0[0][1] - m1[0][1]) >= 4 or
                         abs(m0[1][0] - m1[1][0]) >= 4 or
                         abs(m0[1][1] - m1[1][1]) >= 4) else 3
        if r0[0] == r1[1] and r0[1] == r1[0]:
            return 2 if (abs(m0[0][0] - m1[1][0]) >= 4 or
                         abs(m0[0][1] - m1[1][1]) >= 4 or
                         abs(m0[1][0] - m1[0][0]) >= 4 or
                         abs(m0[1][1] - m1[0][1]) >= 4) else 3
        return 2

    def filt_ver(xe, ys, n_scu):
        for i in range(n_scu):
            yy = ys + i * 4
            scu = (yy >> 2, xe >> 2)
            scu_l = (yy >> 2, (xe >> 2) - 1)
            idx = strength_idx(scu, scu_l)
            qp = int(map_qp[scu])
            st = rk.df_strength(qp, idx, bd)
            if st:
                A, B = rec_y[yy:yy + 4, xe - 2], rec_y[yy:yy + 4, xe - 1]
                C, D = rec_y[yy:yy + 4, xe], rec_y[yy:yy + 4, xe + 1]
                A2, B2, C2, D2 = rk.deblock_line_luma(
                    A.astype(np.int64), B.astype(np.int64),
                    C.astype(np.int64), D.astype(np.int64), st, bd)
                rec_y[yy:yy + 4, xe - 2] = A2
                rec_y[yy:yy + 4, xe - 1] = B2
                rec_y[yy:yy + 4, xe] = C2
                rec_y[yy:yy + 4, xe + 1] = D2
            qp_ui = int(np.clip(qp + qp_u_off, -6 * bd_chroma_minus8, 57))
            qp_vi = int(np.clip(qp + qp_v_off, -6 * bd_chroma_minus8, 57))
            for plane, qpc in ((rec_u, chroma_qp_dynamic(qp_ui, main_qp_table)),
                               (rec_v, chroma_qp_dynamic(qp_vi, main_qp_table))):
                stc = rk.df_strength(qpc, idx, bd)
                if stc:
                    xc, yc = xe >> 1, yy >> 1
                    A, B = plane[yc:yc + 2, xc - 2], plane[yc:yc + 2, xc - 1]
                    C, D = plane[yc:yc + 2, xc], plane[yc:yc + 2, xc + 1]
                    _, B2, C2, _ = rk.deblock_line_chroma(
                        A.astype(np.int64), B.astype(np.int64),
                        C.astype(np.int64), D.astype(np.int64), stc, bd)
                    plane[yc:yc + 2, xc - 1] = B2
                    plane[yc:yc + 2, xc] = C2

    def filt_hor(xs, ye, n_scu):
        for i in range(n_scu):
            xx = xs + i * 4
            scu = (ye >> 2, xx >> 2)
            scu_u = ((ye >> 2) - 1, xx >> 2)
            idx = strength_idx(scu, scu_u)
            qp = int(map_qp[scu])
            st = rk.df_strength(qp, idx, bd)
            if st:
                A, B = rec_y[ye - 2, xx:xx + 4], rec_y[ye - 1, xx:xx + 4]
                C, D = rec_y[ye, xx:xx + 4], rec_y[ye + 1, xx:xx + 4]
                A2, B2, C2, D2 = rk.deblock_line_luma(
                    A.astype(np.int64), B.astype(np.int64),
                    C.astype(np.int64), D.astype(np.int64), st, bd)
                rec_y[ye - 2, xx:xx + 4] = A2
                rec_y[ye - 1, xx:xx + 4] = B2
                rec_y[ye, xx:xx + 4] = C2
                rec_y[ye + 1, xx:xx + 4] = D2
            qp_ui = int(np.clip(qp + qp_u_off, -6 * bd_chroma_minus8, 57))
            qp_vi = int(np.clip(qp + qp_v_off, -6 * bd_chroma_minus8, 57))
            for plane, qpc in ((rec_u, chroma_qp_dynamic(qp_ui, main_qp_table)),
                               (rec_v, chroma_qp_dynamic(qp_vi, main_qp_table))):
                stc = rk.df_strength(qpc, idx, bd)
                if stc:
                    yc, xc = ye >> 1, xx >> 1
                    A, B = plane[yc - 2, xc:xc + 2], plane[yc - 1, xc:xc + 2]
                    C, D = plane[yc, xc:xc + 2], plane[yc + 1, xc:xc + 2]
                    _, B2, C2, _ = rk.deblock_line_chroma(
                        A.astype(np.int64), B.astype(np.int64),
                        C.astype(np.int64), D.astype(np.int64), stc, bd)
                    plane[yc - 1, xc:xc + 2] = B2
                    plane[yc, xc:xc + 2] = C2

    for (x, y, cuw, cuh) in leaf_cus:
        if x > 0 and (map_tidx is None or
                      map_tidx[y >> 2, x >> 2] ==
                      map_tidx[y >> 2, (x >> 2) - 1]):
            filt_ver(x, y, cuh >> 2)
    for (x, y, cuw, cuh) in leaf_cus:
        if y > 0 and (map_tidx is None or
                      map_tidx[y >> 2, x >> 2] ==
                      map_tidx[(y >> 2) - 1, x >> 2]):
            filt_hor(x, y, cuw >> 2)
