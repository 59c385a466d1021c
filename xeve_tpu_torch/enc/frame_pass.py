"""Closed-loop frame coding pass for I and low-delay P slices (numpy oracle).

For P frames the analysis supplies the partition, an ME motion vector and an
intra mode per block; this pass makes the final per-CU choice among
{skip (best of the 4 real MVP candidates), inter MVD, intra} with
closed-loop costs, then codes syntax + reconstruction.  This mirrors the
reference's structure where exact RD decisions happen against true
reconstructed neighbours (xeve_mode.c), but with a bounded candidate set
prepared by the batched TPU analysis (SURVEY.md §7.1).
"""
from __future__ import annotations

import numpy as np

from ..constants import (MIN_CU_LOG2, MIN_CU_SIZE, SLICE_I, SLICE_P, SLICE_B,
                         chroma_qp_dynamic)
from ..entropy.sbac import SbacEncoder, SbacCtx
from ..ops import reference_kernels as rk
from ..ops import mc_np
from ..ops import motion_np
from ..ops.intra_np import gather_nb
from ..ops.deblock_np import deblock_frame
from . import syntax
from .rdoq import rdoq_block, bit_est_tables

PAD_L = 64 + 16  # PIC_PAD_SIZE_L


class FramePass:
    """One slice (I or P), closed loop."""

    def __init__(self, w, h, bd, bd_chroma_minus8, qp, qp_u_off, qp_v_off,
                 slice_type=SLICE_I, refp=None, refp1=None, poc=0,
                 use_rdoq=True, use_deblock=True):
        self.w, self.h, self.bd = w, h, bd
        self.bdc8 = bd_chroma_minus8
        self.qp = qp
        self.slice_type = slice_type
        self.refp = refp or []          # L0: dicts y_pad/u_pad/v_pad/map_mv/poc
        self.refp1 = refp1 or []        # L1 (B slices)
        self.poc = poc
        self.qp_u_off, self.qp_v_off = qp_u_off, qp_v_off
        self.qp_y = qp + 6 * (bd - 8)
        qpu_i = int(np.clip(qp + qp_u_off, -6 * bd_chroma_minus8, 57))
        qpv_i = int(np.clip(qp + qp_v_off, -6 * bd_chroma_minus8, 57))
        self.qp_u = chroma_qp_dynamic(qpu_i) + 6 * bd_chroma_minus8
        self.qp_v = chroma_qp_dynamic(qpv_i) + 6 * bd_chroma_minus8
        self.lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        self.lam_u = self.lam / (2.0 ** ((self.qp_y - self.qp_u) / 3.0))
        self.lam_v = self.lam / (2.0 ** ((self.qp_y - self.qp_v) / 3.0))
        self.use_rdoq = use_rdoq
        self.use_deblock = use_deblock
        self.w_scu = (w + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        self.h_scu = (h + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        self.w_lcu = (w + 63) >> 6
        self.h_lcu = (h + 63) >> 6

    # ------------------------------------------------------------------
    def encode(self, orig_y, orig_u, orig_v, analysis, sbac: SbacEncoder,
               ctx: SbacCtx):
        w, h, bd = self.w, self.h, self.bd
        mid = 1 << (bd - 1)
        self.orig_y, self.orig_u, self.orig_v = orig_y, orig_u, orig_v
        self.rec_y = np.full((h, w), mid, dtype=np.int32)
        self.rec_u = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        self.rec_v = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        self.map_cod = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_if = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_ipm = np.full((self.h_scu, self.w_scu), -1, dtype=np.int32)
        self.map_qp = np.full((self.h_scu, self.w_scu), self.qp, dtype=np.int32)
        self.map_cbf_l = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_mv = np.zeros((self.h_scu, self.w_scu, 2, 2), dtype=np.int32)
        self.map_refi = np.full((self.h_scu, self.w_scu, 2), -1, dtype=np.int32)
        self.leaf_cus = []
        self.an = analysis
        self.sbac = sbac
        self.ctx = ctx

        for ly in range(self.h_lcu):
            for lx in range(self.w_lcu):
                self.est = bit_est_tables(ctx)
                self._code_tree(lx << 6, ly << 6, 6)
        sbac.encode_bin_trm(1)

        if self.use_deblock:
            deblock_frame(self.rec_y, self.rec_u, self.rec_v, self.leaf_cus,
                          self.map_if, self.map_cbf_l, self.map_qp,
                          self.qp_u_off, self.qp_v_off, bd, self.bdc8,
                          map_refi=self.map_refi, map_mv=self.map_mv)
        return self.rec_y, self.rec_u, self.rec_v, self.leaf_cus

    # ------------------------------------------------------------------
    def _code_tree(self, x, y, lg):
        s = 1 << lg
        boundary = (x + s > self.w) or (y + s > self.h)
        if boundary:
            split = True
        elif lg == 2:
            split = False
        else:
            split = bool(self.an.split[lg][y >> lg, x >> lg]) if lg in self.an.split else False
        if s >= 8:
            syntax.write_split_flag(self.sbac, self.ctx, 1 if split else 0)
        if split:
            half = s >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                xp, yp = x + dx, y + dy
                if xp < self.w and yp < self.h:
                    self._code_tree(xp, yp, lg - 1)
        else:
            self._code_cu(x, y, lg)

    # ------------------------------------------------------------------
    def _tq_channels(self, x, y, s, pred_y, pred_u, pred_v):
        """Closed-loop residual T/Q for the 3 channels against given preds.
        Returns (lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v, rec tuple, ssd)."""
        bd = self.bd
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        resi = self.orig_y[y:y + s, x:x + s].astype(np.int32) - pred_y
        coef = rk.forward_dct2(resi, bd)
        if self.use_rdoq:
            lev_y, nnz_y = rdoq_block(coef, self.qp_y, self.lam, self.slice_type,
                                      0, self.slice_type == SLICE_I, bd, self.est)
        else:
            lev_y, nnz_y = rk.quant(coef, self.qp_y, self.slice_type, bd)
        if nnz_y:
            rr = rk.inverse_dct2(rk.dequant(lev_y, self.qp_y, bd), bd)
            rec_y = rk.recon_block(pred_y, rr, bd)
        else:
            rec_y = rk.recon_block(pred_y, None, bd)
        out_c = []
        for (orig, pred, qp_c, lam_c, chix) in (
                (self.orig_u, pred_u, self.qp_u, self.lam_u, 1),
                (self.orig_v, pred_v, self.qp_v, self.lam_v, 2)):
            resi = orig[yc:yc + sc, xc:xc + sc].astype(np.int32) - pred
            coef = rk.forward_dct2(resi, bd)
            if self.use_rdoq:
                lev, nnz = rdoq_block(coef, qp_c, lam_c, self.slice_type, chix,
                                      self.slice_type == SLICE_I, bd, self.est)
            else:
                lev, nnz = rk.quant(coef, qp_c, self.slice_type, bd)
            if nnz:
                rr = rk.inverse_dct2(rk.dequant(lev, qp_c, bd), bd)
                rec = rk.recon_block(pred, rr, bd)
            else:
                rec = rk.recon_block(pred, None, bd)
            out_c.append((lev, nnz, rec))
        (lev_u, nnz_u, rec_u), (lev_v, nnz_v, rec_v) = out_c
        w_u = 2.0 ** ((self.qp_y - self.qp_u) / 3.0)
        w_v = 2.0 ** ((self.qp_y - self.qp_v) / 3.0)
        ssd = float(((self.orig_y[y:y + s, x:x + s] - rec_y) ** 2).sum())
        ssd += w_u * float(((self.orig_u[yc:yc + sc, xc:xc + sc] - rec_u) ** 2).sum())
        ssd += w_v * float(((self.orig_v[yc:yc + sc, xc:xc + sc] - rec_v) ** 2).sum())
        return (lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v,
                (rec_y, rec_u, rec_v), ssd)

    def _coef_bins(self, lev, nnz):
        if nnz == 0:
            return 0
        flat = np.abs(lev).reshape(-1)
        nz = np.nonzero(flat)[0]
        return int(flat.sum()) + 2 * len(nz) + int(nz.max()) + 1

    def _mvp_list(self, x_scu, y_scu, scuw, scuh, lidx=0):
        avail = motion_np.get_avail_inter(x_scu, y_scu, self.w_scu, self.h_scu,
                                          scuw, scuh, self.map_cod, self.map_if)
        refs = self.refp if lidx == 0 else self.refp1
        ref0_map = refs[0]["map_mv"] if refs else None
        return motion_np.get_motion(x_scu, y_scu, scuw, lidx, avail,
                                    self.map_mv, ref0_map, self.w_scu)

    def _mc(self, x, y, s, mv, lidx=0):
        ref = (self.refp if lidx == 0 else self.refp1)[0]
        return mc_np.mc_cu(x, y, s, s, mv, ref["y_pad"], ref["u_pad"],
                           ref["v_pad"], PAD_L, PAD_L // 2, self.w, self.h,
                           self.bd)

    def _mc_bi(self, x, y, s, mv0, mv1):
        """Bi prediction (identical-motion shortcut + rounded average)."""
        c0 = (self.refp[0]["poc"],
              mc_np.mv_clip(x, y, self.w, self.h, s, s, mv0))
        c1 = (self.refp1[0]["poc"],
              mc_np.mv_clip(x, y, self.w, self.h, s, s, mv1))
        p0 = self._mc(x, y, s, mv0, 0)
        if c0 == c1:
            return p0
        p1 = self._mc(x, y, s, mv1, 1)
        return tuple(((a + b + 1) >> 1) for a, b in zip(p0, p1))

    def _mv_dir(self, br_x_scu, br_y_scu):
        """Temporal direct MVs (xeve_get_mv_dir; colocated = bottom-right
        SCU)."""
        ref1 = self.refp1[0]
        mvc = ref1["map_mv"][br_y_scu, br_x_scu, 0]
        dpoc_co = ref1["poc"] - ref1["list0_poc"]
        dpoc_l0 = self.poc - self.refp[0]["poc"]
        dpoc_l1 = ref1["poc"] - self.poc
        if dpoc_co == 0:
            return (0, 0), (0, 0)

        def sdiv(a, b):
            q = abs(a) // abs(b)
            return -q if (a < 0) != (b < 0) else q
        mv0 = (sdiv(dpoc_l0 * int(mvc[0]), dpoc_co),
               sdiv(dpoc_l0 * int(mvc[1]), dpoc_co))
        mv1 = (sdiv(-dpoc_l1 * int(mvc[0]), dpoc_co),
               sdiv(-dpoc_l1 * int(mvc[1]), dpoc_co))
        return mv0, mv1

    # ------------------------------------------------------------------
    def _code_cu(self, x, y, lg):
        s = 1 << lg
        bd = self.bd
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        scuw = scuh = s >> MIN_CU_LOG2
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        ipm = int(self.an.mode[lg][y >> lg, x >> lg])

        if self.slice_type == SLICE_I or not self.refp:
            self._code_intra_cu(x, y, lg, ipm)
            return

        lam = self.lam
        w_u = 2.0 ** ((self.qp_y - self.qp_u) / 3.0)
        w_v = 2.0 ** ((self.qp_y - self.qp_v) / 3.0)
        is_b = self.slice_type == SLICE_B and bool(self.refp1)

        def wssd(py, pu, pv):
            d = float(((self.orig_y[y:y + s, x:x + s] - py) ** 2).sum())
            d += w_u * float(((self.orig_u[yc:yc + sc, xc:xc + sc] - pu) ** 2).sum())
            d += w_v * float(((self.orig_v[yc:yc + sc, xc:xc + sc] - pv) ** 2).sum())
            return d

        # --- candidate 1: skip over MVP candidates (no residual) ---
        mvp = self._mvp_list(x_scu, y_scu, scuw, scuh, 0)
        mvp1 = self._mvp_list(x_scu, y_scu, scuw, scuh, 1) if is_b else None
        best_skip = None
        seen = set()
        for idx in range(4):
            mv0 = (int(mvp[idx][0]), int(mvp[idx][1]))
            if is_b:
                mv1 = (int(mvp1[idx][0]), int(mvp1[idx][1]))
                key = (mv0, mv1)
                if key in seen:
                    continue
                seen.add(key)
                py, pu, pv = self._mc_bi(x, y, s, mv0, mv1)
                cost = wssd(py, pu, pv) + lam * (2 + 2 * idx)
                cand = (cost, idx, idx, mv0, mv1, (py, pu, pv))
            else:
                if mv0 in seen:
                    continue
                seen.add(mv0)
                py, pu, pv = self._mc(x, y, s, mv0)
                cost = wssd(py, pu, pv) + lam * (2 + idx)
                cand = (cost, idx, None, mv0, None, (py, pu, pv))
            if best_skip is None or cand[0] < best_skip[0]:
                best_skip = cand

        # --- candidate 1b (B): temporal direct, with residual ---
        best_direct = None
        if is_b:
            dmv0, dmv1 = self._mv_dir(min(x_scu + scuw - 1, self.w_scu - 1),
                                      min(y_scu + scuh - 1, self.h_scu - 1))
            py, pu, pv = self._mc_bi(x, y, s, dmv0, dmv1)
            (dl_y, dn_y, dl_u, dn_u, dl_v, dn_v, drecs, dssd) = \
                self._tq_channels(x, y, s, py, pu, pv)
            dbins = (3 + self._coef_bins(dl_y, dn_y) +
                     self._coef_bins(dl_u, dn_u) + self._coef_bins(dl_v, dn_v))
            best_direct = (dssd + lam * dbins, dmv0, dmv1, drecs,
                           dl_y, dn_y, dl_u, dn_u, dl_v, dn_v)

        # --- candidate 2: inter MVD (uni L0 / uni L1 / bi) + residual ---
        mv_me0 = (int(self.an.mv[lg][y >> lg, x >> lg, 0]),
                  int(self.an.mv[lg][y >> lg, x >> lg, 1]))
        mv_me1 = None
        if is_b and getattr(self.an, "mv1", None) is not None:
            mv_me1 = (int(self.an.mv1[lg][y >> lg, x >> lg, 0]),
                      int(self.an.mv1[lg][y >> lg, x >> lg, 1]))

        def best_mvp_idx(mvl, mv_t):
            bi, bb = 0, 1 << 30
            for idx in range(4):
                b = syntax.mvd_bits_est(mv_t[0] - int(mvl[idx][0]),
                                        mv_t[1] - int(mvl[idx][1]))
                if b < bb:
                    bi, bb = idx, b
            return bi, bb

        variants = []   # (pred_dir, mv0, mv1, preds, extra_bins)
        idx0, bits0 = best_mvp_idx(mvp, mv_me0)
        variants.append((0, mv_me0, None,
                         self._mc(x, y, s, mv_me0, 0), idx0 + bits0 + 2))
        if is_b and mv_me1 is not None:
            idx1, bits1 = best_mvp_idx(mvp1, mv_me1)
            variants.append((1, None, mv_me1,
                             self._mc(x, y, s, mv_me1, 1), idx1 + bits1 + 2))
            variants.append((2, mv_me0, mv_me1,
                             self._mc_bi(x, y, s, mv_me0, mv_me1),
                             idx0 + bits0 + idx1 + bits1 + 1))
        # cheap preselect by prediction SSD, full T/Q on the winner
        pre = [(wssd(*v[3]), v) for v in variants]
        pre.sort(key=lambda t: t[0])
        _, (pred_dir, bmv0, bmv1, preds, extra_bins) = pre[0]
        (lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v, recs, ssd_i) = \
            self._tq_channels(x, y, s, *preds)
        bins_inter = (2 + extra_bins + 3 +
                      self._coef_bins(lev_y, nnz_y) +
                      self._coef_bins(lev_u, nnz_u) +
                      self._coef_bins(lev_v, nnz_v))
        cost_inter = ssd_i + lam * bins_inter

        # --- candidate 3: intra ---
        up, left, ul = gather_nb(self.rec_y, self.map_cod, x, y, s, s,
                                 x_scu, y_scu, MIN_CU_SIZE,
                                 self.w_scu, self.h_scu, bd)
        ipred_y = rk.ipred(ipm, up, left, ul, s, s)
        up, left, ul = gather_nb(self.rec_u, self.map_cod, xc, yc, sc, sc,
                                 x_scu, y_scu, MIN_CU_SIZE >> 1,
                                 self.w_scu, self.h_scu, bd)
        ipred_u = rk.ipred(ipm, up, left, ul, sc, sc)
        up, left, ul = gather_nb(self.rec_v, self.map_cod, xc, yc, sc, sc,
                                 x_scu, y_scu, MIN_CU_SIZE >> 1,
                                 self.w_scu, self.h_scu, bd)
        ipred_v = rk.ipred(ipm, up, left, ul, sc, sc)
        (ilev_y, innz_y, ilev_u, innz_u, ilev_v, innz_v, irecs, ssd_c) = \
            self._tq_channels(x, y, s, ipred_y, ipred_u, ipred_v)
        bins_intra = (2 + 3 + 3 + self._coef_bins(ilev_y, innz_y) +
                      self._coef_bins(ilev_u, innz_u) +
                      self._coef_bins(ilev_v, innz_v))
        cost_intra = ssd_c + lam * bins_intra

        # --- choose ---
        cands = [("skip", best_skip[0]), ("inter", cost_inter),
                 ("intra", cost_intra)]
        if best_direct is not None:
            cands.append(("direct", best_direct[0]))
        winner = min(cands, key=lambda t: t[1])[0]

        if winner == "skip":
            if is_b:
                cost, idx0s, idx1s, mv0, mv1, (py, pu, pv) = best_skip
            else:
                cost, idx0s, idx1s, mv0, mv1, (py, pu, pv) = best_skip
            syntax.write_skip_flag(self.sbac, self.ctx, 1)
            syntax.write_mvp_idx(self.sbac, self.ctx, idx0s)
            if is_b:
                syntax.write_mvp_idx(self.sbac, self.ctx, idx1s)
            self._store_cu_mv(x, y, s,
                              (np.clip(py, 0, (1 << bd) - 1),
                               np.clip(pu, 0, (1 << bd) - 1),
                               np.clip(pv, 0, (1 << bd) - 1)),
                              None, 0, None, 0, None, 0,
                              mv0, mv1 if is_b else None, write_coef=False)
        elif winner == "direct":
            (_, dmv0, dmv1, drecs, dl_y, dn_y, dl_u, dn_u, dl_v, dn_v) = best_direct
            syntax.write_skip_flag(self.sbac, self.ctx, 0)
            syntax.write_pred_mode(self.sbac, self.ctx, 0)
            self.sbac.encode_bin(1, self.ctx.direct_mode_flag, 0)
            self._store_cu_mv(x, y, s, drecs, dl_y, dn_y, dl_u, dn_u,
                              dl_v, dn_v, dmv0, dmv1, write_coef=True)
        elif winner == "inter":
            syntax.write_skip_flag(self.sbac, self.ctx, 0)
            syntax.write_pred_mode(self.sbac, self.ctx, 0)
            if is_b:
                self.sbac.encode_bin(0, self.ctx.direct_mode_flag, 0)
                # inter_pred_idc (xeve_eco_inter_pred_idc)
                if pred_dir == 2:
                    self.sbac.encode_bin(0, self.ctx.inter_dir, 0)
                else:
                    self.sbac.encode_bin(1, self.ctx.inter_dir, 0)
                    self.sbac.encode_bin(1 if pred_dir == 1 else 0,
                                         self.ctx.inter_dir, 1)
            if pred_dir in (0, 2):
                i0, _ = best_mvp_idx(mvp, bmv0)
                syntax.write_refi(self.sbac, self.ctx, 0, len(self.refp))
                syntax.write_mvp_idx(self.sbac, self.ctx, i0)
                syntax.write_mvd(self.sbac, self.ctx,
                                 bmv0[0] - int(mvp[i0][0]),
                                 bmv0[1] - int(mvp[i0][1]))
            if is_b and pred_dir in (1, 2):
                i1, _ = best_mvp_idx(mvp1, bmv1)
                syntax.write_refi(self.sbac, self.ctx, 0, len(self.refp1))
                syntax.write_mvp_idx(self.sbac, self.ctx, i1)
                syntax.write_mvd(self.sbac, self.ctx,
                                 bmv1[0] - int(mvp1[i1][0]),
                                 bmv1[1] - int(mvp1[i1][1]))
            self._store_cu_mv(x, y, s, recs, lev_y, nnz_y, lev_u, nnz_u,
                              lev_v, nnz_v,
                              bmv0 if pred_dir in (0, 2) else None,
                              bmv1 if (is_b and pred_dir in (1, 2)) else None,
                              write_coef=True)
        else:
            syntax.write_skip_flag(self.sbac, self.ctx, 0)
            syntax.write_pred_mode(self.sbac, self.ctx, 1)
            self._code_intra_payload(x, y, lg, ipm, ilev_y, innz_y,
                                     ilev_u, innz_u, ilev_v, innz_v, irecs)

    def _store_cu_mv(self, x, y, s, recs, lev_y, nnz_y, lev_u, nnz_u,
                     lev_v, nnz_v, mv0, mv1, write_coef):
        """Store an inter CU (L0/L1/bi) incl. coefficient syntax."""
        if write_coef:
            syntax.write_cbf_inter(self.sbac, self.ctx,
                                   1 if nnz_y else 0, 1 if nnz_u else 0,
                                   1 if nnz_v else 0)
            if nnz_y:
                syntax.write_coef_block(self.sbac, self.ctx, lev_y, 0)
            if nnz_u:
                syntax.write_coef_block(self.sbac, self.ctx, lev_u, 1)
            if nnz_v:
                syntax.write_coef_block(self.sbac, self.ctx, lev_v, 1)
        rec_y, rec_u, rec_v = recs
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        self.rec_y[y:y + s, x:x + s] = rec_y
        self.rec_u[yc:yc + sc, xc:xc + sc] = rec_u
        self.rec_v[yc:yc + sc, xc:xc + sc] = rec_v
        ys, xs = y >> MIN_CU_LOG2, x >> MIN_CU_LOG2
        n = s >> MIN_CU_LOG2
        self.map_cod[ys:ys + n, xs:xs + n] = True
        self.map_if[ys:ys + n, xs:xs + n] = False
        self.map_ipm[ys:ys + n, xs:xs + n] = 0
        self.map_cbf_l[ys:ys + n, xs:xs + n] = bool(nnz_y)
        for lidx, mv in ((0, mv0), (1, mv1)):
            if mv is not None:
                self.map_refi[ys:ys + n, xs:xs + n, lidx] = 0
                self.map_mv[ys:ys + n, xs:xs + n, lidx, 0] = mv[0]
                self.map_mv[ys:ys + n, xs:xs + n, lidx, 1] = mv[1]
            else:
                self.map_refi[ys:ys + n, xs:xs + n, lidx] = -1
        self.leaf_cus.append((x, y, s, s))

    # ------------------------------------------------------------------
    def _code_intra_cu(self, x, y, lg, ipm):
        """I-slice intra CU (same as IntraFramePass)."""
        s = 1 << lg
        bd = self.bd
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        up, left, ul = gather_nb(self.rec_y, self.map_cod, x, y, s, s,
                                 x_scu, y_scu, MIN_CU_SIZE,
                                 self.w_scu, self.h_scu, bd)
        pred_y = rk.ipred(ipm, up, left, ul, s, s)
        up, left, ul = gather_nb(self.rec_u, self.map_cod, xc, yc, sc, sc,
                                 x_scu, y_scu, MIN_CU_SIZE >> 1,
                                 self.w_scu, self.h_scu, bd)
        pred_u = rk.ipred(ipm, up, left, ul, sc, sc)
        up, left, ul = gather_nb(self.rec_v, self.map_cod, xc, yc, sc, sc,
                                 x_scu, y_scu, MIN_CU_SIZE >> 1,
                                 self.w_scu, self.h_scu, bd)
        pred_v = rk.ipred(ipm, up, left, ul, sc, sc)
        (lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v, recs, _ssd) = \
            self._tq_channels(x, y, s, pred_y, pred_u, pred_v)
        self._code_intra_payload(x, y, lg, ipm, lev_y, nnz_y, lev_u, nnz_u,
                                 lev_v, nnz_v, recs)

    def _code_intra_payload(self, x, y, lg, ipm, lev_y, nnz_y, lev_u, nnz_u,
                            lev_v, nnz_v, recs):
        s = 1 << lg
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        rank_tbl = syntax.mpm_rank_table(self.map_cod, self.map_if,
                                         self.map_ipm, x_scu, y_scu)
        syntax.write_intra_dir(self.sbac, self.ctx, int(rank_tbl[ipm]))
        syntax.write_cbf_intra(self.sbac, self.ctx,
                               1 if nnz_y else 0, 1 if nnz_u else 0,
                               1 if nnz_v else 0)
        if nnz_y:
            syntax.write_coef_block(self.sbac, self.ctx, lev_y, 0)
        if nnz_u:
            syntax.write_coef_block(self.sbac, self.ctx, lev_u, 1)
        if nnz_v:
            syntax.write_coef_block(self.sbac, self.ctx, lev_v, 1)
        self._store_cu(x, y, s, True, ipm, None, 0, recs,
                       lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v, skip=False)

    # ------------------------------------------------------------------
    def _store_cu(self, x, y, s, is_intra, ipm, mv, refi, recs,
                  lev_y, nnz_y, lev_u, nnz_u, lev_v, nnz_v, skip):
        if not is_intra and not skip:
            # write inter coefficients after cbf (syntax order)
            syntax.write_cbf_inter(self.sbac, self.ctx,
                                   1 if nnz_y else 0, 1 if nnz_u else 0,
                                   1 if nnz_v else 0)
            if nnz_y:
                syntax.write_coef_block(self.sbac, self.ctx, lev_y, 0)
            if nnz_u:
                syntax.write_coef_block(self.sbac, self.ctx, lev_u, 1)
            if nnz_v:
                syntax.write_coef_block(self.sbac, self.ctx, lev_v, 1)
        rec_y, rec_u, rec_v = recs
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        self.rec_y[y:y + s, x:x + s] = rec_y
        self.rec_u[yc:yc + sc, xc:xc + sc] = rec_u
        self.rec_v[yc:yc + sc, xc:xc + sc] = rec_v
        ys, xs = y >> MIN_CU_LOG2, x >> MIN_CU_LOG2
        n = s >> MIN_CU_LOG2
        self.map_cod[ys:ys + n, xs:xs + n] = True
        self.map_if[ys:ys + n, xs:xs + n] = is_intra
        self.map_ipm[ys:ys + n, xs:xs + n] = ipm if is_intra else 0
        self.map_cbf_l[ys:ys + n, xs:xs + n] = bool(nnz_y)
        if not is_intra:
            self.map_refi[ys:ys + n, xs:xs + n, 0] = refi
            self.map_refi[ys:ys + n, xs:xs + n, 1] = -1
            self.map_mv[ys:ys + n, xs:xs + n, 0, 0] = mv[0]
            self.map_mv[ys:ys + n, xs:xs + n, 0, 1] = mv[1]
        self.leaf_cus.append((x, y, s, s))
