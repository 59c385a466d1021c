"""Open-loop Main-profile (EIPD) intra analysis — numpy oracle.

Same batched-tensor design as analysis_np.py (all blocks of every quadtree
level at once) but with the 33-mode EIPD predictor set
(ops/intra_main_batch.py), IQT quantization scales, and DM chroma.  The
JAX/TPU twin consumes the identical gather tables; this module is its
golden reference and the CPU fallback.

Reference behaviour being replaced: xevem_pintra.c (33-mode candidate SATD
list + per-candidate full RDO, depth-first) re-expressed as a dense batched
evaluation + partition DP (SURVEY.md §7.1).
"""
from __future__ import annotations

import numpy as np

from ..constants import SLICE_I
from ..ops.intra_main_batch import open_loop_neighbors, pred_all_modes_main
from .analysis_np import (AnalysisResult, _blocks, _fwd_tq_cost,
                          corrected_leaf)


def _level_modes_main(orig, s, qp_c, lam, bd, slice_type, tool_iqt):
    """(nby, nbx, 33) (dist, bits) for one plane at block size s."""
    up, left = open_loop_neighbors(orig, s, bd)
    nby, nbx = up.shape[:2]
    upf = up.reshape(nby * nbx, -1)
    lef = left.reshape(nby * nbx, -1)
    preds = pred_all_modes_main(upf, lef, s, s, bd)          # (N,33,s,s)
    preds = preds.reshape(nby, nbx, 33, s, s).astype(np.int32)
    ob = _blocks(orig, s)
    d, b, _ = _fwd_tq_cost(ob, preds, qp_c, lam, bd, slice_type,
                           tool_iqt=tool_iqt)
    return d, b


def analyze_frame_main(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                       slice_type=SLICE_I, max_log2=6, min_log2=2,
                       tool_iqt=1):
    """33-mode open-loop analysis; returns AnalysisResult whose mode maps
    hold EIPD mode indices (0..32)."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    h, w = orig_y.shape
    mode = {}
    leaf_cost = {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        if h // s == 0 or w // s == 0:
            # level larger than the picture: every node is a boundary
            # split; keep empty maps so the DP and coder skip the level
            mode[lg] = np.zeros((max(h // s, 0), max(w // s, 0)), np.int64)
            leaf_cost[lg] = np.full(mode[lg].shape, np.inf)
            continue
        dY, bY = _level_modes_main(orig_y, s, qp_y, lam, bd, slice_type,
                                   tool_iqt)
        sc = s >> 1
        dU, bU = _level_modes_main(orig_u, sc, qp_u, lam, bd, slice_type,
                                   tool_iqt)
        dV, bV = _level_modes_main(orig_v, sc, qp_v, lam, bd, slice_type,
                                   tool_iqt)
        nby, nbx = dY.shape[:2]
        dU, bU = dU[:nby, :nbx], bU[:nby, :nbx]
        dV, bV = dV[:nby, :nbx], bV[:nby, :nbx]
        # chroma follows the luma mode (DM); ~6 bins luma dir + 1 chroma
        cost = (dY + w_u * dU + w_v * dV
                + lam * (bY + bU + bV + 6.0 + 1.0))
        mode[lg] = np.argmin(cost, axis=2)
        leaf_cost[lg] = np.min(cost, axis=2)

    tree_cost = {min_log2: corrected_leaf(min_log2, leaf_cost[min_log2])}
    split = {min_log2: np.zeros_like(leaf_cost[min_log2], dtype=bool)}
    for lg in range(min_log2 + 1, max_log2 + 1):
        s = 1 << lg
        nby, nbx = leaf_cost[lg].shape
        child = tree_cost[lg - 1]
        ch = child[:nby * 2, :nbx * 2]
        sum4 = (ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2]
                + ch[1::2, 1::2])
        ys = (np.arange(nby) + 1) * s
        xs = (np.arange(nbx) + 1) * s
        valid = (ys[:, None] <= h) & (xs[None, :] <= w)
        leafc = np.where(valid, corrected_leaf(lg, leaf_cost[lg]), np.inf)
        split[lg] = sum4 + lam < leafc
        tree_cost[lg] = np.where(split[lg], sum4 + lam, leafc)
    res = AnalysisResult(mode=mode, split=split, leaf_cost=leaf_cost,
                          tree_cost=tree_cost)
    res.eipd_modes = True      # mode maps hold EIPD directions (0..32)
    return res
