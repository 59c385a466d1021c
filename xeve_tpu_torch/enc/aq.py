"""Adaptive quantization: per-block qp offsets from local variance
(xeve_fcst.c:271 adaptive_quantization re-expressed as vectorized numpy),
plus a cutree-lite propagation pass along the dense-ME MV field
(blk_tree_fixed_gop analog, xeve_fcst.c:629).

Model (matching the reference constants, xeve_fcst.h:37-41):
  per 32x32 block: var = mean over its 16x16 sub-blocks of
                         (ssum - sum^2/256)
                   summed over Y + U + V (chroma at 16x16 block/8x8 sub)
  offset = clip(int(0.75 * (log2(max(var,1)) - (bd-8+7.2135)*2) * 0.5),
                -5, 5)
  then the integer mean over the frame is subtracted (rate-neutral).
"""
from __future__ import annotations

import numpy as np

AQ_STR_CONST = 0.75
AQ_STRENGTH = 0.5
LOG2_AQ_BLK = 4          # 16x16 variance sub-blocks
LOG2_AQ_CU = 5           # 32x32 offset blocks


def _blk_var(plane: np.ndarray, log2_sub: int) -> np.ndarray:
    """Per-sub-block integer variance term ssum - sum^2/N over a plane
    cropped to a multiple of the sub-block size.  Returns the (nby, nbx)
    int64 grid."""
    s = 1 << log2_sub
    h, w = plane.shape
    nby, nbx = h // s, w // s
    p = plane[:nby * s, :nbx * s].astype(np.int64)
    b = p.reshape(nby, s, nbx, s)
    sums = b.sum(axis=(1, 3))
    ssums = (b * b).sum(axis=(1, 3))
    return ssums - ((sums * sums) >> (2 * log2_sub))


def aq_block_offsets(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     bd: int) -> np.ndarray:
    """Per-32x32-block AQ qp offsets, mean-normalized (int32 grid over the
    ceil 32-grid of the frame; blocks touching the right/bottom edge get
    variance 0 like the reference)."""
    h, w = y.shape
    s = 1 << LOG2_AQ_CU
    nby, nbx = -(-h // s), -(-w // s)
    vy = _blk_var(y, LOG2_AQ_BLK)
    vu = _blk_var(u, LOG2_AQ_BLK - 1)
    vv = _blk_var(v, LOG2_AQ_BLK - 1)

    var = np.zeros((nby, nbx), np.int64)
    f = 1 << (LOG2_AQ_CU - LOG2_AQ_BLK)      # sub-blocks per block side
    for by in range(nby):
        for bx in range(nbx):
            x, yy = bx * s, by * s
            if x + s >= w or yy + s >= h:    # reference edge rule (:305)
                continue
            sub = vy[by * f:(by + 1) * f, bx * f:(bx + 1) * f]
            vt = int(sub.sum()) >> (2 * (LOG2_AQ_CU - LOG2_AQ_BLK))
            subu = vu[by * f:(by + 1) * f, bx * f:(bx + 1) * f]
            subv = vv[by * f:(by + 1) * f, bx * f:(bx + 1) * f]
            vt += int(subu.sum()) >> (2 * (LOG2_AQ_CU - LOG2_AQ_BLK))
            vt += int(subv.sum()) >> (2 * (LOG2_AQ_CU - LOG2_AQ_BLK))
            var[by, bx] = vt

    aq_bd_const = (bd - 8 + 7.2135) * 2.0
    vald = (AQ_STR_CONST * (np.log2(np.maximum(var.astype(np.float64), 1.0))
                            - aq_bd_const) * AQ_STRENGTH).astype(np.int64)
    off = np.clip(vald, -5, 5).astype(np.int32)
    # normalize: subtract the truncating integer mean (xeve_fcst.c:344-352)
    mean = int(off.sum()) // off.size
    return off - mean


def cutree_propagate(off: np.ndarray, mv16c_list, weight: float = 1.0
                     ) -> np.ndarray:
    """Cutree-lite: lower qp on 32x32 blocks that future frames' dense-ME
    MV fields point into (they propagate quality forward).  mv16c_list:
    per future frame, the (nby16, nbx16, 2) qpel MV field referencing THIS
    frame.  Each referencing 16x16 block votes for the 32x32 block its
    motion lands in; offsets drop by up to 2 with vote density
    (blk_tree_fixed_gop's transfer-amount idea at block granularity)."""
    votes = np.zeros_like(off, dtype=np.float64)
    nby, nbx = off.shape
    for mv16 in mv16c_list:
        gby, gbx = mv16.shape[:2]
        ys = (np.arange(gby) * 16)[:, None] + 8 + (mv16[..., 1] >> 2)
        xs = (np.arange(gbx) * 16)[None, :] + 8 + (mv16[..., 0] >> 2)
        by = np.clip(ys >> 5, 0, nby - 1)
        bx = np.clip(xs >> 5, 0, nbx - 1)
        np.add.at(votes, (by, bx), 0.25)     # 4 blocks vote per 32x32
    dec = np.minimum(np.round(weight * np.log2(1.0 + votes)), 2.0)
    out = off - dec.astype(np.int32)
    return np.clip(out, -5, 5)


def offsets_to_scu_map(off: np.ndarray, h_aligned: int, w_aligned: int
                       ) -> np.ndarray:
    """Expand the 32x32-block offset grid to the per-SCU (4x4) int8 map the
    coding pass consumes (pico->sinfo.map_qp_scu analog)."""
    h_scu = (h_aligned + 3) >> 2
    w_scu = (w_aligned + 3) >> 2
    m = np.repeat(np.repeat(off, 8, axis=0), 8, axis=1)
    return np.ascontiguousarray(m[:h_scu, :w_scu].astype(np.int8))
