"""Open-loop Main-profile (EIPD) intra analysis in PyTorch (port of
enc/analysis_main_jax.py).

Same structure as analysis_torch.py (dense per-level evaluation, no
gathers) over the 33-mode EIPD predictor set:
  - the 30 shift/filter modes (angular + V/H) are constant weight matrices
    (from ops/intra_main_batch.ang_tables) applied as one product per
    plane and level: (nby*nbx, 2(2s+1)) x (2(2s+1), 30*s*s);
  - DC / plane / bi-linear are direct batched float formulas;
  - IQT quantization scales, DM chroma (chroma follows the luma mode).

Numerics follow the JAX twin: f32 throughout, floor((x + c) / d) with
power-of-two d, the same order of operations (separate multiplies, no
fused multiply-add), and decisions only (the closed-loop C pass recomputes
exact integers).  The angular product is exact: every partial sum is an
integer below 2^24 (at most 4 taps x 1023 x 128), which holds in f32 with
TF32 off (device.resolve_device).

dispatch_main_torch() only enqueues work on the device (no host readback,
no stream synchronisation) and returns a handle holding one packed tensor;
collect_main_torch() makes the one device-to-host copy and runs the
partition DP on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (QUANT_SCALE, DQUANT_SCALE_MAIN,
                         MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT)
from ..device import resolve_device
from ..ops.intra_main_batch import ang_tables
from ..ops.intra_main_np import LUT_SIZE_PLUS1, _IB_MULT, _IB_SHIFT
from .analysis_np import AnalysisResult
from .analysis_torch import _blocks, _partition_dp, _tq_cost, to_device


@functools.lru_cache(maxsize=None)
def _ang_weights_np(s: int):
    """(30, s*s, 2s+1) up/left weight matrices covering modes
    3..11, 12(V), 13..23, 24(H), 25..32; weights are the 4-tap ADI filter
    values (sum 128), V/H rows are 128-one-hots.  Copy of
    analysis_main_jax._ang_weights (:32)."""
    n = 2 * s + 1
    modes = list(range(3, 33))
    Wu = np.zeros((len(modes), s * s, n), np.float32)
    Wl = np.zeros((len(modes), s * s, n), np.float32)
    for mi, m in enumerate(modes):
        if m == 12:        # VER: pred[j,i] = up[i]
            for j in range(s):
                for i in range(s):
                    Wu[mi, j * s + i, 1 + i] = 128.0
            continue
        if m == 24:        # HOR
            for j in range(s):
                for i in range(s):
                    Wl[mi, j * s + i, 1 + j] = 128.0
            continue
        src, idx, filt = ang_tables(m, s, s)
        for j in range(s):
            for i in range(s):
                p = j * s + i
                W = Wu if src[j, i] == 0 else Wl
                for k in range(4):
                    W[mi, p, idx[j, i, k]] += float(filt[j, i, k])
    return Wu, Wl


@functools.lru_cache(maxsize=None)
def _ang_weights(s: int, device: torch.device):
    """The up and left weights as one (2(2s+1), 30*s*s) f32 tensor on
    `device`, rows [up; left], so that [up, left] @ W is the 30 modes'
    raw predictions of a block (uploaded once per size and device)."""
    Wu, Wl = _ang_weights_np(s)
    W = np.concatenate([Wu, Wl], axis=2).reshape(30 * s * s, 2 * (2 * s + 1))
    return torch.as_tensor(np.ascontiguousarray(W.T), device=device)


def _pred_all_modes_main(up, left, s, bd):
    """up/left: (nby, nbx, 2s+1) f32.  Returns (nby, nbx, 33, s, s)."""
    nby, nbx, _ = up.shape
    dev = up.device
    lg = s.bit_length() - 1
    maxv = float((1 << bd) - 1)
    # DC (reciprocal LUT; square -> asp 0)
    ssum = up[:, :, 1:1 + s].sum(-1) + left[:, :, 1:1 + s].sum(-1) + s
    dc = torch.floor(ssum * LUT_SIZE_PLUS1[0] / float(1 << (lg + 12)))
    p_dc = dc[:, :, None, None].expand(nby, nbx, s, s)
    # plane; the JAX twin's reversed slice up[:, :, 1 + w2 - 2::-1][..., :w2]
    # is up[..., :w2] reversed (at s = 2 the corner alone)
    w2 = s >> 1
    idx = max(lg - 2, 0)
    im, ish = float(_IB_MULT[idx]), _IB_SHIFT[idx]
    ks = torch.arange(1, w2 + 1, dtype=torch.float32, device=dev)
    coef_h = (ks * (up[:, :, 1 + w2:1 + w2 + w2] -
                    up[:, :, :w2].flip(-1))).sum(-1)
    coef_v = (ks * (left[:, :, 1 + w2:1 + w2 + w2] -
                    left[:, :, :w2].flip(-1))).sum(-1)
    a = (left[:, :, 1 + s - 1] + up[:, :, 1 + s - 1]) * 16.0
    b = torch.floor((coef_h * 32.0 * im + (1 << (ish - 1))) / float(1 << ish))
    cc = torch.floor((coef_v * 32.0 * im + (1 << (ish - 1))) /
                     float(1 << ish))
    base = a - (w2 - 1) * cc - (w2 - 1) * b + 16.0
    ys = torch.arange(s, dtype=torch.float32, device=dev)
    xs = torch.arange(s, dtype=torch.float32, device=dev)
    p_pln = torch.floor((base[:, :, None, None]
                         + ys[None, None, :, None] * cc[:, :, None, None]
                         + xs[None, None, None, :] * b[:, :, None, None])
                        / 32.0)
    p_pln = torch.clamp(p_pln, 0.0, maxv)
    # bi-linear (square)
    aa = up[:, :, 1 + s]
    bb = left[:, :, 1 + s]
    c0 = torch.floor((aa + bb + 1) / 2.0)
    wt = 2.0 * c0 - aa - bb
    ref_up = up[:, :, 1:1 + s]
    ref_le = left[:, :, 1:1 + s]
    xs1 = torch.arange(1, s + 1, dtype=torch.float32, device=dev)
    predx = (ref_le * (1 << lg))[:, :, :, None] + \
        (aa[:, :, None] - ref_le)[:, :, :, None] * xs1[None, None, None, :]
    refu = (ref_up * (1 << lg))[:, :, None, :] + \
        (bb[:, :, None] - ref_up)[:, :, None, :] * xs1[None, None, :, None]
    wxy = (ys[None, None, :, None] * wt[:, :, None, None]) * \
        xs[None, None, None, :]
    p_bi = torch.floor((predx * (1 << lg) + refu * (1 << lg) + wxy +
                        (1 << (2 * lg))) / float(1 << (2 * lg + 1)))
    p_bi = torch.clamp(p_bi, 0.0, maxv)
    # angular + V/H: one product of the stacked neighbours with the weights
    W = _ang_weights(s, dev)
    raw = torch.cat([up, left], dim=2).reshape(nby * nbx, -1) @ W
    p_ang = torch.clamp(torch.floor((raw + 64.0) / 128.0),
                        0.0, maxv).reshape(nby, nbx, 30, s, s)
    return torch.cat([p_dc[:, :, None], p_pln[:, :, None],
                      p_bi[:, :, None], p_ang], dim=2)


def _nbr_main_torch(plane, s, bd):
    """Open-loop neighbour arrays (nby, nbx, 2s+1) following
    ops/intra_main_batch.open_loop_neighbors (slices/concats only)."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    mid = float(1 << (bd - 1))
    # right-extended rows above each block row (keep real pixels in
    # [wc, w) before edge-replicating, matching open_loop_neighbors)
    padr = torch.cat([plane, plane[:, w - 1:w].expand(h, s)],
                     dim=1)[:, :wc + s]                  # (h, wc+s)
    rows = padr[s - 1:hc - 1:s, :]                       # (nby-1, wc+s)
    A = torch.cat([torch.full((1, wc + s), mid, dtype=plane.dtype,
                              device=plane.device), rows], dim=0)
    Ab = A.reshape(nby, nbx + 1, s)
    upA, upB = Ab[:, :nbx], Ab[:, 1:nbx + 1]
    up_seg = torch.cat([upA, upB], dim=2)                # (nby, nbx, 2s)
    # corner: A[j, i*s-1] for i>0, A[j, 0] for i==0
    corner = torch.cat([A[:, 0:1], A[:, s - 1:nbx * s - 1:s]], dim=1)
    up = torch.cat([corner[:, :, None], up_seg], dim=2)
    # left columns
    padb = torch.cat([plane, plane[h - 1:h, :].expand(s, w)],
                     dim=0)[:hc + s, :]                  # (hc+s, w)
    le0 = corner[:, 0:1, None].expand(nby, 1, 2 * s)
    if nbx > 1:
        Bc = padb[:, s - 1:nbx * s - 1:s]                # (hc+s, nbx-1)
        Br = Bc.reshape(nby + 1, s, nbx - 1)
        leA, leB = Br[:nby], Br[1:nby + 1]
        le_seg = torch.cat([leA, leB], dim=1)            # (nby, 2s, nbx-1)
        le_seg = le_seg.permute(0, 2, 1)                 # (nby, nbx-1, 2s)
        le_seg = torch.cat([le0, le_seg], dim=1)
    else:
        le_seg = le0
    left = torch.cat([corner[:, :, None], le_seg], dim=2)
    return up, left


def main_quant_params(qp: int, bd: int, log2s: int):
    """IQT quantizer parameters (QUANT_SCALE[1] / DQUANT_SCALE_MAIN).
    Copy of analysis_main_jax.main_quant_params (:155)."""
    scale = float(QUANT_SCALE[1][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = float(171 << (shift_q - 9))
    dq_scale = float(int(DQUANT_SCALE_MAIN[qp % 6]) << (qp // 6))
    return scale, offset, float(1 << shift_q), dq_scale


def level_params_main(qp, qp_y, qp_u, qp_v, bd, lg):
    """(15,) f32 parameter vector for one level.  Copy of
    analysis_main_jax.level_params_main (:165)."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    p = (list(main_quant_params(qp_y, bd, lg)) +
         list(main_quant_params(qp_u, bd, lg - 1)) +
         list(main_quant_params(qp_v, bd, lg - 1)) + [lam, w_u, w_v])
    return np.asarray(p, dtype=np.float32)


def _level_cost_main(orig_y, orig_u, orig_v, prm, bd, lg):
    """Per-block best EIPD mode (int32) and its cost (f32) at level lg."""
    s = 1 << lg
    sc = s >> 1
    oy = _blocks(orig_y, s)
    upY, leY = _nbr_main_torch(orig_y, s, bd)
    pY = _pred_all_modes_main(upY, leY, s, bd)
    dY, bY = _tq_cost(oy, pY, prm[0:4], bd, s)
    ou = _blocks(orig_u, sc)
    ov = _blocks(orig_v, sc)
    upU, leU = _nbr_main_torch(orig_u, sc, bd)
    upV, leV = _nbr_main_torch(orig_v, sc, bd)
    pU = _pred_all_modes_main(upU, leU, sc, bd)
    pV = _pred_all_modes_main(upV, leV, sc, bd)
    dU, bU = _tq_cost(ou, pU, prm[4:8], bd, sc)
    dV, bV = _tq_cost(ov, pV, prm[8:12], bd, sc)
    lam, w_u, w_v = prm[12], prm[13], prm[14]
    nby, nbx = dY.shape[:2]
    cost = (dY + w_u * dU[:nby, :nbx] + w_v * dV[:nby, :nbx] +
            lam * (bY + bU[:nby, :nbx] + bV[:nby, :nbx] + 7.0))
    return torch.argmin(cost, dim=2).to(torch.int32), cost.amin(dim=2)


def _pack_main(parts):
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def dispatch_main_torch(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                        max_log2=6, min_log2=2, *, device):
    """Enqueue every level on `device` and return a handle holding one
    packed f32 tensor there (not read back).  Handle layout as
    dispatch_main_jax's: (vec, levels, h, w, lam, min_log2, max_log2)."""
    dev = resolve_device(device)
    h, w = orig_y.shape
    yt, ut, vt = (to_device(p, torch.float32, dev)
                  for p in (orig_y, orig_u, orig_v))
    levels = [lg for lg in range(min_log2, max_log2 + 1)
              if h >> lg and w >> lg]
    prms = to_device(np.stack([level_params_main(qp, qp_y, qp_u, qp_v, bd,
                                                 lg) for lg in levels]),
                     torch.float32, dev)
    parts = []
    for i, lg in enumerate(levels):
        parts.extend(_level_cost_main(yt, ut, vt, prms[i], bd=bd, lg=lg))
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    return (_pack_main(parts), levels, h, w, lam, min_log2, max_log2)


def collect_main_torch(handle) -> AnalysisResult:
    """The one device-to-host copy of the packed vector, then the decision
    maps and the partition DP on the host."""
    dev_vec, levels, h, w, lam, min_log2, max_log2 = handle
    vec = dev_vec.cpu().numpy()
    mode, leaf_cost = {}, {}
    for lg in range(min_log2, max_log2 + 1):
        if lg not in levels:
            s = 1 << lg
            mode[lg] = np.zeros((h // s, w // s), np.int32)
            leaf_cost[lg] = np.full(mode[lg].shape, np.inf)
    off = 0
    for lg in levels:
        s = 1 << lg
        nby, nbx = h // s, w // s
        n = nby * nbx
        mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
        off += n
        leaf_cost[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.float64)
        off += n
    res = _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2)
    res.eipd_modes = True      # mode maps hold EIPD directions (0..32)
    return res


def analyze_frame_main_torch(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                             bd, max_log2=6, min_log2=2, *,
                             device) -> AnalysisResult:
    return collect_main_torch(dispatch_main_torch(
        orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd, max_log2,
        min_log2, device=device))
