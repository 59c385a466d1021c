"""Open-loop intra analysis in PyTorch (port of enc/analysis_jax.py).

For every quadtree level, predictions for all 5 Baseline modes of every
block are formed at once, transformed with constant-matrix products,
quantized, inverse-transformed and costed (distortion + bin-count rate
estimate).  The partition DP runs on the host on the small per-level cost
maps.  BatchAnalyzer analyses N frames with one upload and one download.

Numerics follow the JAX twin: f32 throughout, floor((x + c) / d) with
power-of-two d, and decisions only (the closed-loop C pass recomputes
exact integers).  The second transform product can exceed 2^24, so the
summation order of the backend can move a cost by an ulp; that is the one
place where the port is held to a tolerance rather than bit equality.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import (QUANT_SCALE, DQUANT_SCALE_B, MAX_TX_DYNAMIC_RANGE,
                         QUANT_SHIFT, QUANT_IQUANT_SHIFT)
from ..device import resolve_device
from .analysis_np import AnalysisResult, BITS_SCALE, corrected_leaf
from ..tables import load_tables


def _blocks(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).permute(0, 2, 1, 3)


def _neighbors(plane, s, bd):
    """up (nby,nbx,2s), left (nby,nbx,2s), ul (nby,nbx) — slices/concat only."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    mid = float(1 << (bd - 1))

    def full(*shape):
        return torch.full(shape, mid, dtype=plane.dtype, device=plane.device)

    # up rows: row above each block row; block row 0 -> mid
    rows = torch.cat([full(1, wc), plane[s - 1:hc - 1:s, :wc]], dim=0)
    upA = rows.reshape(nby, nbx, s)                      # own up segment
    # next block's up segment (to the right); last -> mid
    upB = torch.cat([upA[:, 1:, :], full(nby, 1, s)], dim=1)
    up = torch.cat([upA, upB], dim=2)                    # (nby, nbx, 2s)

    cols = torch.cat([full(hc, 1), plane[:hc, s - 1:wc - 1:s]], dim=1)
    leA = cols.T.reshape(nbx, nby, s).permute(1, 0, 2)   # (nby, nbx, s)
    leB = torch.cat([leA[1:, :, :], full(1, nbx, s)], dim=0)
    left = torch.cat([leA, leB], dim=2)                  # (nby, nbx, 2s)

    ul = full(nby, nbx)
    ul[1:, 1:] = plane[s - 1:hc - 1:s, s - 1:wc - 1:s]
    return up, left, ul


def _pred_all_modes(up, left, ul, s):
    nby, nbx, _ = up.shape
    dc = torch.floor((left[:, :, :s].sum(-1) + up[:, :, :s].sum(-1) + s)
                     / (2 * s))
    p_dc = dc[:, :, None, None].expand(nby, nbx, s, s)
    p_hor = left[:, :, :s, None].expand(nby, nbx, s, s)
    p_ver = up[:, :, None, :s].expand(nby, nbx, s, s)
    ul_up, ul_le, ul_c, ur_up, ur_le = load_tables(up.device)["sel"][s]
    p_ul = (torch.einsum('pk,yxk->yxp', ul_up, up) +
            torch.einsum('pk,yxk->yxp', ul_le, left)).reshape(nby, nbx, s, s)
    p_ul = p_ul + ul_c[None, None] * ul[:, :, None, None]
    p_ur = (torch.einsum('pk,yxk->yxp', ur_up, up) +
            torch.einsum('pk,yxk->yxp', ur_le, left)).reshape(nby, nbx, s, s)
    p_ur = torch.floor(p_ur)
    return torch.stack([p_dc, p_hor, p_ver, p_ul, p_ur], dim=2)


def quant_params(qp: int, bd: int, log2s: int):
    """Host-side derivation of the dynamic quantizer parameters for one
    channel at one level: (q_scale, q_offset, q_div, dq_scale).
    Copy of analysis_jax.quant_params (:133)."""
    scale = float(QUANT_SCALE[0][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = float(171 << (shift_q - 9))
    dq_scale = float(int(DQUANT_SCALE_B[qp % 6]) << (qp // 6))
    return scale, offset, float(1 << shift_q), dq_scale


def _tq_cost(orig_blocks, preds, qprm, bd, s):
    """(nby, nbx, 5) -> (dist, bits), f32.
    qprm: (4,) tensor from quant_params."""
    tabs = load_tables(preds.device)
    T = tabs["tm"][s]
    log2s = int(np.log2(s))
    shift_fwd = (log2s - 1 + bd - 8) + (log2s + 6)
    q_scale, q_off, q_div, dq_scale = qprm[0], qprm[1], qprm[2], qprm[3]
    resi = orig_blocks[:, :, None, :, :] - preds
    c1 = torch.einsum('vk,yxmkl->yxmvl', T, resi)
    coef = torch.einsum('yxmvl,ul->yxmvu', c1, T)
    coef = torch.floor((coef + (1 << (shift_fwd - 1))) / (1 << shift_fwd))
    lev = torch.floor((torch.abs(coef) * q_scale + q_off) / q_div)
    lev = torch.clamp(lev, max=32767.0)
    slev = torch.sign(coef) * lev
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_dq = QUANT_IQUANT_SHIFT - QUANT_SHIFT - tr_shift
    dq = torch.floor((slev * dq_scale + (1 << (shift_dq - 1)))
                     / (1 << shift_dq))
    dq = torch.clamp(dq, -32768, 32767)
    shift_inv = 7 + (12 - (bd - 8))
    r1 = torch.einsum('vk,yxmvu->yxmku', T, dq)
    resi_rec = torch.floor((torch.einsum('yxmku,un->yxmkn', r1, T) +
                            (1 << (shift_inv - 1))) / (1 << shift_inv))
    rec = torch.clamp(preds + resi_rec, 0, (1 << bd) - 1)
    dist = ((orig_blocks[:, :, None] - rec) ** 2).sum(dim=(-1, -2))

    # rate estimate without any gather: scan-rank constant matrix
    rank = tabs["scan_rank"][s][None, None, None]
    nz = lev > 0
    nsig = nz.sum(dim=(-1, -2)).to(torch.float32)
    last_idx = torch.where(nsig > 0,
                           torch.where(nz, rank, -1.0).amax(dim=(-1, -2)),
                           -1.0)
    lev_bins = torch.clamp(lev, max=32.0).sum(dim=(-1, -2))
    bits = BITS_SCALE * ((last_idx + 1.0) + lev_bins + 2.0 * nsig) + 3.0
    bits = torch.where(nsig == 0, 3.0, bits)
    return dist, bits


def level_params(qp: int, qp_y: int, qp_u: int, qp_v: int, bd: int, lg: int):
    """(15,) f32 parameter vector for one level: 3x quant_params + lam,
    w_u, w_v.  Copy of analysis_jax.level_params (:183)."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    p = (list(quant_params(qp_y, bd, lg)) +
         list(quant_params(qp_u, bd, lg - 1)) +
         list(quant_params(qp_v, bd, lg - 1)) + [lam, w_u, w_v])
    return np.asarray(p, dtype=np.float32)


def _level_cost_impl(orig_y, orig_u, orig_v, prm, bd, lg):
    """Per-block best mode (int32) and its cost (f32) at level lg."""
    s = 1 << lg
    sc = s >> 1
    oy = _blocks(orig_y, s)
    pY = _pred_all_modes(*_neighbors(orig_y, s, bd), s)
    dY, bY = _tq_cost(oy, pY, prm[0:4], bd, s)
    ou = _blocks(orig_u, sc)
    ov = _blocks(orig_v, sc)
    pU = _pred_all_modes(*_neighbors(orig_u, sc, bd), sc)
    pV = _pred_all_modes(*_neighbors(orig_v, sc, bd), sc)
    dU, bU = _tq_cost(ou, pU, prm[4:8], bd, sc)
    dV, bV = _tq_cost(ov, pV, prm[8:12], bd, sc)
    lam, w_u, w_v = prm[12], prm[13], prm[14]
    nby, nbx = dY.shape[:2]
    cost = (dY + w_u * dU[:nby, :nbx] + w_v * dV[:nby, :nbx] +
            lam * (bY + bU[:nby, :nbx] + bV[:nby, :nbx] + 3.0))
    return torch.argmin(cost, dim=2).to(torch.int32), cost.amin(dim=2)


def _analyze_levels(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                    bd, min_log2, max_log2):
    out = {}
    for lg in range(min_log2, max_log2 + 1):
        prm = torch.as_tensor(level_params(qp, qp_y, qp_u, qp_v, bd, lg),
                              device=orig_y.device)
        out[lg] = _level_cost_impl(orig_y, orig_u, orig_v, prm, bd=bd, lg=lg)
    return out


def _pack(parts):
    return torch.cat([p.to(torch.float32).reshape(-1) for p in parts])


def _analyze_packed(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                    bd=10, min_log2=2, max_log2=6):
    """All levels' (mode, cost) maps in one f32 vector, so one buffer
    crosses from the device to the host."""
    res = _analyze_levels(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                          bd, min_log2, max_log2)
    parts = []
    for lg in sorted(res):
        m, c = res[lg]
        parts.append(m)
        parts.append(c)
    return _pack(parts)


def _unpack(vec: np.ndarray, h: int, w: int, min_log2: int, max_log2: int):
    """Copy of analysis_jax._unpack (:248)."""
    mode, leaf_cost = {}, {}
    off = 0
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        n = nby * nbx
        mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
        off += n
        leaf_cost[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.float64)
        off += n
    return mode, leaf_cost


def _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2):
    """Bottom-up split DP on the host.  Copy of analysis_jax._partition_dp
    (:262)."""
    tree_cost = {min_log2: corrected_leaf(min_log2, leaf_cost[min_log2])}
    split = {min_log2: np.zeros_like(leaf_cost[min_log2], dtype=bool)}
    for lg in range(min_log2 + 1, max_log2 + 1):
        s = 1 << lg
        nby, nbx = leaf_cost[lg].shape
        ch = tree_cost[lg - 1][:nby * 2, :nbx * 2]
        sum4 = ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] + ch[1::2, 1::2]
        ys = (np.arange(nby) + 1) * s
        xs = (np.arange(nbx) + 1) * s
        valid = (ys[:, None] <= h) & (xs[None, :] <= w)
        leafc = np.where(valid, corrected_leaf(lg, leaf_cost[lg]), np.inf)
        split[lg] = sum4 + lam < leafc
        tree_cost[lg] = np.where(split[lg], sum4 + lam, leafc)
    return AnalysisResult(mode=mode, split=split, leaf_cost=leaf_cost,
                          tree_cost=tree_cost)


def to_device(plane, dtype, device):
    """A host plane (numpy or tensor) as a contiguous `dtype` tensor on
    `device`; the upload keeps the plane's own integer type.  It makes no
    stream synchronisation: a host-to-device copy from pageable memory is
    staged before the call returns."""
    t = torch.as_tensor(np.ascontiguousarray(plane)) \
        if isinstance(plane, np.ndarray) else plane
    return t.to(device=device, non_blocking=True).to(dtype).contiguous()


def analyze_frame_torch(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                        max_log2=6, min_log2=2, *, device) -> AnalysisResult:
    """Intra level costs on `device` + host-side partition DP."""
    dev = resolve_device(device)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    h, w = orig_y.shape
    vec = _analyze_packed(to_device(orig_y, torch.float32, dev),
                          to_device(orig_u, torch.float32, dev),
                          to_device(orig_v, torch.float32, dev),
                          qp, qp_y, qp_u, qp_v,
                          bd=bd, min_log2=min_log2, max_log2=max_log2)
    mode, leaf_cost = _unpack(vec.cpu().numpy(), h, w, min_log2, max_log2)
    return _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2)


class BatchAnalyzer:
    """N independent frames per call: one int16 upload of (B, n_y + 2 n_c),
    the level costs of every frame on `device`, one packed f32 download of
    (B, .), then the host partition DP per frame.  Port of
    analysis_jax.BatchAnalyzer (:301).

    The JAX package vmaps `_level_cost_impl` over the batch.  Here each
    frame runs the single-frame graph in turn inside the one call: a
    batched product may sum in another order (the f32 products above 2^24,
    module docstring), and the per-frame graph keeps every decision equal
    to analyze_frame_torch's on the same device."""

    def __init__(self, w: int, h: int, qp: int, qp_y: int, qp_u: int,
                 qp_v: int, bd: int = 10, min_log2: int = 2,
                 max_log2: int = 6, *, device):
        self.device = resolve_device(device)
        self.w, self.h = w, h
        self.bd = bd
        self.min_log2, self.max_log2 = min_log2, max_log2
        self.lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        self.n_y = w * h
        self.n_c = (w // 2) * (h // 2)
        self.prms = {lg: torch.as_tensor(
            level_params(qp, qp_y, qp_u, qp_v, bd, lg), device=self.device)
            for lg in range(min_log2, max_log2 + 1)}

    def _run(self, data):
        """(B, n_y + 2 n_c) int16 on the device -> (B, .) packed f32."""
        w, h, n_y, n_c = self.w, self.h, self.n_y, self.n_c
        rows = []
        for row in data.to(torch.float32):
            y = row[:n_y].reshape(h, w)
            u = row[n_y:n_y + n_c].reshape(h // 2, w // 2)
            v = row[n_y + n_c:].reshape(h // 2, w // 2)
            parts = []
            for lg in range(self.min_log2, self.max_log2 + 1):
                parts += _level_cost_impl(y, u, v, self.prms[lg], self.bd, lg)
            rows.append(_pack(parts))
        return torch.stack(rows)

    def analyze(self, frames) -> list[AnalysisResult]:
        """frames: list of (y, u, v) int arrays.  Returns AnalysisResults."""
        data = np.empty((len(frames), self.n_y + 2 * self.n_c), np.int16)
        for i, (y, u, v) in enumerate(frames):
            data[i, :self.n_y] = np.asarray(y).reshape(-1)
            data[i, self.n_y:self.n_y + self.n_c] = np.asarray(u).reshape(-1)
            data[i, self.n_y + self.n_c:] = np.asarray(v).reshape(-1)
        vecs = self._run(to_device(data, torch.int16, self.device)) \
            .cpu().numpy()
        return [_partition_dp(*_unpack(vec, self.h, self.w, self.min_log2,
                                       self.max_log2),
                              self.h, self.w, self.lam, self.min_log2,
                              self.max_log2)
                for vec in vecs]
