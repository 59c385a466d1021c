"""Inter analysis in PyTorch (port of enc/analysis_inter_jax.py): dense
integer ME on the hand-written kernel, quarter-pel refinement on the 16
phase planes, and per-level inter costs.

Integer-exact stages (phase planes, gathers, refinement, MV maps, mvd
bins) reproduce the JAX twin bit for bit: arithmetic shifts on negative
MVs, an explicit int16 wrap of the separable intermediate, int32 wrap of
the SSD sums, strict < in candidate order, and the JAX even-count median
(mean of the two middle values, truncated toward zero).

Decisions only: the closed-loop coding pass recomputes exact MC and
residuals (chroma distortion uses nearest-pel chroma samples here).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import me_cuda
from ..tables import _MC_L
from .analysis_inter_np import InterAnalysisResult, ME_BLK_LOG2
from .analysis_torch import (_pack, _partition_dp, analyze_frame_torch,
                             to_device)

PAD = 64 + 16   # PIC_PAD_SIZE_L, matches api.py DPB padding


def _wrap(x, bits):
    """Two's-complement wrap of an integer tensor to `bits` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _interp_h(ext, co, shift):
    """8-tap filter along x of an edge-extended (+4 each side) plane;
    output width = input width - 8."""
    Wp = ext.shape[1] - 8
    acc = torch.zeros_like(ext[:, :Wp])
    for k in range(8):
        acc = acc + int(co[k]) * ext[:, 1 + k:1 + k + Wp]
    return acc >> shift


def _interp_v(ext, co, shift, off):
    Hp = ext.shape[0] - 8
    acc = torch.full_like(ext[:Hp, :], off)
    for k in range(8):
        acc = acc + int(co[k]) * ext[1 + k:1 + k + Hp, :]
    return acc >> shift


def _edge_pad(x, n):
    """np.pad(x, n, mode="edge") for a 2-D integer tensor."""
    h, w = x.shape
    rows = torch.arange(-n, h + n, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-n, w + n, device=x.device).clamp(0, w - 1)
    return x[rows][:, cols]


def _phase_planes(ref_pad, bd):
    """All 16 quarter-pel phase planes of a padded reference plane.
    Returns (16, Hp, Wp) int16 indexed [fy*4 + fx]; integer-exact
    xeve_mc.c semantics (single-direction shift 6 no offset; separable
    path truncates the intermediate to int16)."""
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    ext = _edge_pad(ref_pad.to(torch.int32), 4)
    planes = []
    # horizontal-filtered rows (kept row-extended for the vertical stage)
    h_full = {}
    h_tmp16 = {}
    for fx in (1, 2, 3):
        h_full[fx] = _interp_h(ext, _MC_L[fx], 6)
        h_tmp16[fx] = _wrap(_interp_h(ext, _MC_L[fx], shift1), 16)
    for fy in range(4):
        for fx in range(4):
            if fy == 0 and fx == 0:
                p = ext[4:-4, 4:-4]
            elif fy == 0:
                p = torch.clamp(h_full[fx][4:-4, :], 0, mx)
            elif fx == 0:
                p = torch.clamp(_interp_v(ext[:, 4:-4], _MC_L[fy], 6, 0),
                                0, mx)
            else:
                p = torch.clamp(_interp_v(h_tmp16[fx], _MC_L[fy], shift2,
                                          off2), 0, mx)
            planes.append(p.to(torch.int16))
    return torch.stack(planes)


def _gather_blocks(planes, mv_q, s, pad, nby, nbx):
    """Per-block s x s windows at per-block quarter-pel MVs.
    planes: (16, Hp, Wp); mv_q: (nby, nbx, 2) qpel int32.  Returns int32
    (nby, nbx, s, s)."""
    Hp, Wp = planes.shape[1:]
    dev = planes.device
    phase = mv_q & 3
    iv = mv_q >> 2
    pidx = (phase[..., 1] * 4 + phase[..., 0]).long()
    ar = torch.arange(s, device=dev)
    rows = (torch.arange(nby, device=dev) * s)[:, None, None] \
        + ar[None, None, :] + iv[..., 1][..., None] + pad
    cols = (torch.arange(nbx, device=dev) * s)[None, :, None] \
        + ar[None, None, :] + iv[..., 0][..., None] + pad
    rows = torch.clamp(rows, 0, Hp - 1).long()
    cols = torch.clamp(cols, 0, Wp - 1).long()
    g = planes[pidx[:, :, None, None], rows[:, :, :, None],
               cols[:, :, None, :]]
    return g.to(torch.int32)


def _cur_blocks(cur, s):
    h, w = cur.shape
    nby, nbx = h // s, w // s
    return cur[:nby * s, :nbx * s].reshape(nby, s, nbx, s).permute(0, 2, 1, 3)


def _subpel_refine(cur16, planes, int_mv, pad):
    """Half-pel then quarter-pel 3x3 refinement for all 16x16 blocks in
    parallel (oracle: analysis_inter_np.subpel_refine; candidate order and
    strict-< tie-break preserved)."""
    nby, nbx = int_mv.shape[:2]
    best = int_mv.to(torch.int32) * 4
    best_sad = torch.full((nby, nbx), torch.iinfo(torch.int32).max,
                          dtype=torch.int32, device=int_mv.device)
    for step in (2, 1):
        center = best
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                cand = center + torch.tensor([dx, dy], dtype=torch.int32,
                                             device=center.device)
                g = _gather_blocks(planes, cand, 16, pad, nby, nbx)
                sad = (cur16 - g).abs().sum(dim=(-1, -2)).to(torch.int32)
                upd = sad < best_sad
                best_sad = torch.where(upd, sad, best_sad)
                best = torch.where(upd[..., None], cand, best)
    return best


def _mv_for_level(mv16, lg, nby, nbx):
    """Per-level MV map (oracle: analysis_inter_np._mv_for_level).  Large
    CUs take jnp.median's even-count median: the mean of the two middle
    values, truncated toward zero (torch.median would return the lower)."""
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return mv16.repeat_interleave(f, dim=0) \
                   .repeat_interleave(f, dim=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m = mv16[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
    m = m.permute(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
    srt = torch.sort(m, dim=2).values
    n = f * f
    two_mid = srt[:, :, n // 2 - 1] + srt[:, :, n // 2]
    return torch.div(two_mid, 2, rounding_mode="trunc").to(torch.int32)


def _mvd_bits(mv_q):
    """(..., 2) qpel -> (...) bin-count (enc/syntax.py mvd_bits_est)."""
    a = torch.abs(mv_q)
    nn = (a + 1) >> 1
    len_i = torch.zeros_like(nn)
    for k in range(16):
        len_i = len_i + (nn >= (1 << k)).to(nn.dtype)
    return (2 * len_i + 1 + (a > 0).to(nn.dtype)).sum(-1)


def _int_mv(orig_y, ref_y_pad, R, pad):
    """Integer ME of the 16-aligned region on the kernel (CPU: its plain
    version)."""
    h, w = orig_y.shape
    hc, wc = (h // 16) * 16, (w // 16) * 16
    int_mv, _cost = me_cuda.integer_me(
        orig_y[:hc, :wc].contiguous(),
        ref_y_pad[:2 * pad + hc, :2 * pad + wc].contiguous(), pad, R)
    return int_mv


def _inter_costs(orig_y, orig_u, orig_v, ref_y_pad, ref_u_pad, ref_v_pad,
                 prm, R: int, bd: int, pad: int, min_log2: int,
                 max_log2: int):
    """ME + subpel + per-level inter cost maps for one reference (int32
    planes).  prm: (3,) f32 = (lam, w_u, w_v).  Returns a packed f32
    vector: per level [mv (nby,nbx,2), cost (nby,nbx)]."""
    h, w = orig_y.shape
    lam, w_u, w_v = prm[0], prm[1], prm[2]

    int_mv = _int_mv(orig_y, ref_y_pad, R, pad)
    planes = _phase_planes(ref_y_pad, bd)
    mv16 = _subpel_refine(_cur_blocks(orig_y, 16), planes, int_mv, pad)

    ref_u16 = ref_u_pad.to(torch.int16)[None]
    ref_v16 = ref_v_pad.to(torch.int16)[None]
    parts = []
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        mv_l = _mv_for_level(mv16, lg, nby, nbx)
        g = _gather_blocks(planes, mv_l, s, pad, nby, nbx)
        cb = _cur_blocks(orig_y, s)
        # the JAX twin sums the SSD in int32: keep its wrap
        d = _wrap(((cb - g) ** 2).sum(dim=(-1, -2)), 32).to(torch.float32)
        # chroma distortion from nearest-pel chroma samples (analysis
        # heuristic; the coding pass recomputes exact chroma MC)
        sc = s >> 1
        mvc = ((mv_l + 4) >> 3) * 4   # integer chroma pels, "qpel" encoding
        gu = _gather_blocks(ref_u16, mvc, sc, pad // 2, nby, nbx)
        gv = _gather_blocks(ref_v16, mvc, sc, pad // 2, nby, nbx)
        cu = _cur_blocks(orig_u, sc)[:nby, :nbx]
        cv = _cur_blocks(orig_v, sc)[:nby, :nbx]
        du = _wrap(((cu - gu) ** 2).sum(dim=(-1, -2)), 32).to(torch.float32)
        dv = _wrap(((cv - gv) ** 2).sum(dim=(-1, -2)), 32).to(torch.float32)
        dall = d + w_u * du + w_v * dv
        bits = 8.0 + _mvd_bits(mv_l).to(torch.float32)
        cost = torch.minimum(
            dall + lam * 4.0,
            0.35 * dall + lam * (bits + 0.02 * torch.sqrt(dall) * s))
        parts.append(mv_l)
        parts.append(cost)
    return _pack(parts)


def _mv_only(orig_y, ref_y_pad, R: int, bd: int, pad: int,
             min_log2: int, max_log2: int):
    """ME + subpel + per-level MV maps only (L1 of B slices: the oracle
    costs only L0)."""
    h, w = orig_y.shape
    int_mv = _int_mv(orig_y, ref_y_pad, R, pad)
    planes = _phase_planes(ref_y_pad, bd)
    mv16 = _subpel_refine(_cur_blocks(orig_y, 16), planes, int_mv, pad)
    parts = []
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        parts.append(_mv_for_level(mv16, lg, h // s, w // s))
    return _pack(parts)


def analyze_frame_inter_torch(orig_y, orig_u, orig_v, refp, qp, qp_y, qp_u,
                              qp_v, bd, search_range=16, refp1=None,
                              max_log2=6, min_log2=2, *,
                              device) -> InterAnalysisResult:
    """P/B-frame analysis on `device`: intra level costs (analysis_torch)
    + dense inter level costs -> combined partition DP on the host."""
    dev = resolve_device(device)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    h, w = orig_y.shape
    R = int(search_range)

    y_dev = to_device(orig_y, torch.int32, dev)
    u_dev = to_device(orig_u, torch.int32, dev)
    v_dev = to_device(orig_v, torch.int32, dev)
    intra = analyze_frame_torch(y_dev, u_dev, v_dev, qp, qp_y, qp_u, qp_v,
                                bd, max_log2=max_log2, min_log2=min_log2,
                                device=dev)
    ref = refp[0]
    prm = torch.as_tensor(np.array([lam, w_u, w_v], np.float32), device=dev)
    vec = _inter_costs(
        y_dev, u_dev, v_dev,
        to_device(ref["y_pad"], torch.int32, dev),
        to_device(ref["u_pad"], torch.int32, dev),
        to_device(ref["v_pad"], torch.int32, dev),
        prm, R=R, bd=bd, pad=PAD, min_log2=min_log2,
        max_log2=max_log2).cpu().numpy()

    mv1 = None
    if refp1 and refp1[0]["poc"] != ref["poc"]:
        vec1 = _mv_only(y_dev, to_device(refp1[0]["y_pad"], torch.int32, dev),
                        R=R, bd=bd, pad=PAD, min_log2=min_log2,
                        max_log2=max_log2).cpu().numpy()
        mv1 = {}
        off = 0
        for lg in range(min_log2, max_log2 + 1):
            s = 1 << lg
            nby, nbx = h // s, w // s
            mv1[lg] = vec1[off:off + nby * nbx * 2].reshape(nby, nbx, 2) \
                                                   .astype(np.int32)
            off += nby * nbx * 2

    mode, mv, leaf_cost = {}, {}, {}
    off = 0
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        mv[lg] = vec[off:off + nby * nbx * 2].reshape(nby, nbx, 2) \
                                             .astype(np.int32)
        off += nby * nbx * 2
        cost_i = vec[off:off + nby * nbx].reshape(nby, nbx).astype(np.float64)
        off += nby * nbx
        mode[lg] = intra.mode[lg]
        leaf_cost[lg] = np.minimum(intra.leaf_cost[lg], cost_i)
    if refp1 and mv1 is None:
        mv1 = {lg: mv[lg] for lg in mv}

    dp = _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2)
    return InterAnalysisResult(mode=mode, split=dp.split, leaf_cost=leaf_cost,
                               tree_cost=dp.tree_cost, mv=mv, mv1=mv1)
