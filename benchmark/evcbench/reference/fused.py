"""Plain reference of the fused device analyzer's decisions.

A frozen copy of the port's fused per-frame analysis graph
(xeve_tpu_torch/enc/device_analyzer.py `_fused_impl` with the pieces of
analysis_torch.py, analysis_inter_torch.py, winmc_torch.py and tables.py
that it runs), in plain PyTorch, with one change: every floating-point
tensor takes the dtype passed to `analyze` (float64 for the reference).
The integer stages (coarse ME sums below 2^24, qpel search, re-search,
MV maps) are exact in either dtype, so the MVs must equal the program's;
the level costs, and with them the intra modes and the split DP, carry
the dtype's rounding.

It returns the decision maps in the form the program's collect() hands
to its coding pass (mode, split, and the MV maps per level of each
present reference plane) and imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import (QUANT_SCALE, DQUANT_SCALE_B, MAX_TX_DYNAMIC_RANGE,
                        QUANT_SHIFT, QUANT_IQUANT_SHIFT, TM, SCAN)

PAD = 64 + 16
RESEARCH_OFFS = (-4, -2, -1, 0, 1, 2, 4)
ME_BLK_LOG2 = 4
LEVEL_COST_CORRECTION = {2: 1.3, 3: 1.1}
BITS_SCALE = 1.0
MAX_MV_PEL = 23

_MC_L = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                  [0, 1, -5, 52, 20, -5, 1, 0],
                  [0, 2, -10, 40, 40, -10, 2, 0],
                  [0, 1, -5, 20, 52, -5, 1, 0]], dtype=np.int32)


class _Ctx:
    """The float dtype of one analysis and its constant tensors."""

    def __init__(self, dtype, device):
        self.F = dtype
        self.device = device
        self._const = {}
        self._tables = None

    def const(self, arr):
        arr = np.ascontiguousarray(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        t = self._const.get(key)
        if t is None:
            t = self._const[key] = torch.as_tensor(arr, device=self.device)
        return t

    def tables(self):
        if self._tables is None:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64),
                                       device=self.device).to(self.F)
            sizes = (2, 4, 8, 16, 32, 64)
            rank = {}
            for n in sizes:
                r = np.empty(n * n, dtype=np.float64)
                r[SCAN[(n, n)]] = np.arange(n * n, dtype=np.float64)
                rank[n] = r.reshape(n, n)
            self._tables = {
                "tm": {n: t(TM[n]) for n in sizes},
                "scan_rank": {n: t(rank[n]) for n in sizes},
                "sel": {n: tuple(t(m) for m in _sel_matrices(n))
                        for n in sizes},
            }
        return self._tables


def _sel_matrices(s: int):
    n = s * s
    ul_up = np.zeros((n, 2 * s))
    ul_le = np.zeros((n, 2 * s))
    ul_c = np.zeros((s, s))
    ur_up = np.zeros((n, 2 * s))
    ur_le = np.zeros((n, 2 * s))
    for i in range(s):
        for j in range(s):
            d = i - j
            p = i * s + j
            if d > 0:
                ul_le[p, d - 1] = 1.0
            elif d == 0:
                ul_c[i, j] = 1.0
            else:
                ul_up[p, -d - 1] = 1.0
            ur_up[p, i + j + 1] = 0.5
            ur_le[p, i + j + 1] = 0.5
    return ul_up, ul_le, ul_c, ur_up, ur_le


def _wrap(x, bits):
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _ceil_div(a, b):
    return -(-a // b)


def corrected_leaf(lg, cost):
    g = LEVEL_COST_CORRECTION.get(lg)
    return cost * g if g else cost


# ---------------------------------------------------------------------------
# intra level costs
# ---------------------------------------------------------------------------


def _blocks(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).permute(
        0, 2, 1, 3)


def _neighbors(plane, s, bd):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    mid = float(1 << (bd - 1))

    def full(*shape):
        return torch.full(shape, mid, dtype=plane.dtype, device=plane.device)

    rows = torch.cat([full(1, wc), plane[s - 1:hc - 1:s, :wc]], dim=0)
    upA = rows.reshape(nby, nbx, s)
    upB = torch.cat([upA[:, 1:, :], full(nby, 1, s)], dim=1)
    up = torch.cat([upA, upB], dim=2)
    cols = torch.cat([full(hc, 1), plane[:hc, s - 1:wc - 1:s]], dim=1)
    leA = cols.T.reshape(nbx, nby, s).permute(1, 0, 2)
    leB = torch.cat([leA[1:, :, :], full(1, nbx, s)], dim=0)
    left = torch.cat([leA, leB], dim=2)
    ul = full(nby, nbx)
    ul[1:, 1:] = plane[s - 1:hc - 1:s, s - 1:wc - 1:s]
    return up, left, ul


def _pred_all_modes(cx, up, left, ul, s):
    nby, nbx, _ = up.shape
    dc = torch.floor((left[:, :, :s].sum(-1) + up[:, :, :s].sum(-1) + s)
                     / (2 * s))
    p_dc = dc[:, :, None, None].expand(nby, nbx, s, s)
    p_hor = left[:, :, :s, None].expand(nby, nbx, s, s)
    p_ver = up[:, :, None, :s].expand(nby, nbx, s, s)
    ul_up, ul_le, ul_c, ur_up, ur_le = cx.tables()["sel"][s]
    p_ul = (torch.einsum('pk,yxk->yxp', ul_up, up) +
            torch.einsum('pk,yxk->yxp', ul_le, left)).reshape(nby, nbx, s, s)
    p_ul = p_ul + ul_c[None, None] * ul[:, :, None, None]
    p_ur = (torch.einsum('pk,yxk->yxp', ur_up, up) +
            torch.einsum('pk,yxk->yxp', ur_le, left)).reshape(nby, nbx, s, s)
    p_ur = torch.floor(p_ur)
    return torch.stack([p_dc, p_hor, p_ver, p_ul, p_ur], dim=2)


def quant_params(qp: int, bd: int, log2s: int):
    scale = float(QUANT_SCALE[0][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = float(171 << (shift_q - 9))
    dq_scale = float(int(DQUANT_SCALE_B[qp % 6]) << (qp // 6))
    return scale, offset, float(1 << shift_q), dq_scale


def level_params(qp, qp_y, qp_u, qp_v, bd, lg):
    """(15,) per-level parameters: 3x quant_params + lam, w_u, w_v."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    return (list(quant_params(qp_y, bd, lg)) +
            list(quant_params(qp_u, bd, lg - 1)) +
            list(quant_params(qp_v, bd, lg - 1)) + [lam, w_u, w_v])


def _tq_cost(cx, orig_blocks, preds, qprm, bd, s):
    tabs = cx.tables()
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
    rank = tabs["scan_rank"][s][None, None, None]
    nz = lev > 0
    nsig = nz.sum(dim=(-1, -2)).to(cx.F)
    last_idx = torch.where(nsig > 0,
                           torch.where(nz, rank, -1.0).amax(dim=(-1, -2)),
                           -1.0)
    lev_bins = torch.clamp(lev, max=32.0).sum(dim=(-1, -2))
    bits = BITS_SCALE * ((last_idx + 1.0) + lev_bins + 2.0 * nsig) + 3.0
    bits = torch.where(nsig == 0, 3.0, bits)
    return dist, bits


def _level_cost(cx, orig_y, orig_u, orig_v, prm, bd, lg):
    """Per-block best intra mode and its cost at level lg."""
    s = 1 << lg
    sc = s >> 1
    oy = _blocks(orig_y, s)
    pY = _pred_all_modes(cx, *_neighbors(orig_y, s, bd), s)
    dY, bY = _tq_cost(cx, oy, pY, prm[0:4], bd, s)
    ou = _blocks(orig_u, sc)
    ov = _blocks(orig_v, sc)
    pU = _pred_all_modes(cx, *_neighbors(orig_u, sc, bd), sc)
    pV = _pred_all_modes(cx, *_neighbors(orig_v, sc, bd), sc)
    dU, bU = _tq_cost(cx, ou, pU, prm[4:8], bd, sc)
    dV, bV = _tq_cost(cx, ov, pV, prm[8:12], bd, sc)
    lam, w_u, w_v = prm[12], prm[13], prm[14]
    nby, nbx = dY.shape[:2]
    cost = (dY + w_u * dU[:nby, :nbx] + w_v * dV[:nby, :nbx] +
            lam * (bY + bU[:nby, :nbx] + bV[:nby, :nbx] + 3.0))
    return torch.argmin(cost, dim=2).to(torch.int32), cost.amin(dim=2)


# ---------------------------------------------------------------------------
# motion search primitives
# ---------------------------------------------------------------------------


def _edge_pad(x, n):
    h, w = x.shape
    rows = torch.arange(-n, h + n, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-n, w + n, device=x.device).clamp(0, w - 1)
    return x[rows][:, cols]


def _cur_blocks(cur, s):
    h, w = cur.shape
    nby, nbx = h // s, w // s
    return cur[:nby * s, :nbx * s].reshape(nby, s, nbx, s).permute(0, 2, 1, 3)


def _mv_for_level(mv16, lg, nby, nbx):
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
    a = torch.abs(mv_q)
    nn = (a + 1) >> 1
    len_i = torch.zeros_like(nn)
    for k in range(16):
        len_i = len_i + (nn >= (1 << k)).to(nn.dtype)
    return (2 * len_i + 1 + (a > 0).to(nn.dtype)).sum(-1)


def _tap_table(q_lo: int, q_hi: int, origin: int):
    n_t = origin - 3 + (q_hi >> 2) + 8
    T = np.zeros((q_hi - q_lo + 1, n_t), np.int32)
    for q in range(q_lo, q_hi + 1):
        d = q >> 2
        f = q & 3
        for j in range(8):
            T[q - q_lo, origin - 3 + d + j] = _MC_L[f, j]
    return T


_T12 = _tap_table(-4, 7, 5)
_T16 = _tap_table(-8, 8, 7)


def _pool4(x):
    h, w = x.shape
    h4, w4 = h // 4, w // 4
    return x[:h4 * 4, :w4 * 4].reshape(h4, 4, w4, 4).sum(dim=(1, 3))


def coarse_me(cur_y, ref_pad, pad: int, nby: int, nbx: int, R4: int = 6):
    hc, wc = nby * 16, nbx * 16
    cur4 = _pool4(cur_y)
    margin4 = R4 + 1
    r0 = pad - 4 * margin4
    ref4 = _pool4(ref_pad[r0:r0 + hc + 8 * margin4,
                          r0:r0 + wc + 8 * margin4])
    H4, W4 = nby * 4, nbx * 4
    n = 2 * R4 + 1
    lo = margin4 - R4
    cands = ref4.unfold(0, H4, 1).unfold(1, W4, 1)[lo:lo + n, lo:lo + n]
    sads = (cur4 - cands).abs().reshape(n, n, nby, 4, nbx, 4) \
        .sum(dim=(3, 5))
    d = torch.arange(-R4, R4 + 1, device=cur4.device).abs()
    sads = sads + (4.0 * (d[:, None] + d[None, :])).to(sads.dtype)[
        :, :, None, None]
    am = torch.argmin(sads.reshape(n * n, nby, nbx), dim=0)
    mv = torch.stack([am % n - R4, am // n - R4], dim=-1) * 4
    return torch.clamp(mv, -MAX_MV_PEL, MAX_MV_PEL).to(torch.int32)


def build_patches(plane_pad, bs: int, k: int, off: int, nby: int, nbx: int,
                  pad: int):
    win = k * bs
    r0 = pad - off
    P = plane_pad[r0:r0 + (nby - 1) * bs + win,
                  r0:r0 + (nbx - 1) * bs + win].to(torch.int16)
    return P.unfold(0, win, bs).unfold(1, win, bs)


def onehot_extract(P, off_r, off_c, oh: int, ow: int):
    nby, nbx = P.shape[:2]
    dev = P.device
    rows = off_r[..., None] + torch.arange(oh, device=dev)
    cols = off_c[..., None] + torch.arange(ow, device=dev)
    bi = torch.arange(nby, device=dev)[:, None, None, None]
    bj = torch.arange(nbx, device=dev)[None, :, None, None]
    return P[bi, bj, rows[..., :, None], cols[..., None, :]].to(torch.int32)


def _hfilt(W, co, shift, lo, n):
    win = W[..., lo - 3:lo + n + 4].unfold(-1, 8, 1)
    return (win * co).sum(-1, dtype=torch.int32) >> shift


def _vfilt(W, co, shift, off, lo, n):
    win = W[..., lo - 3:lo + n + 4, :].unfold(-2, 8, 1)
    return ((win * co).sum(-1, dtype=torch.int32) + off) >> shift


def phase_windows(cx, W32, bd: int, lo: int = 3, n: int = 24):
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    co = cx.const(_MC_L)
    h_full = {0: W32[..., lo:lo + n]}
    h_tmp = {}
    for fx in (1, 2, 3):
        h_full[fx] = torch.clamp(_hfilt(W32, co[fx], 6, lo, n), 0, mx)
        h_tmp[fx] = _wrap(_hfilt(W32, co[fx], shift1, lo, n), 16)
    planes = []
    for fy in range(4):
        for fx in range(4):
            if fy == 0:
                p = h_full[fx][..., lo:lo + n, :]
            elif fx == 0:
                p = torch.clamp(_vfilt(W32, co[fy], 6, 0, lo, n)
                                [..., lo:lo + n], 0, mx)
            else:
                p = torch.clamp(_vfilt(h_tmp[fx], co[fy], shift2, off2, lo,
                                       n), 0, mx)
            planes.append(p.to(torch.int16))
    return torch.stack(planes, dim=-3)


def _cand_table(rng: int, lo: int, origin: int):
    offs = [0] + [q for q in range(-rng, rng + 1) if q != 0]
    qx, qy, pidx, r0, c0 = [], [], [], [], []
    for oy in offs:
        for ox in offs:
            qx.append(ox)
            qy.append(oy)
            pidx.append((oy & 3) * 4 + (ox & 3))
            r0.append(origin + (oy >> 2) - lo)
            c0.append(origin + (ox >> 2) - lo)
    return tuple(np.array(a, np.int32) for a in (qx, qy, pidx, r0, c0))


def _qpel_search(cx, target, vw, rng: int, lo: int, origin: int):
    qx, qy, pidx, r0, c0 = _cand_table(rng, lo, origin)
    dev = vw.device
    nc = 2 * rng + 1
    q_t = cx.const(np.stack([qx, qy], axis=-1))
    idx = cx.const(np.stack([pidx, r0, c0]).astype(np.int64))
    V = vw.unfold(3, 16, 1).unfold(4, 16, 1)
    nby, nbx = target.shape[:2]
    best_cost = torch.full((nby, nbx), 1 << 30, dtype=torch.int32,
                           device=dev)
    best_q = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    tgt = target[:, :, None]
    for k0 in range(0, len(qx), nc):
        sl = slice(k0, k0 + nc)
        pred = V[:, :, idx[0, sl], idx[1, sl], idx[2, sl]]
        cost = (tgt - pred).abs().sum(dim=(-1, -2), dtype=torch.int32)
        mn, am = torch.min(cost, dim=-1)
        upd = mn < best_cost
        best_cost = torch.where(upd, mn, best_cost)
        best_q = torch.where(upd[..., None], q_t[sl][am], best_q)
    return best_cost, best_q


def _mc_params(bd):
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    return shift1, shift2, 1 << (shift2 - 1), (1 << bd) - 1


def mc_h(cx, Wext, q_rel_x, s: int, bd: int, table, q_lo: int):
    nt = table.shape[1]
    tx = cx.const(table)[(q_rel_x - q_lo).long()]
    U = Wext.unfold(-1, s, 1)[..., :nt, :]
    tmp = (tx[..., None, :, None] * U).sum(-2, dtype=torch.int32)
    return _wrap(tmp >> _mc_params(bd)[0], 16)


def mc_v(cx, tmp, q_rel_y, s: int, bd: int, table, q_lo: int):
    _, shift2, off2, mx = _mc_params(bd)
    nt = table.shape[1]
    ty = cx.const(table)[(q_rel_y - q_lo).long()]
    V = tmp.unfold(-2, s, 1)[..., :nt, :, :]
    out = (ty[..., :, None, None] * V).sum(-3, dtype=torch.int32)
    return torch.clamp((out.transpose(-1, -2) + off2) >> shift2, 0, mx)


def eval_qpel(cx, cur16, vw, W32, bd, want_pred=True):
    best_sad, best_q = _qpel_search(cx, cur16, vw, 8, 3, 7)
    if not want_pred:
        return best_q, None, None
    tmp = mc_h(cx, W32, best_q[..., 0], 16, bd, _T16, -8)
    pred = mc_v(cx, tmp, best_q[..., 1], 16, bd, _T16, -8)
    diff = cur16 - pred
    return best_q, diff * diff, pred


# ---------------------------------------------------------------------------
# the fused graph
# ---------------------------------------------------------------------------


def _boxsum(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).sum(dim=(1, 3))


def _assemble(blocks):
    nby, nbx, s, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nby * s, nbx * s)


def _pad_to(x, h, w):
    h0, w0 = x.shape[:2]
    if h != h0 or w != w0:
        rows = torch.arange(h, device=x.device).clamp(max=h0 - 1)
        cols = torch.arange(w, device=x.device).clamp(max=w0 - 1)
        x = x[rows][:, cols]
    return x


def _ref_luma(cx, y_i32, ref_y16, pad, bd, h, w, want_pred=True):
    nby16, nbx16 = h // 16, w // 16
    hc, wc = nby16 * 16, nbx16 * 16
    ry_pad = _edge_pad(ref_y16.to(torch.int32), pad)
    m = coarse_me(y_i32[:hc, :wc].to(cx.F), ry_pad.to(cx.F), pad,
                  nby16, nbx16)
    P16 = build_patches(ry_pad, 16, 5, 32, nby16, nbx16, pad)
    W32 = onehot_extract(P16, m[..., 1] + 25, m[..., 0] + 25, 32, 32)
    vw = phase_windows(cx, W32, bd)
    cur16 = _cur_blocks(y_i32, 16)
    q, sq16, pred16 = eval_qpel(cx, cur16, vw, W32, bd, want_pred)
    mv16c = _pad_to(4 * m + q, _ceil_div(h, 16), _ceil_div(w, 16))
    return mv16c, vw, sq16, pred16, ry_pad, m


def _chroma_pred8(ref_c16, mvc, pad_c, nby, nbx):
    rc_pad = _edge_pad(ref_c16.to(torch.int32), pad_c)
    Pc = build_patches(rc_pad, 8, 5, 16, nby, nbx, pad_c)
    return onehot_extract(Pc, mvc[..., 1] + 16, mvc[..., 0] + 16, 8, 8)


def _research_level(cx, y_i32, ry_pad, mv16c, lg, bd, pad, h, w):
    s = 1 << lg
    nby, nbx = h // s, w // s
    mv_med = torch.clamp(_mv_for_level(mv16c, lg, nby, nbx), -92, 92)
    bv = mv_med >> 2
    phi = mv_med & 3
    k = {5: 3, 6: 2}[lg]
    P = build_patches(ry_pad, s, k, 32, nby, nbx, pad)
    Wext = onehot_extract(P, bv[..., 1] + 27, bv[..., 0] + 27, s + 12, s + 12)
    cur = _cur_blocks(y_i32, s)[:nby, :nbx]
    n = len(RESEARCH_OFFS)
    offs = cx.const(np.array(RESEARCH_OFFS, np.int32))
    tmp = mc_h(cx, Wext, phi[..., 0] + offs[:, None, None], s, bd, _T12, -4)
    d = torch.stack([
        _wrap(((cur - mc_v(cx, tmp, phi[..., 1] + dy, s, bd, _T12, -4))
               ** 2).sum(dim=(-1, -2)), 32)
        for dy in RESEARCH_OFFS]).reshape(n * n, nby, nbx)
    i0 = RESEARCH_OFFS.index(0) * (n + 1)
    best_d, am = torch.min(torch.cat([d[i0:i0 + 1], d]), dim=0)
    i = torch.where(am == 0, i0, am - 1)
    best_off = torch.stack([offs[i % n], offs[i // n]], dim=-1)
    return mv_med + best_off, best_d.to(torch.int32)


def _chroma_ssd_level(cx, u_i32, v_i32, ru_pad, rv_pad, mv_l, lg, pad_c,
                      h, w):
    s = 1 << lg
    sc = s >> 1
    nby, nbx = h // s, w // s
    mvc = (mv_l + 4) >> 3
    k = {5: 3, 6: 2}[lg]
    out = []
    for c_i32, r_pad in ((u_i32, ru_pad), (v_i32, rv_pad)):
        P = build_patches(r_pad, sc, k, 16, nby, nbx, pad_c)
        g = onehot_extract(P, mvc[..., 1] + 16, mvc[..., 0] + 16, sc, sc)
        cb = _cur_blocks(c_i32, sc)[:nby, :nbx]
        out.append(_wrap(((cb - g) ** 2).sum(dim=(-1, -2)), 32).to(cx.F))
    return tuple(out)


def _inter_costs(cx, y_i32, u_i32, v_i32, ref0, mv16c, sq16, ry_pad, prm3,
                 pad, min_log2, max_log2, h, w, bd):
    lam, w_u, w_v = prm3[0], prm3[1], prm3[2]
    nby16, nbx16 = h // 16, w // 16
    pad_c = pad // 2
    mv16f = mv16c[:nby16, :nbx16]
    mvc8 = (mv16f + 4) >> 3
    gu8 = _chroma_pred8(ref0[1], mvc8, pad_c, nby16, nbx16)
    gv8 = _chroma_pred8(ref0[2], mvc8, pad_c, nby16, nbx16)
    cu8 = _cur_blocks(u_i32, 8)[:nby16, :nbx16]
    cv8 = _cur_blocks(v_i32, 8)[:nby16, :nbx16]
    sqY = _pad_to(_assemble(sq16), h, w).to(cx.F)
    sqU = _pad_to(_assemble((cu8 - gu8) ** 2), h // 2, w // 2).to(cx.F)
    sqV = _pad_to(_assemble((cv8 - gv8) ** 2), h // 2, w // 2).to(cx.F)
    ru_pad = _edge_pad(ref0[1].to(torch.int32), pad_c)
    rv_pad = _edge_pad(ref0[2].to(torch.int32), pad_c)
    costs, researched = {}, {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        if nby == 0 or nbx == 0:
            costs[lg] = torch.full((nby, nbx), float("inf"), dtype=cx.F,
                                   device=y_i32.device)
            continue
        if lg <= 4:
            dall = (_boxsum(sqY, s) + w_u * _boxsum(sqU, s >> 1)
                    + w_v * _boxsum(sqV, s >> 1))
            mv_l = _mv_for_level(mv16c, lg, nby, nbx)
        else:
            mv_l, dY = _research_level(cx, y_i32, ry_pad, mv16c, lg, bd,
                                       pad, h, w)
            du, dv = _chroma_ssd_level(cx, u_i32, v_i32, ru_pad, rv_pad,
                                       mv_l, lg, pad_c, h, w)
            dall = dY.to(cx.F) + w_u * du + w_v * dv
            researched[lg] = mv_l
        bits = 8.0 + _mvd_bits(mv_l).to(cx.F)
        costs[lg] = torch.minimum(
            dall + lam * 4.0,
            0.35 * dall + lam * (bits + 0.02 * torch.sqrt(dall) * s))
    return costs, researched


def _partition_dp(leaf_cost, lam, min_log2, max_log2):
    split = {min_log2: torch.zeros_like(leaf_cost[min_log2],
                                        dtype=torch.int16)}
    tree = corrected_leaf(min_log2, leaf_cost[min_log2])
    for lg in range(min_log2 + 1, max_log2 + 1):
        nby, nbx = leaf_cost[lg].shape
        ch = tree[:nby * 2, :nbx * 2]
        sum4 = ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] + ch[1::2, 1::2]
        leafc = corrected_leaf(lg, leaf_cost[lg])
        sp = sum4 + lam < leafc
        split[lg] = sp.to(torch.int16)
        tree = torch.where(sp, sum4 + lam, leafc)
    return split


def _level_maps(mv16c, h, w, min_log2, max_log2, researched=None):
    """Per-level MV maps of a padded 16x16 field, the large-CU levels
    taken from the re-search where given (the program's _parse)."""
    m16 = mv16c.cpu().numpy().astype(np.int32)
    maps = {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        if researched is not None and lg >= 5 and nby and nbx:
            maps[lg] = researched[lg].cpu().numpy().astype(np.int32)
        elif lg <= ME_BLK_LOG2:
            f = 1 << (ME_BLK_LOG2 - lg)
            maps[lg] = np.repeat(np.repeat(m16, f, axis=0), f,
                                 axis=1)[:nby, :nbx]
        else:
            f = 1 << (lg - ME_BLK_LOG2)
            m = m16[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
            m = m.transpose(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
            maps[lg] = np.median(m, axis=2).astype(np.int32)
    return maps


def analyze(cur, refs, qp, qp_y, qp_u, qp_v, *, bd=10, min_log2=2,
            max_log2=6, refine=True, dtype=torch.float64, device="cpu"):
    """Decision maps of one frame.  cur: (y, u, v) int16 arrays at the
    coded size; refs: dict with any of "l0", "l0b", "l1", "l1b" mapped to
    (y, u, v) original frames.  A B analysis (an "l1" that is not "l0")
    refines the bi MVs when `refine`.  Returns {"mode": {lg: map},
    "split": {lg: map}, and for each present plane "mv", "mv0b", "mv1",
    "mv1b", "mvbi": {lg: (nby, nbx, 2) map}}, all numpy."""
    cx = _Ctx(dtype, torch.device(device))

    def to(a):
        return torch.as_tensor(np.asarray(a, np.int16), device=cx.device)

    y16, u16, v16 = (to(a) for a in cur)
    ref = {k: tuple(to(a) for a in v) for k, v in refs.items()
           if v is not None}
    h, w = y16.shape
    pad = PAD
    prms = [torch.as_tensor(level_params(qp, qp_y, qp_u, qp_v, bd, lg),
                            dtype=cx.F, device=cx.device)
            for lg in range(min_log2, max_log2 + 1)]
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    prm3 = torch.as_tensor([lam, 2.0 ** ((qp_y - qp_u) / 3.0),
                            2.0 ** ((qp_y - qp_v) / 3.0)], dtype=cx.F,
                           device=cx.device)
    yf, uf, vf = (a.to(cx.F) for a in (y16, u16, v16))
    y_i32, u_i32, v_i32 = (a.to(torch.int32) for a in (y16, u16, v16))

    mode, leaf = {}, {}
    for i, lg in enumerate(range(min_log2, max_log2 + 1)):
        mode[lg], leaf[lg] = _level_cost(cx, yf, uf, vf, prms[i], bd, lg)

    out = {}
    kind_b = "l1" in ref and "l0" in ref
    r0 = ref.get("l0")
    if r0 is not None:
        mv16c, _vw0, sq16, pred16_0, ry0, _m0 = _ref_luma(
            cx, y_i32, r0[0], pad, bd, h, w)
        icosts, researched = _inter_costs(
            cx, y_i32, u_i32, v_i32, r0, mv16c, sq16, ry0, prm3, pad,
            min_log2, max_log2, h, w, bd)
        for lg in leaf:
            leaf[lg] = torch.minimum(leaf[lg], icosts[lg])
        out["mv"] = _level_maps(mv16c, h, w, min_log2, max_log2, researched)
        if "l0b" in ref:
            out["mv0b"] = _level_maps(_ref_luma(
                cx, y_i32, ref["l0b"][0], pad, bd, h, w, False)[0],
                h, w, min_log2, max_log2)
        if kind_b:
            mv16c_1, vw1, _s, _p, _r, m1 = _ref_luma(
                cx, y_i32, ref["l1"][0], pad, bd, h, w, False)
            out["mv1"] = _level_maps(mv16c_1, h, w, min_log2, max_log2)
            if "l1b" in ref:
                out["mv1b"] = _level_maps(_ref_luma(
                    cx, y_i32, ref["l1b"][0], pad, bd, h, w, False)[0],
                    h, w, min_log2, max_log2)
            if refine:
                tgt = 2 * _cur_blocks(y_i32, 16) - pred16_0
                qbi = _qpel_search(cx, tgt, vw1, 8, 3, 7)[1]
                out["mvbi"] = _level_maps(
                    _pad_to(4 * m1 + qbi, _ceil_div(h, 16),
                            _ceil_div(w, 16)), h, w, min_log2, max_log2)
    split = _partition_dp(leaf, prm3[0], min_log2, max_log2)
    out["mode"] = {lg: m.cpu().numpy().astype(np.int32)
                   for lg, m in mode.items()}
    out["split"] = {lg: s.cpu().numpy().astype(bool)
                    for lg, s in split.items()}
    return out
