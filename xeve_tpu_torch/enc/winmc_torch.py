"""Motion analysis primitives of the device analyzer in PyTorch (port of
enc/winmc_jax.py).

  coarse_me        full search on the 4x4-pooled planes (+-6 pooled pels),
                   all 169 candidates in one pass
  build_patches    overlapping per-block patches as strided views
  onehot_extract   per-block windows at per-block integer offsets (a
                   gather: the JAX twin's one-hot matmuls are an exact
                   gather for in-range offsets, and every caller keeps its
                   offsets in range by clamping its MVs)
  phase_windows    the 16 quarter-pel phase planes of each block window
                   (integer-exact xeve_mc.c:39 semantics)
  eval_qpel        exhaustive SAD over the +-8 qpel candidate grid, one
                   candidate row (17 candidates) per step
  perblock_mc      separable MC with per-block tap rows (12- or 17-entry
                   tables of {int offset, phase})

Every stage that produces MVs is integer-exact and bit-identical to the
JAX twin: sums of integers below 2^24 in f32, explicit int16 wraps of
the separable intermediate, and ties resolved to the first candidate in
the JAX scan order (zero offset first, then strict < in table order).
The JAX scans are not ported step by step: candidates are evaluated in
chunks, the first minimum is taken inside a chunk and strict < across
chunks, which keeps the scan's order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tables import _MC_L as MC_L
from .analysis_inter_torch import _wrap

# Per-block {phase, int-offset} filter tables: row q - q_lo applies the
# 8-tap phase filter MC_L[q&3] at integer offset (q>>2) for qpel remainder
# q; out[r] = sum_t T[q][t] * W[r + t] with the output block origin at
# W row `origin` and taps placed at t = (origin - 3) + (q>>2) + j.
# Copy of winmc_jax._tap_table (:57).
def _tap_table(q_lo: int, q_hi: int, origin: int):
    n_t = origin - 3 + (q_hi >> 2) + 8
    T = np.zeros((q_hi - q_lo + 1, n_t), np.int32)
    for q in range(q_lo, q_hi + 1):
        d = q >> 2
        f = q & 3
        for j in range(8):
            T[q - q_lo, origin - 3 + d + j] = MC_L[f, j]
    return T


# q in [-4, 7], window origin 5 (large-CU re-search on (s+12)-windows)
_T12 = _tap_table(-4, 7, 5)
# q in [-8, 8], window origin 7 (winner-prediction rebuild on 32-windows)
_T16 = _tap_table(-8, 8, 7)

MAX_MV_PEL = 23          # integer-pel MV clamp (patch margin 32 = 23+2+7)

_CONST: dict = {}


def const(arr, device) -> torch.Tensor:
    """A constant numpy table as a tensor on `device`, uploaded once per
    content and device (a dispatch then makes no blocking host copy)."""
    arr = np.ascontiguousarray(arr)
    key = (torch.device(device), arr.dtype.str, arr.shape, arr.tobytes())
    t = _CONST.get(key)
    if t is None:
        t = _CONST[key] = torch.as_tensor(arr, device=device)
    return t


# ---------------------------------------------------------------------------
# coarse motion search (quarter resolution, full search)
# ---------------------------------------------------------------------------


def _pool4(x):
    h, w = x.shape
    h4, w4 = h // 4, w // 4
    return x[:h4 * 4, :w4 * 4].reshape(h4, 4, w4, 4).sum(dim=(1, 3))


def coarse_me(cur_y_f32, ref_pad_f32, pad: int, nby: int, nbx: int,
              R4: int = 6):
    """Full-search ME at quarter resolution on the 4x4-pooled planes.
    cur (hc, wc) f32 with hc = nby*16; ref_pad edge-padded by `pad`.
    Returns (nby, nbx, 2) int32 full-res integer MVs (multiples of 4 pels,
    clamped to +-MAX_MV_PEL).  The JAX scan walks dy rows in order with
    strict < and takes the first dx of a row: that is the first minimum
    in (dy, dx) raster order, which one argmin over all candidates
    gives.  The f32 sums hold integers below 2^24, so they are exact."""
    hc, wc = nby * 16, nbx * 16
    cur4 = _pool4(cur_y_f32)                       # (nby*4, nbx*4)
    margin4 = R4 + 1
    r0 = pad - 4 * margin4
    if r0 < 0:
        raise ValueError(f"pad {pad} is too small for R4={R4}")
    ref4 = _pool4(ref_pad_f32[r0:r0 + hc + 8 * margin4,
                              r0:r0 + wc + 8 * margin4])
    H4, W4 = nby * 4, nbx * 4
    n = 2 * R4 + 1
    lo = margin4 - R4
    # cands[a, b] = ref4[lo + a:, lo + b:] cropped to (H4, W4): a view
    cands = ref4.unfold(0, H4, 1).unfold(1, W4, 1)[lo:lo + n, lo:lo + n]
    sads = (cur4 - cands).abs().reshape(n, n, nby, 4, nbx, 4) \
        .sum(dim=(3, 5))
    d = torch.arange(-R4, R4 + 1, device=cur4.device).abs()
    sads = sads + (4.0 * (d[:, None] + d[None, :])).to(sads.dtype)[
        :, :, None, None]
    am = torch.argmin(sads.reshape(n * n, nby, nbx), dim=0)
    mv = torch.stack([am % n - R4, am // n - R4], dim=-1) * 4
    return torch.clamp(mv, -MAX_MV_PEL, MAX_MV_PEL).to(torch.int32)


# ---------------------------------------------------------------------------
# patches + extraction
# ---------------------------------------------------------------------------


def build_patches(plane_pad, bs: int, k: int, off: int, nby: int, nbx: int,
                  pad: int):
    """(nby, nbx, k*bs, k*bs) int16 patches: patch[i,j,a,b] =
    plane_pad[pad + bs*i + a - off, pad + bs*j + b - off], as a strided
    view.  Requires off <= pad and (k*bs - off) <= pad + bs (the JAX
    twin's dynamic_slice would clamp instead; here that raises)."""
    win = k * bs
    r0 = pad - off
    if r0 < 0 or win - off > pad + bs:
        raise ValueError(f"patches bs={bs} k={k} off={off} exceed pad {pad}")
    P = plane_pad[r0:r0 + (nby - 1) * bs + win,
                  r0:r0 + (nbx - 1) * bs + win].to(torch.int16)
    P = P.unfold(0, win, bs).unfold(1, win, bs)
    if P.shape[:2] != (nby, nbx):
        raise ValueError(f"plane {tuple(plane_pad.shape)} holds no "
                         f"{nby}x{nbx} patches of {win} at pad {pad}")
    return P


def onehot_extract(P, off_r, off_c, oh: int, ow: int):
    """Extract (oh, ow) windows at per-block integer offsets (off_r, off_c)
    into the patch.  P: (nby, nbx, win, win) int16; offsets (nby, nbx) in
    [0, win - oh/ow].  Returns int32 (the JAX twin returns the same
    integers in f32, which its callers cast to int32).

    The JAX one-hot form yields 0 for an offset outside the patch; this
    gather would wrap a negative offset and fault on a large one.  Every
    caller clamps its MVs so that its offsets stay in range (_ref_luma
    [2, 48] of 80-32, _research_level [4, 50] of 96-44 and 128-76,
    chroma [4, 29] of 40-8 and [4, 28] of 48-16 and 64-32), and
    tests/test_torch_device_analyzer.py drives every caller at its
    extreme MVs."""
    nby, nbx = P.shape[:2]
    dev = P.device
    rows = off_r[..., None] + torch.arange(oh, device=dev)
    cols = off_c[..., None] + torch.arange(ow, device=dev)
    bi = torch.arange(nby, device=dev)[:, None, None, None]
    bj = torch.arange(nbx, device=dev)[None, :, None, None]
    return P[bi, bj, rows[..., :, None], cols[..., None, :]].to(torch.int32)


# ---------------------------------------------------------------------------
# local quarter-pel phase windows (exact xeve_mc.c integer semantics)
# ---------------------------------------------------------------------------


def _hfilt(W, co, shift, lo, n):
    """8-tap filter along the last axis at output cols [lo, lo+n); taps at
    input offsets c-3..c+4.  W int32 (..., h, w); co (8,) int32."""
    win = W[..., lo - 3:lo + n + 4].unfold(-1, 8, 1)       # (..., h, n, 8)
    return (win * co).sum(-1, dtype=torch.int32) >> shift


def _vfilt(W, co, shift, off, lo, n):
    win = W[..., lo - 3:lo + n + 4, :].unfold(-2, 8, 1)    # (..., n, w, 8)
    return ((win * co).sum(-1, dtype=torch.int32) + off) >> shift


def phase_windows(W32, bd: int, lo: int = 3, n: int = 24):
    """All 16 qpel phase planes of each (32, 32) block window, over window
    coords [lo, lo+n) x [lo, lo+n).  W32: (..., 32, 32) int32.  Returns
    (..., 16, n, n) int16, plane index fy*4+fx."""
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    co = const(MC_L, W32.device)
    # horizontal stage (all rows: the vertical stage needs them)
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


# ---------------------------------------------------------------------------
# exhaustive qpel candidate evaluation
# ---------------------------------------------------------------------------


def _cand_table(rng: int, lo: int, origin: int):
    """(n_cand,) int32 arrays (qx, qy, pidx, r0, c0) for the qpel candidate
    grid, zero offset first so SAD ties favor it; rows of 2*rng+1
    candidates share one qy.  Copy of winmc_jax._cand_table (:250)."""
    offs = [0] + [q for q in range(-rng, rng + 1) if q != 0]
    qx, qy, pidx, r0, c0 = [], [], [], [], []
    for oy in offs:
        for ox in offs:
            qx.append(ox)
            qy.append(oy)
            pidx.append((oy & 3) * 4 + (ox & 3))
            r0.append(origin + (oy >> 2) - lo)
            c0.append(origin + (ox >> 2) - lo)
    mk = lambda a: np.array(a, np.int32)
    return mk(qx), mk(qy), mk(pidx), mk(r0), mk(c0)


def _qpel_search(target, vw, rng: int, lo: int, origin: int):
    """Best (cost, q) of sum|target - pred| over the candidate table,
    one table row (2*rng+1 candidates) per step.  Costs cannot wrap int32
    (256 * 2047 < 2^31 for 10-bit targets), so no wrap is needed."""
    qx, qy, pidx, r0, c0 = _cand_table(rng, lo, origin)
    dev = vw.device
    nc = 2 * rng + 1
    q_t = const(np.stack([qx, qy], axis=-1), dev)              # (n, 2)
    idx = const(np.stack([pidx, r0, c0]).astype(np.int64), dev)
    # V[..., p, r, c, a, b] = vw[..., p, r + a, c + b]: every candidate
    # 16x16 prediction as a view
    V = vw.unfold(3, 16, 1).unfold(4, 16, 1)
    nby, nbx = target.shape[:2]
    best_cost = torch.full((nby, nbx), 1 << 30, dtype=torch.int32,
                           device=dev)
    best_q = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
    tgt = target[:, :, None]
    for k0 in range(0, len(qx), nc):
        sl = slice(k0, k0 + nc)
        pred = V[:, :, idx[0, sl], idx[1, sl], idx[2, sl]]  # (.., nc, 16, 16)
        cost = (tgt - pred).abs().sum(dim=(-1, -2), dtype=torch.int32)
        mn, am = torch.min(cost, dim=-1)       # first minimum in the row
        upd = mn < best_cost                   # strict: earlier rows win
        best_cost = torch.where(upd, mn, best_cost)
        best_q = torch.where(upd[..., None], q_t[sl][am], best_q)
    return best_cost, best_q


def eval_qpel(cur16, vw, rng: int = 8, lo: int = 3, origin: int = 7,
              want_pred: bool = True, W32=None, bd: int = 10):
    """Exhaustive SAD over the (2*rng+1)^2 qpel offsets in [-rng, rng]^2
    for every block.  cur16: (nby, nbx, 16, 16) int32; vw: (nby, nbx, 16,
    n, n) int16 phase windows with window coord `origin` = block start,
    planes offset by `lo`.  Returns (best_q (nby,nbx,2), best_sad,
    best_sq, best_pred); the winner's prediction is rebuilt by one
    per-block-tap MC over the extraction windows W32 (None, None with
    want_pred=False)."""
    best_sad, best_q = _qpel_search(cur16, vw, rng, lo, origin)
    if not want_pred:
        return best_q, best_sad, None, None
    pred = perblock_mc(W32, best_q[..., 0], best_q[..., 1], 16, bd,
                       table=_T16, q_lo=-8)
    diff = cur16 - pred
    return best_q, best_sad, diff * diff, pred


def eval_qpel_target(target, vw, rng: int = 8, lo: int = 3, origin: int = 7):
    """eval_qpel against an arbitrary int32 target (bi refinement: target =
    2*cur - pred0, analyze_bi analog xeve_pinter.c:1567).  Returns best_q
    only."""
    return _qpel_search(target, vw, rng, lo, origin)[1]


# ---------------------------------------------------------------------------
# per-block-tap MC (large-CU re-search around the children median)
# ---------------------------------------------------------------------------


def _mc_params(bd):
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    return shift1, shift2, 1 << (shift2 - 1), (1 << bd) - 1


def mc_h(Wext, q_rel_x, s: int, bd: int, table, q_lo: int):
    """Horizontal stage of perblock_mc over all rows, then the int16
    truncation.  Wext (nby, nbx, Hw, Ww) int32; q_rel_x (..., nby, nbx)
    (leading dims batch candidates).  Returns (..., nby, nbx, Hw, s)."""
    nt = table.shape[1]
    tx = const(table, Wext.device)[(q_rel_x - q_lo).long()]  # (..., nt)
    U = Wext.unfold(-1, s, 1)[..., :nt, :]                  # (.., Hw, nt, s)
    tmp = (tx[..., None, :, None] * U).sum(-2, dtype=torch.int32)
    return _wrap(tmp >> _mc_params(bd)[0], 16)


def mc_v(tmp, q_rel_y, s: int, bd: int, table, q_lo: int):
    """Vertical stage of perblock_mc on mc_h's output.  q_rel_y (nby, nbx)
    or batched like tmp.  Returns (..., nby, nbx, s, s) int32."""
    _, shift2, off2, mx = _mc_params(bd)
    nt = table.shape[1]
    ty = const(table, tmp.device)[(q_rel_y - q_lo).long()]  # (..., nt)
    V = tmp.unfold(-2, s, 1)[..., :nt, :, :]          # (.., nt, s_c, s_r)
    out = (ty[..., :, None, None] * V).sum(-3, dtype=torch.int32)
    return torch.clamp((out.transpose(-1, -2) + off2) >> shift2, 0, mx)


def perblock_mc(Wext, q_rel_x, q_rel_y, s: int, bd: int,
                table=None, q_lo: int = -4):
    """Separable MC with per-block qpel remainders q_rel (int offset q>>2
    + phase q&3), each block's tap row selected from the extended tap
    table (default _T12: q in [-4, 7] on (s+12)-windows with the output
    block origin at row/col 5; pass table=_T16, q_lo=-8 for q in [-8, 8]
    on 32-windows with origin 7).  The JAX twin selects rows with a
    one-hot int32 product; indexing selects the same rows.  Returns
    (nby, nbx, s, s) int32."""
    if table is None:
        table = _T12
    tmp = mc_h(Wext, q_rel_x, s, bd, table, q_lo)
    return mc_v(tmp, q_rel_y, s, bd, table, q_lo)
