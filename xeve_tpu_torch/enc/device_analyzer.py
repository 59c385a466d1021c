"""Fused per-frame device analyzer in PyTorch (port of
enc/device_analyzer.py) with a device-resident original-frame ring.

One dispatch per frame computes, on the analyzer's device, the intra level
costs, quarter-resolution ME + exhaustive quarter-pel refinement against
up to four original reference frames, the large-CU MV re-search, the
per-level inter costs and the partition DP, and packs the decisions into
one int16 vector; collect() makes the one device-to-host copy.  Motion
estimation runs against original frames, so analysis never waits for
reconstruction and can run ahead of the closed-loop C coding pass.

Uploads and dispatches are enqueued from the single dispatcher thread on
its current stream, the device's default stream; collect() enqueues the
readback on the same stream from the thread that calls it (a frame worker
of api.py, or the main thread), so all of them keep their order without
events.  The readback therefore waits for every op enqueued on that
stream before it: its own dispatch's, and those of any later dispatches
that the dispatcher thread enqueued in the meantime.  The dispatch makes
no blocking host copy: constant tables are uploaded once per device
(winmc_torch.const), parameters and frames are copied without a stream
synchronisation.

While xeve_tpu_torch.trace records, _upload, dispatch and collect are
spans (`device_analyzer.upload`, `.dispatch`, `.collect`), and collect's
wait for a dispatch_bg Future and its readback are child spans
(`device_analyzer.queue`, `.readback`; the readback's `behind` counts
the dispatches made after this one before its copy was enqueued).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..ops import mc_np
from .analysis_inter_np import (InterAnalysisResult, ME_BLK_LOG2,
                                analyze_frame_inter)
from .analysis_np import AnalysisResult, analyze_frame, corrected_leaf
from .analysis_torch import _level_cost_impl, level_params
from .analysis_inter_torch import (_cur_blocks, _edge_pad, _mv_for_level,
                                   _mvd_bits, _wrap)
from . import winmc_torch as wm

PAD = 64 + 16   # matches api.py DPB padding (PIC_PAD_SIZE_L)

# large-CU re-search candidate offsets (qpel) around the children median,
# per axis (xeve_pinter.c:906 per-CU refinement analog)
RESEARCH_OFFS = (-4, -2, -1, 0, 1, 2, 4)


def _ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# host twin of the per-level MV derivation from the padded 16x16 MV field
# (copy of device_analyzer._mv_for_level_np :70; the device side is
# analysis_inter_torch._mv_for_level, which has the JAX even-count median)
# ---------------------------------------------------------------------------


def _mv_for_level_np(mv16c, lg, nby, nbx):
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return np.repeat(np.repeat(mv16c, f, axis=0), f, axis=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m = mv16c[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
    m = m.transpose(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
    return np.median(m, axis=2).astype(np.int32)


# ---------------------------------------------------------------------------
# fused device graph
# ---------------------------------------------------------------------------


def _boxsum(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).sum(dim=(1, 3))


def _assemble(blocks):
    """(nby, nbx, s, s) -> (nby*s, nbx*s) plane."""
    nby, nbx, s, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nby * s, nbx * s)


def _pad_to(x, h, w):
    """Edge-pad the first two dims of `x` up to (h, w)."""
    h0, w0 = x.shape[:2]
    if h != h0 or w != w0:
        rows = torch.arange(h, device=x.device).clamp(max=h0 - 1)
        cols = torch.arange(w, device=x.device).clamp(max=w0 - 1)
        x = x[rows][:, cols]
    return x


def _ref_luma(y_i32, ref_y16, pad, bd, h, w, want_pred: bool = True):
    """Coarse quarter-res ME + exhaustive +-8 qpel window refinement for
    one reference.  Returns (mv16c ceil-grid qpel MV field, vw phase
    windows, sq16 squared-diff blocks, pred16 winning predictions, ry_pad
    padded int32 ref, m coarse int MVs); want_pred=False drops sq16 and
    pred16 (MV-only auxiliary reference planes)."""
    nby16, nbx16 = h // 16, w // 16
    hc, wc = nby16 * 16, nbx16 * 16
    ry_pad = _edge_pad(ref_y16.to(torch.int32), pad)
    m = wm.coarse_me(y_i32[:hc, :wc].to(torch.float32),
                     ry_pad.to(torch.float32), pad, nby16, nbx16)
    P16 = wm.build_patches(ry_pad, 16, 5, 32, nby16, nbx16, pad)
    W32 = wm.onehot_extract(P16, m[..., 1] + 25, m[..., 0] + 25, 32, 32)
    vw = wm.phase_windows(W32, bd)
    cur16 = _cur_blocks(y_i32, 16)
    q, _sad, sq16, pred16 = wm.eval_qpel(cur16, vw, want_pred=want_pred,
                                         W32=W32, bd=bd)
    mv16 = 4 * m + q
    mv16c = _pad_to(mv16, _ceil_div(h, 16), _ceil_div(w, 16))
    return mv16c, vw, sq16, pred16, ry_pad, m


def _chroma_pred8(ref_c16, mvc, pad_c, nby, nbx):
    """Nearest-pel 8x8 chroma predictions at per-block integer chroma MVs
    (analysis heuristic; the coding pass recomputes exact chroma MC)."""
    rc_pad = _edge_pad(ref_c16.to(torch.int32), pad_c)
    Pc = wm.build_patches(rc_pad, 8, 5, 16, nby, nbx, pad_c)
    return wm.onehot_extract(Pc, mvc[..., 1] + 16, mvc[..., 0] + 16, 8, 8)


def _research_level(y_i32, ry_pad, mv16c, lg, bd, pad, h, w):
    """Large-CU MV re-search: evaluate RESEARCH_OFFS^2 qpel offsets around
    the children-median MV with per-block-tap MC, per CU.  Returns
    (mv_l researched (nby,nbx,2), dY best luma SSD (nby,nbx) int32).

    The JAX twin scans the zero offset first, then the other 48 in
    dy-major order with strict <.  Here the horizontal MC stage runs once
    for the 7 dx offsets, the vertical stage once per dy row, and one
    first-index argmin over [zero, all 49 in dy-major order] keeps the
    scan's winner (the repeated zero offset can never win).  The SSD sums
    wrap at 32 bits as the JAX int32 sums do (64x64 blocks can exceed
    2^31)."""
    s = 1 << lg
    nby, nbx = h // s, w // s
    mv_med = torch.clamp(_mv_for_level(mv16c, lg, nby, nbx), -92, 92)
    bv = mv_med >> 2
    phi = mv_med & 3
    k = {5: 3, 6: 2}[lg]
    P = wm.build_patches(ry_pad, s, k, 32, nby, nbx, pad)
    Wext = wm.onehot_extract(P, bv[..., 1] + 27, bv[..., 0] + 27,
                             s + 12, s + 12)
    cur = _cur_blocks(y_i32, s)[:nby, :nbx]
    n = len(RESEARCH_OFFS)
    offs = wm.const(np.array(RESEARCH_OFFS, np.int32), y_i32.device)
    tmp = wm.mc_h(Wext, phi[..., 0] + offs[:, None, None], s, bd,
                  wm._T12, -4)                        # (n, nby, nbx, Hw, s)
    d = torch.stack([
        _wrap(((cur - wm.mc_v(tmp, phi[..., 1] + dy, s, bd, wm._T12, -4))
               ** 2).sum(dim=(-1, -2)), 32)
        for dy in RESEARCH_OFFS]).reshape(n * n, nby, nbx)
    i0 = RESEARCH_OFFS.index(0) * (n + 1)           # (0, 0) in dy-major
    best_d, am = torch.min(torch.cat([d[i0:i0 + 1], d]), dim=0)
    i = torch.where(am == 0, i0, am - 1)
    best_off = torch.stack([offs[i % n], offs[i // n]], dim=-1)
    return mv_med + best_off, best_d.to(torch.int32)


def _chroma_ssd_level(u_i32, v_i32, ru_pad, rv_pad, mv_l, lg, pad_c, h, w):
    """Nearest-pel chroma SSD for one large-CU level at the (researched)
    MVs, via per-level chroma patches (int32 sums, wrapped as in JAX)."""
    s = 1 << lg
    sc = s >> 1
    nby, nbx = h // s, w // s
    mvc = (mv_l + 4) >> 3
    k = {5: 3, 6: 2}[lg]
    out = []
    for c_i32, r_pad in ((u_i32, ru_pad), (v_i32, rv_pad)):
        P = wm.build_patches(r_pad, sc, k, 16, nby, nbx, pad_c)
        g = wm.onehot_extract(P, mvc[..., 1] + 16, mvc[..., 0] + 16, sc, sc)
        cb = _cur_blocks(c_i32, sc)[:nby, :nbx]
        out.append(_wrap(((cb - g) ** 2).sum(dim=(-1, -2)), 32)
                   .to(torch.float32))
    return tuple(out)


def _inter_costs_v2(y_i32, u_i32, v_i32, ref0, mv16c, sq16, ry_pad, prm3,
                    pad, min_log2, max_log2, h, w, bd):
    """Per-level inter cost maps built from diff-plane box sums (levels
    <= 4, children MVs == their 16x16 parent) and per-CU re-searched MVs
    (levels 5/6).  Returns (costs dict, researched dict lg ->
    (nby,nbx,2))."""
    lam, w_u, w_v = prm3[0], prm3[1], prm3[2]
    nby16, nbx16 = h // 16, w // 16
    pad_c = pad // 2
    mv16f = mv16c[:nby16, :nbx16]
    mvc8 = (mv16f + 4) >> 3
    gu8 = _chroma_pred8(ref0[1], mvc8, pad_c, nby16, nbx16)
    gv8 = _chroma_pred8(ref0[2], mvc8, pad_c, nby16, nbx16)
    cu8 = _cur_blocks(u_i32, 8)[:nby16, :nbx16]
    cv8 = _cur_blocks(v_i32, 8)[:nby16, :nbx16]
    sqY = _pad_to(_assemble(sq16), h, w).to(torch.float32)
    sqU = _pad_to(_assemble((cu8 - gu8) ** 2), h // 2, w // 2) \
        .to(torch.float32)
    sqV = _pad_to(_assemble((cv8 - gv8) ** 2), h // 2, w // 2) \
        .to(torch.float32)

    ru_pad = _edge_pad(ref0[1].to(torch.int32), pad_c)
    rv_pad = _edge_pad(ref0[2].to(torch.int32), pad_c)

    costs, researched = {}, {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        if nby == 0 or nbx == 0:
            costs[lg] = torch.full((nby, nbx), float("inf"),
                                   device=y_i32.device)
            continue
        if lg <= 4:
            dall = (_boxsum(sqY, s) + w_u * _boxsum(sqU, s >> 1)
                    + w_v * _boxsum(sqV, s >> 1))
            mv_l = _mv_for_level(mv16c, lg, nby, nbx)
        else:
            mv_l, dY = _research_level(y_i32, ry_pad, mv16c, lg, bd=bd,
                                       pad=pad, h=h, w=w)
            du, dv = _chroma_ssd_level(u_i32, v_i32, ru_pad, rv_pad, mv_l,
                                       lg, pad_c, h, w)
            dall = dY.to(torch.float32) + w_u * du + w_v * dv
            researched[lg] = mv_l
        bits = 8.0 + _mvd_bits(mv_l).to(torch.float32)
        costs[lg] = torch.minimum(
            dall + lam * 4.0,
            0.35 * dall + lam * (bits + 0.02 * torch.sqrt(dall) * s))
    return costs, researched


def _partition_dp_dev(leaf_cost, lam, min_log2, max_log2):
    """Bottom-up split DP on the device in f32.  Each level's maps are
    (h // s, w // s), so every block lies inside the frame and the JAX
    twin's `valid` mask (:257) is all true; it is left out."""
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


def _fused_impl(y16, u16, v16, ref0, ref0b, ref1, ref1b, prms, prm3, *,
                bd, R, pad, min_log2, max_log2, refine):
    """refs: (y16,u16,v16) originals or None — ref0/ref0b are L0 refi 0/1,
    ref1/ref1b are L1 refi 0/1.  prms: (n_levels, 15) f32 per-level quant
    params; prm3: (3,) f32 lam/w_u/w_v.  Returns one packed int16 vector:
    mode/split per level, then the 16x16 qpel MV planes for each present
    ref in order [L0r0, L0r1, L1r0, L1r1, bi-refined L1], with the
    re-searched large-CU MV maps (levels 5/6) for the L0r0 plane right
    after its 16x16 field, then the two int16 halves of the RC
    complexity.  R is kept in the signature for dispatch compatibility."""
    del R
    h, w = y16.shape
    yf = y16.to(torch.float32)
    uf = u16.to(torch.float32)
    vf = v16.to(torch.float32)
    y_i32 = y16.to(torch.int32)
    u_i32 = u16.to(torch.int32)
    v_i32 = v16.to(torch.int32)
    lam = prm3[0]

    mode, leaf = {}, {}
    for i, lg in enumerate(range(min_log2, max_log2 + 1)):
        mode[lg], leaf[lg] = _level_cost_impl(yf, uf, vf, prms[i], bd, lg)

    mv16c = mv16c_0b = mv16c_1 = mv16c_1b = mv16c_bi = None
    researched = {}
    pred16_0 = vw1 = m1 = None
    if ref0 is not None:
        mv16c, _vw0, sq16, pred16_0, ry0, _m0 = _ref_luma(
            y_i32, ref0[0], pad, bd, h, w)
        icosts, researched = _inter_costs_v2(
            y_i32, u_i32, v_i32, ref0, mv16c, sq16, ry0, prm3, pad,
            min_log2, max_log2, h, w, bd)
        for lg in leaf:
            leaf[lg] = torch.minimum(leaf[lg], icosts[lg])
    if ref0b is not None:
        mv16c_0b = _ref_luma(y_i32, ref0b[0], pad, bd, h, w,
                             want_pred=False)[0]
    if ref1 is not None:
        mv16c_1, vw1, _sq1, _p1, _ry1, m1 = _ref_luma(
            y_i32, ref1[0], pad, bd, h, w, want_pred=False)
    if ref1b is not None:
        mv16c_1b = _ref_luma(y_i32, ref1b[0], pad, bd, h, w,
                             want_pred=False)[0]
    if refine and ref0 is not None and ref1 is not None:
        # joint bi refinement (analyze_bi analog): re-search L1 around its
        # coarse center against the L0-compensated residual target
        tgt = 2 * _cur_blocks(y_i32, 16) - pred16_0
        qbi = wm.eval_qpel_target(tgt, vw1)
        mv16c_bi = _pad_to(4 * m1 + qbi, _ceil_div(h, 16), _ceil_div(w, 16))

    split = _partition_dp_dev(leaf, lam, min_log2, max_log2)

    parts = []
    for lg in range(min_log2, max_log2 + 1):
        parts.append(mode[lg].to(torch.int16).reshape(-1))
        parts.append(split[lg].reshape(-1))
    for i, m in enumerate((mv16c, mv16c_0b, mv16c_1, mv16c_1b, mv16c_bi)):
        if m is not None:
            parts.append(m.to(torch.int16).reshape(-1))
        if i == 0:
            for lg in sorted(researched):
                parts.append(researched[lg].to(torch.int16).reshape(-1))
    # RC complexity: total best-mode cost at the 16x16 level, packed as
    # two int16 halves of a >>16-scaled int32 (f32 sum: another summation
    # order than XLA's can move it by a few units)
    rci = torch.clamp(leaf[4].sum() / 65536.0, 0, 2.0 ** 30).to(torch.int32)
    parts.append(_wrap(torch.stack([rci >> 15, rci & 0x7fff]), 16)
                 .to(torch.int16))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# host side: frame ring, dispatch, readback, recovery
# ---------------------------------------------------------------------------


class _DeviceVec:
    """A dispatch's packed vector on its device.  np.asarray() copies it to
    the host (a CUDA tensor's own __array__ raises) on the calling thread's
    current stream, the device's default stream that the dispatch was
    enqueued on, and blocks that thread until the copy is done: after every
    op enqueued on the stream before it, its own dispatch's and those of
    any later dispatch enqueued first."""
    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        a = self.t.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class _Handle:
    """kind: 'I' | 'P' | 'B' (legacy) — or pass `planes`, a 5-tuple of
    bools (L0r0, L0r1, L1r0, L1r1, bi-refined) saying which MV planes the
    packed vector carries.  `args` keeps the dispatch arguments for
    failure recovery (re-dispatch / host fallback).  Copy of
    device_analyzer._Handle (:355)."""
    __slots__ = ("vec", "kind", "h", "w", "min_log2", "max_log2", "planes",
                 "args", "seq")

    def __init__(self, vec, kind, h, w, min_log2, max_log2, planes=None,
                 args=None, seq=None):
        self.vec = vec
        self.seq = seq      # the analyzer's `dispatches` after this one
        self.kind = kind
        self.h, self.w = h, w
        self.min_log2, self.max_log2 = min_log2, max_log2
        if planes is None:
            planes = {"I": (False,) * 5,
                      "P": (True, False, False, False, False),
                      "B": (True, False, True, False, False)}[kind]
        self.planes = planes
        self.args = args


class DeviceAnalyzer:
    """Original-frame ring + fused per-frame analysis dispatch on `device`.

    dispatch() returns a handle once the dispatch is enqueued (on a CUDA
    device the card computes in the background); collect() blocks on the
    single packed copy and materializes the decision maps.  `dispatches`
    counts the fused dispatches made, `failures` the recovered device
    failures.  integer_me_fn: the integer ME of the host fallback's numpy
    inter analysis (analysis_inter_np.analyze_frame_inter; default its
    numpy full search)."""

    def __init__(self, w: int, h: int, bd: int = 10, search_range: int = 16,
                 min_log2: int = 2, max_log2: int = 6, ring_size: int = 24,
                 *, device="cuda", integer_me_fn=None):
        if bd not in (8, 10):
            raise ValueError("device analyzer supports 8/10-bit internal")
        self.device = resolve_device(device)
        self.w, self.h, self.bd = w, h, bd
        self.R = int(search_range)
        self.min_log2, self.max_log2 = min_log2, max_log2
        self.ring: dict[int, tuple] = {}
        self.host_ring: dict[int, tuple] = {}
        self.ring_size = ring_size
        self.failures = 0          # recovered device failures (telemetry)
        self.dispatches = 0
        self.integer_me_fn = integer_me_fn
        self._count_lock = threading.Lock()   # prewarm dispatches in threads
        self._pool = None          # lazy single-thread dispatcher

    def _submit(self, fn, *args, **kw):
        """Run device work on the single dispatcher thread, off the thread
        driving the native coding pass."""
        if self._pool is None:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="xt-dispatch")
        return self._pool.submit(fn, *args, **kw)

    def _to_device(self, a):
        # a fresh device copy (never a view of the caller's host array); a
        # host-to-device copy from pageable memory is staged at once, so
        # it needs no stream synchronisation
        return torch.as_tensor(a).to(self.device, non_blocking=True,
                                     copy=True)

    # -- frame ring ------------------------------------------------------
    def put_frame(self, poc: int, y, u, v, replace: bool = False):
        """Upload one original frame (async, via the dispatcher thread).
        Arrays must be the aligned coded size.  A host-side copy is kept
        for failure recovery.  Re-puts of a POC already resident are
        no-ops; replace=True overwrites a resident POC (closed-loop LD
        swaps originals for reconstructions)."""
        if poc in self.host_ring and not replace:
            return
        hy = np.asarray(y, np.int16)
        hu = np.asarray(u, np.int16)
        hv = np.asarray(v, np.int16)
        self.host_ring[poc] = (hy, hu, hv)
        if len(self.host_ring) > self.ring_size:
            for k in sorted(self.host_ring)[:len(self.host_ring)
                                            - self.ring_size]:
                del self.host_ring[k]
        self._submit(self._upload, poc, hy, hu, hv)

    def _upload(self, poc, hy, hu, hv):
        with trace.span("device_analyzer.upload", poc=poc):
            self.ring[poc] = (self._to_device(hy), self._to_device(hu),
                              self._to_device(hv))
            if len(self.ring) > self.ring_size:
                for k in sorted(self.ring)[:len(self.ring) - self.ring_size]:
                    del self.ring[k]

    def has_frame(self, poc: int) -> bool:
        return poc in self.host_ring

    def ring_get(self, poc: int):
        """Device tensors for a resident POC.  When called off the
        dispatcher thread before its queued upload ran, uploads
        synchronously (same content; the late queued upload overwrites
        with an identical copy)."""
        t = self.ring.get(poc)
        if t is None:
            t = tuple(self._to_device(a) for a in self.host_ring[poc])
            self.ring[poc] = t
        return t

    # -- analysis --------------------------------------------------------
    def params(self, qp: int, qp_y: int, qp_u: int, qp_v: int):
        """The fused graph's parameters on the device: prms (n_levels, 15)
        per-level quant parameters and prm3 (lam, w_u, w_v)."""
        prms = self._to_device(np.stack(
            [level_params(qp, qp_y, qp_u, qp_v, self.bd, lg)
             for lg in range(self.min_log2, self.max_log2 + 1)]))
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
        w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
        return prms, self._to_device(np.array([lam, w_u, w_v], np.float32))

    def dispatch(self, poc: int, qp: int, qp_y: int, qp_u: int, qp_v: int,
                 ref_poc: int | None = None,
                 ref1_poc: int | None = None,
                 ref0b_poc: int | None = None,
                 ref1b_poc: int | None = None,
                 bi_refine: bool = True) -> _Handle:
        with trace.span("device_analyzer.dispatch", poc=poc) as sp:
            y, u, v = self.ring_get(poc)
            kind = "I" if ref_poc is None else (
                "B" if (ref1_poc is not None and ref1_poc != ref_poc) else "P")
            prms, prm3 = self.params(qp, qp_y, qp_u, qp_v)
            ref0 = self.ring_get(ref_poc) if kind in ("P", "B") else None
            ref1 = self.ring_get(ref1_poc) if kind == "B" else None
            ref0b = (self.ring_get(ref0b_poc)
                     if (kind != "I" and ref0b_poc is not None
                         and ref0b_poc in self.host_ring) else None)
            ref1b = (self.ring_get(ref1b_poc)
                     if (kind == "B" and ref1b_poc is not None
                         and ref1b_poc in self.host_ring) else None)
            refine = bool(bi_refine and kind == "B")
            vec = _fused_impl(y, u, v, ref0, ref0b, ref1, ref1b, prms, prm3,
                              bd=self.bd, R=self.R, pad=PAD,
                              min_log2=self.min_log2, max_log2=self.max_log2,
                              refine=refine)
            with self._count_lock:
                self.dispatches += 1
                seq = self.dispatches
            planes = (ref0 is not None, ref0b is not None, ref1 is not None,
                      ref1b is not None, refine)
            sp.set(kind=kind, seq=seq)
        return _Handle(_DeviceVec(vec), kind, self.h, self.w, self.min_log2,
                       self.max_log2, planes=planes,
                       args=(poc, qp, qp_y, qp_u, qp_v, ref_poc, ref1_poc,
                             ref0b_poc, ref1b_poc, bi_refine), seq=seq)

    # -- failure recovery ------------------------------------------------
    def _redispatch(self, hd: _Handle) -> _Handle:
        """Re-upload the involved originals from the host ring and re-run
        the dispatch."""
        poc, _, _, _, _, r0, r1, r0b, r1b, _ = hd.args
        for q in (poc, r0, r1, r0b, r1b):
            if q is not None and q in self.host_ring:
                self.ring[q] = tuple(self._to_device(a)
                                     for a in self.host_ring[q])
        return self.dispatch(*hd.args)

    def _host_fallback(self, hd: _Handle):
        """Device unrecoverable: compute this frame's analysis with the
        numpy oracle from the host-side original ring."""
        poc, qp, qp_y, qp_u, qp_v, r0, r1, r0b, r1b, _ = hd.args
        y, u, v = [np.asarray(p, np.int32) for p in self.host_ring[poc]]
        if r0 is None:
            return analyze_frame(y, u, v, qp, qp_y, qp_u, qp_v, self.bd,
                                 min_log2=self.min_log2)

        def ref(q):
            ry, ru, rv = self.host_ring[q]
            return {"poc": q,
                    "y_pad": mc_np.pad_picture(np.asarray(ry, np.int32),
                                               PAD),
                    "u_pad": mc_np.pad_picture(np.asarray(ru, np.int32),
                                               PAD // 2),
                    "v_pad": mc_np.pad_picture(np.asarray(rv, np.int32),
                                               PAD // 2)}
        refp = [ref(r0)] + ([ref(r0b)] if r0b is not None else [])
        refp1 = None
        if r1 is not None and r1 != r0:
            refp1 = [ref(r1)] + ([ref(r1b)] if r1b is not None else [])
        return analyze_frame_inter(y, u, v, refp, qp, qp_y, qp_u, qp_v,
                                   self.bd, search_range=self.R,
                                   refp1=refp1, min_log2=self.min_log2,
                                   integer_me_fn=self.integer_me_fn)

    def dispatch_bg(self, *args, **kw):
        """dispatch() on the dispatcher thread; returns a Future[_Handle]
        that collect() accepts."""
        return self._submit(self.dispatch, *args, **kw)

    def collect(self, hd):
        """Block on the packed copy; build the decision maps the coding
        pass consumes.  Accepts a _Handle or a dispatch_bg Future.  On a
        device failure: one re-dispatch, then the numpy-oracle fallback
        (the JAX twin's recovery contract, :545)."""
        with trace.span("device_analyzer.collect") as sp:
            if hasattr(hd, "result"):
                with trace.span("device_analyzer.queue") as q:
                    hd = hd.result()
                    q.set(poc=hd.args[0] if hd.args else None)
            poc = hd.args[0] if hd.args else None
            sp.set(poc=poc)
            behind = None if hd.seq is None else self.dispatches - hd.seq
            try:
                with trace.span("device_analyzer.readback", poc=poc,
                                behind=behind):
                    vec = np.asarray(hd.vec)
            except Exception:
                self.failures += 1
                if hd.args is None:
                    raise
                try:
                    hd = self._redispatch(hd)
                    vec = np.asarray(hd.vec)
                except Exception:
                    return self._host_fallback(hd)
            return self._parse(hd, vec)

    def _parse(self, hd: _Handle, vec):
        """Packed vector -> decision maps.  Copy of
        device_analyzer.DeviceAnalyzer._parse (:566)."""
        h, w = hd.h, hd.w
        mode, split = {}, {}
        off = 0
        for lg in range(hd.min_log2, hd.max_log2 + 1):
            s = 1 << lg
            nby, nbx = h // s, w // s
            n = nby * nbx
            mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
            off += n
            split[lg] = vec[off:off + n].reshape(nby, nbx).astype(bool)
            off += n
        if hd.kind == "I":
            rc = None
            if off + 2 <= len(vec):
                rc = float((int(vec[off]) << 15) | int(vec[off + 1])) * 65536.0
            return AnalysisResult(mode=mode, split=split, leaf_cost=None,
                                  tree_cost=None, rc_cost=rc)
        nby16c, nbx16c = _ceil_div(h, 16), _ceil_div(w, 16)
        n16 = nby16c * nbx16c * 2

        def next_plane():
            nonlocal off
            m16 = vec[off:off + n16].reshape(nby16c, nbx16c,
                                             2).astype(np.int32)
            off += n16
            maps = {}
            for lg in range(hd.min_log2, hd.max_log2 + 1):
                s = 1 << lg
                maps[lg] = _mv_for_level_np(m16, lg, h // s, w // s)
            return maps

        def read_researched(maps):
            """Override the large-CU levels of the L0r0 maps with the
            device-re-searched per-CU MVs (packed right after its 16x16
            field)."""
            nonlocal off
            for lg in range(max(5, hd.min_log2), hd.max_log2 + 1):
                s = 1 << lg
                nby, nbx = h // s, w // s
                if nby == 0 or nbx == 0:
                    continue
                n = nby * nbx * 2
                maps[lg] = vec[off:off + n].reshape(nby, nbx,
                                                    2).astype(np.int32)
                off += n
            return maps

        has0, has0b, has1, has1b, hasbi = hd.planes
        mv = read_researched(next_plane()) if has0 else None
        mv0b = next_plane() if has0b else None
        mv1 = next_plane() if has1 else None
        mv1b = next_plane() if has1b else None
        mvbi = next_plane() if hasbi else None

        def rc_cost():
            if off + 2 > len(vec):     # older packed vecs (meshed twin)
                return None
            hi, lo = int(vec[off]), int(vec[off + 1])
            return float((hi << 15) | lo) * 65536.0

        if hd.kind == "B" and mv1 is None:
            mv1 = {lg: mv[lg] for lg in mv}
        return InterAnalysisResult(mode=mode, split=split, leaf_cost=None,
                                   tree_cost=None, mv=mv, mv1=mv1,
                                   mv0b=mv0b, mv1b=mv1b, mvbi=mvbi,
                                   rc_cost=rc_cost())
