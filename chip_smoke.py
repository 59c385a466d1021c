#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xeve_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. card: name and power limit (nvidia-smi); fails without CUDA;
  2. build: compile the ME kernel (csrc/me_full_search.cu) with nvcc and
     the port's copy of the host C coding pass (native/xt_core.c) with
     gcc, both into build/xeve_tpu_torch/, so the encode phases time
     encoding;
  3. kernel: full-search ME at 1920x1088 10-bit, R=16, against its plain
     PyTorch version (random pair, shifted pair): MVs and costs identical;
     its time beside its bound at the SM clock read just after it;
  4. analysis: intra and inter analysis at 1920x1088 on the card against
     the same calls on the CPU (MV maps identical; modes and splits agree
     on >= 0.99 of the blocks of each level);
  5. LD-P encode, 3 frames at 1920x1088, QP 32, preset medium (2 ME
     kernel launches);
  6. RA GOP16 encode, 17 frames at 1920x1088 (31 launches);
  7. round trip: LD-P and RA streams at 128x64 coded on the card decode
     bit-exactly through the Python conformance decoder;
then the fused device analyzer (analysis="device", bench.py's engine),
which runs no hand-written kernel:
  8. fused analysis at 1920x1088 on the card against the same call on the
     CPU for the I, P, P+ref0b, B (with and without bi refinement) and
     B+ref0b+ref1b signatures: MV sections identical, modes and splits
     agree on >= 0.99 of the blocks of each level, RC tail to 1e-5;
  9. dispatch+collect times of one I, P and B frame, and torch.profiler's
     device busy time and device operation count of one B dispatch;
 10-12. device-engine encodes at 1920x1088, QP 32, preset medium: AI (4
     frames, frame-parallel C pass), LD-P (8 frames, dispatch ahead 3)
     and RA GOP16 (17 frames, pipelined sub-GOP, frame-parallel C pass);
     each asserts one dispatch per frame and no device failure;
 13. round trip: device-engine LD-P and RA streams at 128x64 coded on the
     card decode bit-exactly;
then the Main profile (EIPD, CM_INIT, ADCC, IQT, ATS, HTDF, ADDB; BTT
where it is auto-on), at 1920x1088, QP 32, preset medium:
 14. 33-mode EIPD analysis on the card against the same call on the CPU
     (modes and splits agree on >= 0.99 of the blocks of each level);
 15. Main I dispatch+collect (median of 5, host clock), the dispatch's
     enqueue time with CUDA's sync debug mode set to error (the dispatch
     makes no synchronisation), CUDA-event ms per level, and
     torch.profiler's device busy time, operation count and hottest ops
     of one Main I analysis;
 16. Main AI, 2 frames, "jax" engine through encode_stream (bench.py's
     1080p_ai_main), analysis and C-pass time beside the wall;
 17. Main RA GOP16, 17 frames, "jax" engine (bench.py's 1080p_ra_main):
     the B frames launch the ME kernel, 31 times;
 18. round trip: Main AI, LD-P and RA streams ("jax" engine) and a
     device-engine Main RA stream at 128x64 coded on the card decode
     bit-exactly.
then this slice's public surface: rate control, DRA, checkpoint/resume,
the CLIs and the numpy coder:
 19. device-engine RA GOP16 under ABR at 1920x1088, 33 frames (bench.py's
     engine; the port's main path), at a target of twice phase 12's CQ-32
     rate: fps, kbps against the target, the qp range, the peak VBV
     fullness over its size (<= 1), one dispatch per frame, no failure;
 20. "jax"-engine RA GOP16 under CRF 32, 17 frames: 31 ME launches, fps,
     kbps, PSNR-Y;
 21. device-engine LD-P under ABR, 12 frames of a 1080p pan whose luma
     inverts (1023 - y) from frame 6: the lookahead marks frame 6 a
     keyframe (`_force_idr`) and codes it as an I slice;
 22. Main AI with DRA on the device engine, 1 frame through encode_stream:
     PSNR-Y of the backward-mapped recon against the original > 30 dB;
 23. the CLI (`python -m xeve_tpu_torch.app --analysis auto -b 15 --rc
     abr`) in a subprocess on a 17-frame 1080p clip written into build/:
     it must choose the device engine; its summary;
 24. round trip at 128x64 on the card, each stream decoding bit-exactly:
     ABR LD-P and RA (device engine), CRF RA ("jax"), DRA Main AI and
     LD-P (device engine), a resumed "jax"-engine LD-P equal to the
     unbroken encode, coder="numpy" LD-P equal to the native pass, and the
     CLI's recon equal to dec_app's output.
then the last device graphs and switches, at 1920x1088, QP 32, preset
medium:
 25. BatchAnalyzer on the card, a batch of 4: modes and splits equal the
     card's single-frame analysis, agree with the CPU's on >= 0.99 of the
     blocks of each level; one batch against 4 single-frame calls
     (synchronised host clock);
 26. Encoder(analysis="jax").encode_frames, 8 AI frames in batches of 4:
     fps, kbps, PSNR-Y, the C pass's share of the wall; the same frames
     through the encode_frame loop in the same call (equal bytes);
 27. me_engine="pallas" on the numpy engine: numpy integer_me's host time
     against the kernel route's on one 1080p pair (MV fields identical),
     then an LD-P encode of 2 frames (1 ME launch): the numpy host
     analysis takes minutes per 1080p frame, so the encode is cut from 3
     frames and its I frame takes the card's intra decisions;
 28. encode_stream_meshed, 17 frames, on make_mesh() and on the mesh
     [cuda:0, cuda:0] (15 B frames padded to 16): each stream byte-equal
     to phase 12's; fps;
 29. round trip at 128x64 on the card: encode_frames on the "jax" and
     numpy engines, the numpy engine with me_engine "pallas" and None
     (equal streams), encode_stream_meshed, graft_entry.entry() against
     the CPU's, and graft_entry.dryrun_multichip(2).
The ME kernel's launch count is set to 0 before each of phases 5, 6, 16,
17, 19, 20 and 27 and read after it (2, 31, 0, 31, 0, 31 and 1 launches;
the device engine and Main AI do not launch it); the record sums phases
5, 6, 17, 20 and 27.
Every phase runs on the port's own modules: neither jax nor the JAX
package xeve_tpu is imported.
The last three lines are the run's wall time, the kernel record and
{"ok": true, "device": ...}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, QP = 1920, 1088, 32
PAD = 80
AGREE_MIN = 0.99


def _frames(w, h, n, start=0):
    import numpy as np
    from gen_test_content import gen_frame
    out = []
    for t in range(start, n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _cuda_ms(fn, n):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _psnr_y(a, b):
    import numpy as np
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(1023.0 ** 2 / mse)


def phase_kernel(me_cuda, integer_me_plain):
    import numpy as np
    import torch
    from xeve_tpu_torch.ops import me_bench
    from xeve_tpu_torch.ops import mc_np
    rng = np.random.default_rng(2024)
    ref_rand = rng.integers(0, 1024, (H, W)).astype(np.int32)
    cur_rand = rng.integers(0, 1024, (H, W)).astype(np.int32)
    ref_real = (_frames(W, H, 1)[0][0]).astype(np.int32)
    cur_shift = np.clip(np.roll(ref_real, (-7, 11), axis=(0, 1))
                        + rng.integers(-3, 4, (H, W)), 0, 1023) \
        .astype(np.int32)
    err = 0
    for name, cur, ref in (("random", cur_rand, ref_rand),
                           ("shifted", cur_shift, ref_real)):
        c = torch.as_tensor(cur, device="cuda")
        r = torch.as_tensor(mc_np.pad_picture(ref, PAD), device="cuda")
        mv, cost = me_cuda.integer_me(c, r, PAD, 16)
        torch.cuda.synchronize()
        mv0, cost0 = integer_me_plain(c, r, 16, PAD)
        err = max(err, int((mv - mv0).abs().max()),
                  int((cost - cost0).abs().max()))
        assert torch.equal(mv, mv0) and torch.equal(cost, cost0), \
            f"{name} pair: kernel and plain ME disagree"
    # cur(y, x) = ref(y + 7, x - 11): away from the wrapped edges the
    # search must find (dx, dy) = (-11, 7)
    inner = mv[2:-2, 2:-2].reshape(-1, 2)
    share = float((inner == torch.tensor([-11, 7], device="cuda"))
                  .all(-1).float().mean())
    assert share > 0.9, f"shifted pair: true MV found on {share:.3f}"
    # timed on the shifted pair, the last one staged; the SM clock is read
    # right after the kernel's timing
    ms = _cuda_ms(lambda: me_cuda.integer_me(c, r, PAD, 16), 20)
    clk, clk_max = me_bench.sm_clocks()
    load_clk, watts, _n = me_bench.sm_clock_under_load(
        lambda: me_cuda.integer_me(c, r, PAD, 16), ms)
    plain_ms = _cuda_ms(lambda: integer_me_plain(c, r, 16, PAD), 3)
    nby, nbx = H // 16, W // 16
    bound, bound_max, bound_load = (me_bench.bound_ms(nby, nbx, 16, f)
                                    for f in (clk, clk_max, load_clk))
    # bytes bound: cur and the padded ref read once, mv and cost written
    bytes_ms = (H * W + (H + 2 * PAD) * (W + 2 * PAD) + 3 * nby * nbx) \
        * 4 / 3.35e12 * 1e3
    assert bytes_ms < bound_max
    print(f"phase 3 kernel: {W}x{H} R=16 random+shifted pairs identical; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); "
          f"SM clock {clk:.0f} MHz (max {clk_max:.0f}): bound {bound:.4f} ms "
          f"at that clock, {bound_max:.4f} ms at the max (INT32 "
          f"abs-diff-adds; bytes alone {bytes_ms:.4f} ms), "
          f"{bound_max / ms:.3f} of the bound; back to back for 1 s: SM "
          f"clock {load_clk:.0f} MHz, {watts:.1f} W, bound {bound_load:.4f} "
          f"ms at that clock", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_max, "bound_by": "operations",
            "library_ms": None, "sm_clock_mhz": clk}


def phase_analysis():
    import numpy as np
    import torch
    from xeve_tpu_torch.constants import chroma_qp_dynamic
    from xeve_tpu_torch.ops import mc_np
    from xeve_tpu_torch.enc.analysis_torch import analyze_frame_torch
    from xeve_tpu_torch.enc.analysis_inter_torch import \
        analyze_frame_inter_torch
    f0, f1, f2 = _frames(W, H, 3)
    y, u, v = (np.asarray(p, np.int32) for p in f1)

    def dpb_entry(f, poc):
        y_, u_, v_ = (np.asarray(p, np.int32) for p in f)
        return {"poc": poc, "y_pad": mc_np.pad_picture(y_, PAD),
                "u_pad": mc_np.pad_picture(u_, PAD // 2),
                "v_pad": mc_np.pad_picture(v_, PAD // 2)}

    ref, ref1 = dpb_entry(f0, 0), dpb_entry(f2, 2)
    qp_y, qp_c = QP + 12, chroma_qp_dynamic(QP) + 12
    args = (QP, qp_y, qp_c, qp_c, 10)

    def intra(dev):
        return analyze_frame_torch(y, u, v, *args, device=dev)

    def inter_p(dev):
        return analyze_frame_inter_torch(y, u, v, [ref], *args,
                                         search_range=16, device=dev)

    def inter_b(dev):
        # L1 from the next frame: a second ME pass and MV map
        return analyze_frame_inter_torch(y, u, v, [ref], *args,
                                         search_range=16, refp1=[ref1],
                                         device=dev)

    phases = (("intra", intra), ("P", inter_p), ("B", inter_b))
    worst = 1.0
    for name, fn in phases:
        a_gpu, a_cpu = fn("cuda"), fn("cpu")
        for lg in a_cpu.mode:
            m = float((a_gpu.mode[lg] == a_cpu.mode[lg]).mean())
            s = float((a_gpu.split[lg] == a_cpu.split[lg]).mean())
            worst = min(worst, m, s)
            assert m >= AGREE_MIN and s >= AGREE_MIN, \
                f"{name} level {lg}: mode {m:.5f} split {s:.5f}"
            if name != "intra":
                assert np.array_equal(a_gpu.mv[lg], a_cpu.mv[lg]), \
                    f"{name} level {lg}: L0 MV maps differ"
            if name == "B":
                assert np.array_equal(a_gpu.mv1[lg], a_cpu.mv1[lg]), \
                    f"B level {lg}: L1 MV maps differ"
    times = {}
    for name, fn in phases:
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn("cuda")
            ts.append((time.perf_counter() - t0) * 1e3)
        times[name] = sorted(ts)[2]
    print(f"phase 4 analysis: card vs CPU at {W}x{H}: MV maps identical, "
          f"lowest mode/split agreement {worst:.5f} (>= {AGREE_MIN}); "
          f"per frame on the card: intra {times['intra']:.1f} ms, "
          f"P {times['P']:.1f} ms, B {times['B']:.1f} ms (median of 5, "
          f"host clock)",
          flush=True)


def _assert_decodes(label, out, n, profile=0):
    """The stream of `out` ((bs, rec, poc) per frame) decodes to its n
    reconstructions bit-exactly through the port's decoder."""
    import numpy as np
    from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
    recs = {poc: rec for _bs, rec, poc in out}
    dec = BaselineIntraDecoder()
    frames = dec.decode(b"".join(b for b, _r, _p in out))
    assert len(frames) == n, f"{label}: decoded {len(frames)} frames"
    assert dec.sps.profile_idc == profile, f"{label}: profile"
    for f in frames:
        for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
            assert np.array_equal(a, b), f"{label} poc {f.poc} differs"


def phase_round_trip(phase, cases, EncoderParams):
    """Streams at 128x64 coded on the card decode bit-exactly; cases are
    (label, encoder class, parameters, frames, analysis engine)."""
    for label, cls, kw, fr, engine in cases:
        enc = cls(EncoderParams(w=128, h=64, qp=QP, **kw), analysis=engine,
                  device="cuda")
        out = list(enc.encode_stream(iter(fr)))
        if engine == "device":
            assert enc._device().failures == 0, f"{label}: device failures"
        _assert_decodes(label, out, len(fr), kw.get("profile", 0))
    print(f"phase {phase} round trip: "
          + ", ".join(f"{c[0]} ({len(c[3])})" for c in cases)
          + " at 128x64 decode bit-exactly", flush=True)


def _sections(vec, h, w):
    """(modes/splits per level, MV sections, RC value) of a packed
    device-analyzer vector (min_log2 2, max_log2 6)."""
    levels, off = {}, 0
    for lg in range(2, 7):
        n = (h >> lg) * (w >> lg)
        levels[lg] = (vec[off:off + n], vec[off + n:off + 2 * n])
        off += 2 * n
    rc = float((int(vec[-2]) << 15) | int(vec[-1])) * 65536.0
    return levels, vec[off:-2], rc


def phase_fused(dan):
    """Card against CPU, the whole fused graph per dispatch signature."""
    import numpy as np
    import torch
    from xeve_tpu_torch.constants import chroma_qp_dynamic
    from xeve_tpu_torch.enc.analysis_torch import level_params
    fr = _frames(W, H, 5)
    qp_y, qp_c = QP + 12, chroma_qp_dynamic(QP) + 12
    prms = np.stack([level_params(QP, qp_y, qp_c, qp_c, 10, lg)
                     for lg in range(2, 7)])
    prm3 = np.array([0.57 * 2.0 ** ((QP - 12) / 3.0),
                     2.0 ** ((qp_y - qp_c) / 3.0),
                     2.0 ** ((qp_y - qp_c) / 3.0)], np.float32)
    sigs = {"I": ((), False), "P": ((0,), False),
            "P+ref0b": ((0, 3), False), "B": ((0, None, 2), True),
            "B-norefine": ((0, None, 2), False),
            "B+ref0b+ref1b": ((0, 3, 2, 4), True)}
    worst, worst_rc = 1.0, 0.0
    t0 = time.perf_counter()
    for name, (refs, refine) in sigs.items():
        out = {}
        for dev in ("cuda", "cpu"):
            def to(a):
                return torch.as_tensor(a, device=dev)
            r = [None if i is None else tuple(map(to, fr[i])) for i in refs]
            r += [None] * (4 - len(r))
            vec = dan._fused_impl(*map(to, fr[1]), *r, to(prms), to(prm3),
                                  bd=10, R=16, pad=dan.PAD, min_log2=2,
                                  max_log2=6, refine=refine)
            out[dev] = _sections(vec.cpu().numpy(), H, W)
        (lv_g, mv_g, rc_g), (lv_c, mv_c, rc_c) = out["cuda"], out["cpu"]
        assert np.array_equal(mv_g, mv_c), f"{name}: MV sections differ"
        for lg in lv_c:
            m = float((lv_g[lg][0] == lv_c[lg][0]).mean())
            s = float((lv_g[lg][1] == lv_c[lg][1]).mean())
            worst = min(worst, m, s)
            assert m >= AGREE_MIN and s >= AGREE_MIN, \
                f"{name} level {lg}: mode {m:.5f} split {s:.5f}"
        rel = abs(rc_g - rc_c) / max(abs(rc_c), 1.0)
        worst_rc = max(worst_rc, rel)
        assert rel <= 1e-5, f"{name}: RC tail {rc_g} vs {rc_c}"
    print(f"phase 8 fused analysis: card vs CPU at {W}x{H}, signatures "
          f"{', '.join(sigs)}: MV sections identical, lowest mode/split "
          f"agreement {worst:.5f} (>= {AGREE_MIN}), RC tail rel diff "
          f"{worst_rc:.3g} (<= 1e-5), {time.perf_counter() - t0:.1f} s",
          flush=True)


def _device_profile(fn):
    """One synchronised call of fn under torch.profiler: its wall, the
    union of its device intervals (busy), their count, and the hottest
    kernels and aten ops, as one line of text.  Fails if the trace holds
    no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert evs, "no device time in the profiled call"
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, None
    for a, b in spans:                      # union of device intervals, us
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    ops = sorted(((e.key, e.self_device_time_total)
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])[:4]
    return (f"wall {wall:.1f} ms, device busy {busy / 1e3:.2f} ms over "
            f"{len(evs)} device operations (idle share "
            f"{1.0 - busy / 1e3 / wall:.3f}); hottest kernels: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top)
            + "; hottest ops (self device time): "
            + "; ".join(f"{n} {t / 1e3:.2f} ms" for n, t in ops))


def phase_dispatch(dan):
    """Dispatch+collect per frame kind, and one profiled B dispatch."""
    import torch
    from xeve_tpu_torch.constants import chroma_qp_dynamic
    dev = dan.DeviceAnalyzer(W, H, 10, search_range=16, device="cuda")
    for t, f in enumerate(_frames(W, H, 3)):
        dev.put_frame(t, *f)
    qps = (QP, QP + 12, chroma_qp_dynamic(QP) + 12,
           chroma_qp_dynamic(QP) + 12)
    kinds = {"I": {}, "P": dict(ref_poc=0),
             "B": dict(ref_poc=0, ref1_poc=2)}
    times = {}
    for name, kw in kinds.items():
        dev.collect(dev.dispatch(1, *qps, **kw))          # warm
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.collect(dev.dispatch(1, *qps, **kw))
            ts.append((time.perf_counter() - t0) * 1e3)
        times[name] = sorted(ts)[2]
    prof = _device_profile(
        lambda: dev.collect(dev.dispatch(1, *qps, **kinds["B"])))
    assert dev.failures == 0, "device failure in the profiled B dispatch"
    print(f"phase 9 dispatch: dispatch+collect at {W}x{H} on the card: I "
          f"{times['I']:.1f} ms, P {times['P']:.1f} ms, B {times['B']:.1f} "
          f"ms (median of 5, host clock, synchronised); one profiled B: "
          + prof
          + "; stages of one B (CUDA events, launch gaps included): "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in _b_stages(dan, qps)),
          flush=True)


def _b_stages(dan, qps):
    """CUDA-event ms of each stage of one B dispatch at 1920x1088, every
    stage run alone on its inputs; largest first."""
    import numpy as np
    import torch
    from xeve_tpu_torch.enc import winmc_torch as wm
    from xeve_tpu_torch.enc.analysis_inter_torch import _cur_blocks
    from xeve_tpu_torch.enc.analysis_torch import _level_cost_impl, \
        level_params

    def to(a):
        return torch.as_tensor(a, device="cuda")

    f0, f1, f2 = _frames(W, H, 3)
    y16, u16, v16 = map(to, f1)
    ref0, ref1 = tuple(map(to, f0)), tuple(map(to, f2))
    y, u, v = y16.int(), u16.int(), v16.int()
    yf, uf, vf = y16.float(), u16.float(), v16.float()
    prms = to(np.stack([level_params(*qps, 10, lg) for lg in range(2, 7)]))
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    w_c = 2.0 ** ((qps[1] - qps[2]) / 3.0)
    prm3 = to(np.array([lam, w_c, w_c], np.float32))
    nby, nbx = H // 16, W // 16
    mv16c, _vw, sq16, pred16, ry, m = dan._ref_luma(y, ref0[0], PAD, 10, H,
                                                    W)
    vw1 = dan._ref_luma(y, ref1[0], PAD, 10, H, W, want_pred=False)[1]
    P16 = wm.build_patches(ry, 16, 5, 32, nby, nbx, PAD)
    W32 = wm.onehot_extract(P16, m[..., 1] + 25, m[..., 0] + 25, 32, 32)
    vw = wm.phase_windows(W32, 10)
    cur16 = _cur_blocks(y, 16)
    q = wm._qpel_search(cur16, vw, 8, 3, 7)[1]
    leaf = {lg: _level_cost_impl(yf, uf, vf, prms[i], 10, lg)[1]
            for i, lg in enumerate(range(2, 7))}
    stages = {
        "intra levels 2-6": lambda: [
            _level_cost_impl(yf, uf, vf, prms[i], 10, lg)
            for i, lg in enumerate(range(2, 7))],
        "ref0 _ref_luma": lambda: dan._ref_luma(y, ref0[0], PAD, 10, H, W),
        "ref1 _ref_luma (no pred)": lambda: dan._ref_luma(
            y, ref1[0], PAD, 10, H, W, want_pred=False),
        "coarse_me": lambda: wm.coarse_me(y.float(), ry.float(), PAD, nby,
                                          nbx),
        "patches+gather 32x32": lambda: wm.onehot_extract(
            wm.build_patches(ry, 16, 5, 32, nby, nbx, PAD),
            m[..., 1] + 25, m[..., 0] + 25, 32, 32),
        "phase_windows": lambda: wm.phase_windows(W32, 10),
        "qpel search (289 cand, chunks of 17)": lambda: wm._qpel_search(
            cur16, vw, 8, 3, 7),
        "winner MC": lambda: wm.perblock_mc(W32, q[..., 0], q[..., 1], 16,
                                            10, table=wm._T16, q_lo=-8),
        "_inter_costs_v2 (lg 2-6)": lambda: dan._inter_costs_v2(
            y, u, v, ref0, mv16c, sq16, ry, prm3, PAD, 2, 6, H, W, 10),
        "re-search lg 5": lambda: dan._research_level(y, ry, mv16c, 5, 10,
                                                      PAD, H, W),
        "re-search lg 6": lambda: dan._research_level(y, ry, mv16c, 6, 10,
                                                      PAD, H, W),
        "bi target search": lambda: wm.eval_qpel_target(
            2 * cur16 - pred16, vw1),
        "partition DP": lambda: dan._partition_dp_dev(leaf, prm3[0], 2, 6),
    }
    out = [(n,_cuda_ms(fn, 3)) for n, fn in stages.items()]
    return sorted(out, key=lambda kv: -kv[1])


def _c_pass_share(spans, t0, t1):
    """(union of the C-pass intervals, their sum) over the wall t1 - t0."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / (t1 - t0), sum(b - a for a, b in spans) / (t1 - t0)


def phase_device_encode(label, cls, params, frames, **kw):
    """A device-engine encode; returns its kbps at 30 fps and its
    stream."""
    import numpy as np
    enc = cls(params, analysis="device", device="cuda")
    # time every P/B-slice C pass (frame-parallel ones run on worker
    # threads; the AI frame-parallel pass does not go through _code_slice)
    with _Spans(enc, "_code_slice") as cs:
        t0 = time.perf_counter()
        out = list(enc.encode_stream(iter(frames), **kw))
        t1 = time.perf_counter()
    spans = cs.spans
    dt = t1 - t0
    dev = enc._device()
    n = len(out)
    assert n == len(frames), f"{label}: {n} outputs for {len(frames)} frames"
    assert dev.dispatches == n, f"{label}: {dev.dispatches} dispatches"
    assert dev.failures == 0, f"{label}: {dev.failures} device failures"
    nbytes = sum(len(bs) for bs, _rec, _poc in out)
    ps = [_psnr_y(frames[poc][0], rec[0]) for _bs, rec, poc in out]
    assert all(np.isfinite(p) and p > 30.0 for p in ps), f"{label}: {ps}"
    print(f"{label}: {n} frames {params.w}x{params.h} in {dt:.3f} s = "
          f"{n / dt:.4f} fps, {nbytes * 8 * 30.0 / n / 1000.0:.1f} kbps at "
          f"30 fps, PSNR-Y {float(np.mean(ps)):.3f} dB, dispatches "
          f"{dev.dispatches}, failures 0, XEVE_TPU_FRAME_WORKERS "
          f"{enc._frame_workers()}, C pass built in phase 2"
          + ("; P/B C passes: {:.3f} of the wall busy, mean concurrency "
             "{:.3f}".format(*_c_pass_share(spans, t0, t1)) if spans
             else ""), flush=True)
    return nbytes * 8 * 30.0 / n / 1000.0, [bs for bs, _rec, _poc in out]


def _main_qps():
    from xeve_tpu_torch.constants import chroma_qp_dynamic
    qc = chroma_qp_dynamic(QP, 1) + 12          # Main: IQT chroma table
    return QP, QP + 12, qc, qc


def phase_main_analysis(amt):
    """Card against CPU, the 33-mode EIPD analysis of one 1080p frame."""
    import numpy as np
    y, u, v = (np.asarray(p, np.int32) for p in _frames(W, H, 2)[1])
    t0 = time.perf_counter()
    a_gpu = amt.analyze_frame_main_torch(y, u, v, *_main_qps(), 10,
                                         device="cuda")
    t1 = time.perf_counter()
    a_cpu = amt.analyze_frame_main_torch(y, u, v, *_main_qps(), 10,
                                         device="cpu")
    t2 = time.perf_counter()
    worst = []
    for lg in range(2, 7):
        m = float((a_gpu.mode[lg] == a_cpu.mode[lg]).mean())
        s = float((a_gpu.split[lg] == a_cpu.split[lg]).mean())
        worst.append(f"lg{lg} {min(m, s):.5f}")
        assert m >= AGREE_MIN and s >= AGREE_MIN, \
            f"Main level {lg}: mode {m:.5f} split {s:.5f}"
    assert a_gpu.eipd_modes and max(int(a_gpu.mode[lg].max())
                                    for lg in range(2, 7)) > 4
    print(f"phase 14 Main analysis: card vs CPU at {W}x{H}, lowest "
          f"mode/split agreement per level {', '.join(worst)} (>= "
          f"{AGREE_MIN}); first call on the card {t1 - t0:.2f} s "
          f"(weights built and uploaded), CPU {t2 - t1:.2f} s", flush=True)


def phase_main_dispatch(amt):
    """Main I dispatch+collect times, the dispatch's enqueue under CUDA's
    sync debug mode, per-level CUDA-event times, one profiled analysis."""
    import numpy as np
    import torch
    y, u, v = (np.asarray(p, np.int32) for p in _frames(W, H, 2)[1])
    qps = _main_qps()

    def one():
        return amt.collect_main_torch(
            amt.dispatch_main_torch(y, u, v, *qps, 10, device="cuda"))

    one()                                                 # warm
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        ts.append((time.perf_counter() - t0) * 1e3)
    # the dispatch only enqueues: a synchronising call in it raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        hd = amt.dispatch_main_torch(y, u, v, *qps, 10, device="cuda")
        enq = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    amt.collect_main_torch(hd)
    wait = (time.perf_counter() - t0) * 1e3
    yt, ut, vt = (torch.as_tensor(p, dtype=torch.float32, device="cuda")
                  for p in (y, u, v))
    levels = []
    for lg in range(2, 7):
        prm = torch.as_tensor(amt.level_params_main(*qps, 10, lg),
                              device="cuda")
        levels.append((lg, _cuda_ms(
            lambda: amt._level_cost_main(yt, ut, vt, prm, 10, lg), 3)))
    prof = _device_profile(one)
    print(f"phase 15 Main dispatch: Main I dispatch+collect at {W}x{H}: "
          f"{sorted(ts)[2]:.1f} ms (median of 5, host clock, synchronised);"
          f" dispatch enqueue {enq:.1f} ms with sync debug mode error, then "
          f"collect {wait:.1f} ms; per level (CUDA events): "
          + ", ".join(f"lg{lg} {ms:.2f} ms" for lg, ms in levels)
          + "; one profiled Main I: " + prof, flush=True)


class _Spans:
    """Host-clock intervals of every call of obj.name while in use."""

    def __init__(self, obj, name):
        self.obj, self.name, self.spans = obj, name, []

    def __enter__(self):
        fn = self.real = getattr(self.obj, self.name)

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((t, time.perf_counter()))

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)

    def total(self):
        return sum(b - a for a, b in self.spans)


def phase_encode(label, cls, params, frames, me_cuda, launches):
    """An encode on the "jax" engine: fps, rate and PSNR-Y, analyses and
    ME kernel launches (the count is set to 0 first; the launches are
    returned), and where the wall went (analysis, or the dispatch and
    collect of a dispatched one, and the C pass, host clock)."""
    import numpy as np
    from xeve_tpu_torch import api
    enc = cls(params, device="cuda")
    me_cuda.LAUNCHES = 0
    with _Spans(api, "dispatch_main_torch") as s_dis, \
            _Spans(api, "collect_main_torch") as s_col, \
            _Spans(api, "encode_intra_frame_native") as s_ci, \
            _Spans(enc, "_analyze_intra") as s_ai, \
            _Spans(enc, "_analyze_inter") as s_ap, \
            _Spans(enc, "_code_slice") as s_cs:
        t0 = time.perf_counter()
        out = list(enc.encode_stream(iter(frames)))
        dt = time.perf_counter() - t0
    n_launch = me_cuda.LAUNCHES
    n = len(out)
    assert n == len(frames), f"{label}: {n} outputs for {len(frames)} frames"
    assert enc.analysis_calls == n, \
        f"{label}: {enc.analysis_calls} analyses for {n} frames"
    assert n_launch == launches, \
        f"{label}: {n_launch} ME kernel launches, expected {launches}"
    nbytes = sum(len(bs) for bs, _rec, _poc in out)
    ps = [_psnr_y(frames[poc][0], rec[0]) for _bs, rec, poc in out]
    assert all(np.isfinite(p) and p > 30.0 for p in ps), f"{label}: {ps}"
    ana = sum(t.total() for t in (s_dis, s_col, s_ai, s_ap))
    cpass = s_ci.total() + s_cs.total()
    print(f"{label}: {n} frames {params.w}x{params.h} in {dt:.3f} s = "
          f"{n / dt:.4f} fps, {nbytes * 8 * 30.0 / n / 1000.0:.1f} kbps at "
          f"30 fps, PSNR-Y {float(np.mean(ps)):.3f} dB, analyses "
          f"{enc.analysis_calls}, ME kernel launches {n_launch}, btt "
          f"{enc.p.btt}; host clock: analysis {ana:.3f} s, "
          f"C pass {cpass:.3f} s of the {dt:.3f} s wall", flush=True)
    return n_launch


def _rc_stream(enc, frames):
    """encode_stream under RC: the outputs, the wall, and per coded frame
    the slice type, the qp and the VBV fullness after it."""
    out, stats = [], []
    t0 = time.perf_counter()
    for o in enc.encode_stream(iter(frames)):
        out.append(o)
        stats.append((enc.last_stat.slice_type, enc.last_stat.qp,
                      enc.rc.vbv_fullness))
    return out, stats, time.perf_counter() - t0


def _rate_line(frames, out, dt):
    """fps, kbps at 30 fps and mean PSNR-Y of an encode, checked finite."""
    import numpy as np
    n = len(out)
    assert n == len(frames), f"{n} outputs for {len(frames)} frames"
    ps = [_psnr_y(frames[poc][0], rec[0]) for _bs, rec, poc in out]
    assert all(np.isfinite(p) and p > 30.0 for p in ps), ps
    kbps = sum(len(bs) for bs, _r, _p in out) * 8 * 30.0 / n / 1000.0
    return n / dt, kbps, float(np.mean(ps))


def phase_abr_ra(GopEncoder, EncoderParams, frames, target):
    """Device-engine RA GOP16 under ABR (the port's main path): one
    dispatch per frame, no device failure, the VBV never overflowing."""
    enc = GopEncoder(EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15,
                                   preset="medium", rc_type="abr",
                                   bitrate_kbps=target),
                     analysis="device", device="cuda")
    out, stats, dt = _rc_stream(enc, frames)
    fps, kbps, psnr = _rate_line(frames, out, dt)
    dev = enc._device()
    assert dev.dispatches == len(frames), f"{dev.dispatches} dispatches"
    assert dev.failures == 0, f"{dev.failures} device failures"
    qps = [q for _st, q, _v in stats]
    peak = max(v for _st, _q, v in stats) / enc.rc.vbv_size
    assert peak <= 1.0, f"VBV overflow: peak fullness {peak:.3f} of its size"
    print(f"phase 19 ABR RA: {len(out)} frames {W}x{H} device engine in "
          f"{dt:.3f} s = {fps:.4f} fps, {kbps:.1f} kbps at 30 fps against "
          f"a target of {target:.1f} ({kbps / target - 1.0:+.3%}), PSNR-Y "
          f"{psnr:.3f} dB, qp {min(qps)}-{max(qps)}, peak VBV fullness "
          f"{peak:.3f} of its size, dispatches {dev.dispatches}, failures 0, "
          f"sub-GOPs coded serially (RC)", flush=True)


def phase_scene_cut(Encoder, EncoderParams, target):
    """Device-engine LD-P under ABR on a 1080p pan whose luma inverts at
    frame 6: the lookahead marks frame 6 and codes it as an I slice."""
    import numpy as np
    from xeve_tpu_torch.constants import SLICE_I
    base = _frames(W, H, 1)[0]
    frames = []
    for t in range(12):
        # one luma pel to the left per frame
        y, u, v = (np.roll(p, t >> s, axis=1) for p, s in zip(base, (0, 1, 1)))
        if t >= 6:
            y = (1023 - y).astype(np.int16)
        frames.append((y, u, v))
    enc = Encoder(EncoderParams(w=W, h=H, qp=QP, keyint=0, preset="medium",
                                rc_type="abr", bitrate_kbps=target),
                  analysis="device", device="cuda")
    out, stats, dt = _rc_stream(enc, frames)
    fps, kbps, psnr = _rate_line(frames, out, dt)
    types = [st for st, _q, _v in stats]
    assert 6 in enc._force_idr, f"scene cut not marked: {enc._force_idr}"
    assert types[6] == SLICE_I and types.count(SLICE_I) == 2, types
    assert enc._device().dispatches == 12 and enc._device().failures == 0
    print(f"phase 21 scene cut: LD-P ABR {W}x{H}, 12 frames (a pan, luma "
          f"inverted from frame 6): keyframes at {sorted(enc._force_idr)} "
          f"(I slices at {[i for i, t in enumerate(types) if t == SLICE_I]}"
          f"), qps {[q for _s, q, _v in stats]}, {fps:.4f} fps, {kbps:.1f} "
          f"kbps, PSNR-Y {psnr:.3f} dB", flush=True)


def phase_dra_main_ai(Encoder, EncoderParams, frame):
    """Main AI with DRA on the device engine through encode_stream: the
    returned recon is backward-mapped, close to the original."""
    enc = Encoder(EncoderParams(w=W, h=H, qp=QP, keyint=1, profile=1,
                                tool_dra=1, preset="medium"),
                  analysis="device", device="cuda")
    t0 = time.perf_counter()
    out = list(enc.encode_stream(iter([frame])))
    dt = time.perf_counter() - t0
    (bs, rec, _poc), = out
    p = _psnr_y(frame[0], rec[0])
    mapped = _psnr_y(enc._pad_input(*frame)[0], rec[0])
    assert p > 30.0 and p > mapped, f"PSNR-Y {p:.3f}, mapped-domain {mapped}"
    print(f"phase 22 DRA Main AI: 1 frame {W}x{H} device engine in {dt:.3f} "
          f"s, {len(bs)} bytes, PSNR-Y of the backward-mapped recon "
          f"{p:.3f} dB (against the forward-mapped original {mapped:.3f}), "
          f"analyses {enc.analysis_calls}, btt {enc.p.btt}", flush=True)


def phase_cli(target):
    """The port's CLI in a subprocess on a 17-frame 1080p clip: --analysis
    auto must choose the device engine."""
    from gen_test_content import write_clip
    d = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    clip = os.path.join(d, "clip1080.yuv")
    write_clip(clip, W, H, 17)
    cmd = [sys.executable, "-m", "xeve_tpu_torch.app", "-i", clip,
           "-w", str(W), "-h2", str(H), "-q", str(QP), "--analysis", "auto",
           "-b", "15", "--rc", "abr", "--bitrate", str(int(target)),
           "-o", os.path.join(d, "cli.evc"), "-v", "3"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    dt = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("analysis engine device, coder native, "
                               "device cuda"), lines[0]
    summary = [l for l in lines[1:] if ":" in l and not l.startswith("poc ")]
    assert any(l.startswith("Frames              : 17") for l in summary)
    print(f"phase 23 CLI: python -m xeve_tpu_torch.app --analysis auto -b 15 "
          f"--rc abr --bitrate {int(target)} on a 17-frame {W}x{H} clip: "
          f"{lines[0]}; " + "; ".join(l.replace("  ", "").strip()
                                      for l in summary)
          + f"; {dt:.1f} s with the process start", flush=True)


def phase_round_trips_5(Encoder, GopEncoder, EncoderParams, small):
    """128x64 round trips of this slice's routes on the card."""
    from xeve_tpu_torch import app, dec_app
    from xeve_tpu_torch.state import load_state, save_state
    abr = dict(rc_type="abr", bitrate_kbps=300.0)
    phase_round_trip(24, (
        ("device-engine ABR LD-P", Encoder, dict(keyint=0, **abr), small[:6],
         "device"),
        ("device-engine ABR RA", GopEncoder, dict(keyint=0, bframes=15,
                                                  **abr), small, "device"),
        ("CRF RA", GopEncoder, dict(keyint=0, bframes=15, rc_type="crf",
                                    crf=32), small[:17], "jax"),
        ("device-engine DRA Main AI", Encoder, dict(keyint=1, profile=1,
                                                    tool_dra=1), small[:2],
         "device"),
        ("device-engine DRA Main LD-P", Encoder, dict(keyint=0, profile=1,
                                                      tool_dra=1),
         small[:4], "device")), EncoderParams)
    # resume: a "jax"-engine LD-P encode cut at frame 3
    p = dict(w=128, h=64, qp=QP, keyint=0)

    def coded(enc, frames, first):
        return [(*enc.encode_frame(*f), first + i)
                for i, f in enumerate(frames)]

    whole = coded(Encoder(EncoderParams(**p), device="cuda"), small[:6], 0)
    enc = Encoder(EncoderParams(**p), device="cuda")
    split = coded(enc, small[:3], 0)
    enc2 = Encoder(EncoderParams(**p), device="cuda")
    load_state(enc2, save_state(enc))
    split += coded(enc2, small[3:6], 3)
    assert [o[0] for o in split] == [o[0] for o in whole], \
        "resumed encode differs from the unbroken one"
    _assert_decodes("resumed LD-P", split, 6)
    # coder="numpy" against the C pass (exact_rd 0, as the tests hold them)
    p = dict(w=128, h=64, qp=QP, keyint=0, exact_rd=0)
    outs = [list(Encoder(EncoderParams(**p), coder=c, device="cuda")
                 .encode_stream(iter(small[:4]))) for c in ("numpy", "native")]
    assert [o[0] for o in outs[0]] == [o[0] for o in outs[1]], \
        "coder numpy differs from native"
    _assert_decodes("coder numpy LD-P", outs[0], 4)
    # the CLIs: encoder recon dump against the decoder CLI's output
    from gen_test_content import write_clip
    d = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    clip, bs, rec, dec = (os.path.join(d, n) for n in (
        "clip128.yuv", "o128.evc", "rec128.yuv", "dec128.yuv"))
    write_clip(clip, 128, 64, 6)
    assert app.main(["-i", clip, "-w", "128", "-h2", "64", "-q", str(QP),
                     "--rc", "abr", "--bitrate", "300", "-o", bs, "-r", rec,
                     "-v", "0"]) == 0
    assert dec_app.main(["-i", bs, "-o", dec, "-v", "0"]) == 0
    with open(rec, "rb") as a, open(dec, "rb") as b:
        assert a.read() == b.read(), "CLI recon differs from dec_app output"
    print(f"phase 24 (cont.): a resumed \"jax\"-engine LD-P (6 frames, "
          f"cut at 3) equals the unbroken encode "
          f"({sum(len(o[0]) for o in whole)} bytes); coder=\"numpy\" LD-P "
          f"(4) equals the native pass "
          f"({sum(len(o[0]) for o in outs[0])} bytes); both decode "
          f"bit-exactly; the CLI's ABR LD-P recon (6) equals dec_app's "
          f"output", flush=True)


def phase_batch_analyzer(frames):
    """BatchAnalyzer at 1080p on the card: equal to the single-frame
    analysis, close to the CPU's, timed against 4 single-frame calls."""
    import numpy as np
    import torch
    from xeve_tpu_torch.constants import chroma_qp_dynamic
    from xeve_tpu_torch.enc.analysis_torch import BatchAnalyzer, \
        analyze_frame_torch
    qps = (QP, QP + 12, chroma_qp_dynamic(QP) + 12,
           chroma_qp_dynamic(QP) + 12)
    ba = BatchAnalyzer(W, H, *qps, device="cuda")
    res = ba.analyze(frames)                               # warm
    single = [analyze_frame_torch(*f, *qps, 10, device="cuda")
              for f in frames]
    t0 = time.perf_counter()
    cpu = BatchAnalyzer(W, H, *qps, device="cpu").analyze(frames)
    t_cpu = time.perf_counter() - t0
    worst = {}
    for a, one, c in zip(res, single, cpu):
        for lg in range(2, 7):
            assert np.array_equal(a.mode[lg], one.mode[lg]) and \
                np.array_equal(a.split[lg], one.split[lg]), \
                f"level {lg}: batch differs from the single-frame analysis"
            m = float((a.mode[lg] == c.mode[lg]).mean())
            s = float((a.split[lg] == c.split[lg]).mean())
            worst[lg] = min(worst.get(lg, 1.0), m, s)
            assert m >= AGREE_MIN and s >= AGREE_MIN, \
                f"level {lg}: card vs CPU mode {m:.5f} split {s:.5f}"

    def timed(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return sorted(ts)[1]

    t_batch = timed(lambda: ba.analyze(frames))
    t_single = timed(lambda: [analyze_frame_torch(*f, *qps, 10,
                                                  device="cuda")
                              for f in frames])
    print(f"phase 25 BatchAnalyzer: {len(frames)} frames {W}x{H} on the "
          f"card: modes and splits equal the single-frame analysis; card vs "
          f"CPU lowest agreement per level "
          + ", ".join(f"lg{lg} {v:.5f}" for lg, v in worst.items())
          + f" (>= {AGREE_MIN}); one batch {t_batch:.1f} ms against "
          f"{len(frames)} single-frame calls {t_single:.1f} ms (median of 3, "
          f"host clock, synchronised); the CPU batch {t_cpu:.1f} s",
          flush=True)


def phase_encode_frames(Encoder, EncoderParams, frames):
    """encode_frames on the "jax" engine (BatchAnalyzer) against the
    encode_frame loop on the same frames: equal bytes; fps, rate, PSNR-Y
    and the C pass's share of the wall."""
    import numpy as np
    from xeve_tpu_torch import api
    from xeve_tpu_torch.enc.analysis_torch import BatchAnalyzer
    params = dict(w=W, h=H, qp=QP, keyint=1, preset="medium")
    enc = Encoder(EncoderParams(**params), device="cuda")
    with _Spans(api, "encode_intra_frame_native") as s_c, \
            _Spans(BatchAnalyzer, "analyze") as s_a:
        t0 = time.perf_counter()
        out = enc.encode_frames(frames, batch=4)
        t1 = time.perf_counter()
    share = _c_pass_share(s_c.spans, t0, t1)[0]
    loop = Encoder(EncoderParams(**params), device="cuda")
    t2 = time.perf_counter()
    ref = [loop.encode_frame(*f) for f in frames]
    t3 = time.perf_counter()
    assert [bs for bs, _r in out] == [bs for bs, _r in ref], \
        "encode_frames differs from the encode_frame loop"
    fps, kbps, psnr = _rate_line(frames, [(bs, rec, i) for i, (bs, rec)
                                          in enumerate(out)], t1 - t0)
    print(f"phase 26 encode_frames: {len(out)} AI frames {W}x{H}, batch 4, "
          f"\"jax\" engine in {t1 - t0:.3f} s = {fps:.4f} fps, {kbps:.1f} "
          f"kbps at 30 fps, PSNR-Y {psnr:.3f} dB; host clock: C pass "
          f"{s_c.total():.3f} s busy for {share:.3f} of the wall, "
          f"BatchAnalyzer {s_a.total():.3f} s on its thread; the "
          f"encode_frame loop {t3 - t2:.3f} s = {len(frames) / (t3 - t2):.4f} "
          f"fps (same bytes), ratio {(t3 - t2) / (t1 - t0):.3f}", flush=True)
    return fps


def phase_me_engine(Encoder, EncoderParams, frames, me_cuda):
    """me_engine="pallas" on the numpy engine: the numpy search against
    the kernel route on one 1080p pair, then a 2-frame LD-P encode."""
    import numpy as np
    import torch
    from xeve_tpu_torch.enc.analysis_inter_np import integer_me
    from xeve_tpu_torch.ops import mc_np
    cur = np.asarray(frames[1][0], np.int32)
    ref_pad = mc_np.pad_picture(np.asarray(frames[0][0], np.int32), PAD)
    t0 = time.perf_counter()
    mv0, cost0 = integer_me(cur, ref_pad, PAD, 16)
    t_np = time.perf_counter() - t0
    dev = torch.device("cuda")
    me_cuda.integer_me_np(cur, ref_pad, PAD, 16, device=dev)   # warm
    ts = []
    for _ in range(5):
        t = time.perf_counter()
        mv, cost = me_cuda.integer_me_np(cur, ref_pad, PAD, 16, device=dev)
        ts.append((time.perf_counter() - t) * 1e3)
    assert np.array_equal(mv, mv0) and np.array_equal(cost, cost0), \
        "kernel route and numpy integer_me disagree"
    print(f"phase 27 me_engine: one {W}x{H} pair, R=16: numpy integer_me "
          f"{t_np:.3f} s on the host, the kernel route (upload, kernel, "
          f"download) {sorted(ts)[2]:.2f} ms (median of 5, host clock), MV "
          f"fields and costs identical", flush=True)
    # the LD-P encode: the I frame takes the card's intra decisions
    # (analysis_pre), so the numpy host analysis runs for the P frame only
    from xeve_tpu_torch import api
    from xeve_tpu_torch.constants import SLICE_I
    from xeve_tpu_torch.enc.analysis_torch import analyze_frame_torch
    enc = Encoder(EncoderParams(w=W, h=H, qp=QP, keyint=0, preset="medium"),
                  analysis="numpy", me_engine="pallas", device="cuda")
    qp_i = enc._slice_qp(SLICE_I)
    an0 = analyze_frame_torch(*enc._pad_input(*frames[0]), qp_i,
                              *enc._qp_triplet(qp_i), 10, device="cuda")
    me_cuda.LAUNCHES = 0
    with _Spans(enc, "_analyze_inter") as s_a, \
            _Spans(api, "encode_intra_frame_native") as s_ci, \
            _Spans(enc, "_code_slice") as s_cs:
        t0 = time.perf_counter()
        out = [(*enc.encode_frame(*frames[0], analysis_pre=an0), 0),
               (*enc.encode_frame(*frames[1]), 1)]
        dt = time.perf_counter() - t0
    n_launch = me_cuda.LAUNCHES
    assert n_launch == 1, f"{n_launch} ME kernel launches, expected 1"
    assert enc.analysis_calls == 1 and enc.analysis_engine == "numpy"
    fps, kbps, psnr = _rate_line(frames[:2], out, dt)
    print(f"phase 27 numpy engine, me_engine pallas, LD-P: 2 frames {W}x{H} "
          f"(the I frame on the card's decisions) in {dt:.3f} s = "
          f"{fps:.4f} fps, {kbps:.1f} kbps at 30 fps, PSNR-Y {psnr:.3f} dB, "
          f"ME kernel launches {n_launch}; host clock: numpy P analysis "
          f"{s_a.total():.3f} s, C pass {s_ci.total() + s_cs.total():.3f} s "
          f"of the {dt:.3f} s wall", flush=True)
    return n_launch


def phase_meshed(GopEncoder, EncoderParams, frames, ref_stream):
    """encode_stream_meshed on make_mesh() and on [cuda:0, cuda:0]: each
    stream byte-equal to phase 12's."""
    import torch
    from xeve_tpu_torch.parallel.mesh import make_mesh
    meshes = {"make_mesh()": make_mesh(),
              "[cuda:0, cuda:0]": [torch.device("cuda", 0)] * 2}
    parts = []
    for name, mesh in meshes.items():
        enc = GopEncoder(EncoderParams(w=W, h=H, qp=QP, keyint=0,
                                       bframes=15, preset="medium"),
                         analysis="device", device="cuda")
        t0 = time.perf_counter()
        out = list(enc.encode_stream_meshed(iter(frames), mesh))
        dt = time.perf_counter() - t0
        assert [bs for bs, _r, _p in out] == ref_stream, \
            f"meshed stream on {name} differs from phase 12's"
        assert enc._device().failures == 0
        parts.append(f"{name} ({len(mesh)} entries) {len(out) / dt:.4f} fps "
                     f"in {dt:.3f} s")
    print(f"phase 28 meshed: RA GOP16 {len(frames)} frames {W}x{H}, streams "
          f"byte-equal to phase 12's ({sum(len(b) for b in ref_stream)} "
          f"bytes): " + "; ".join(parts), flush=True)


def phase_round_trips_6(Encoder, GopEncoder, EncoderParams, small):
    """128x64 round trips of this slice's routes on the card."""
    import numpy as np
    import torch
    from xeve_tpu_torch import graft_entry
    from xeve_tpu_torch.parallel.mesh import make_mesh
    for engine in ("jax", "numpy"):
        out = Encoder(EncoderParams(w=128, h=64, qp=QP, keyint=1),
                      analysis=engine, device="cuda") \
            .encode_frames(small[:5], batch=2)
        _assert_decodes(f"encode_frames {engine}",
                        [(bs, rec, i) for i, (bs, rec) in enumerate(out)], 5)
    streams = []
    for me_engine in ("pallas", None):
        out = list(Encoder(EncoderParams(w=128, h=64, qp=QP, keyint=0),
                           analysis="numpy", me_engine=me_engine,
                           device="cuda").encode_stream(iter(small[:4])))
        _assert_decodes(f"numpy engine me_engine {me_engine}", out, 4)
        streams.append([bs for bs, _r, _p in out])
    assert streams[0] == streams[1], "me_engine pallas differs from None"
    out = list(GopEncoder(EncoderParams(w=128, h=64, qp=QP, keyint=0,
                                        bframes=15),
                          analysis="device", device="cuda")
               .encode_stream_meshed(iter(small),
                                     [torch.device("cuda", 0)] * 2))
    _assert_decodes("meshed RA", out, len(small))
    fn, args = graft_entry.entry()
    mode, cost = (t.cpu().numpy() for t in fn(*args))
    cfn, cargs = graft_entry.entry(device="cpu")
    cmode, ccost = (t.numpy() for t in cfn(*cargs))
    agree = float((mode == cmode).mean())
    assert mode.shape == (8, 8) and np.isfinite(cost).all()
    assert agree >= 0.98 and np.allclose(cost, ccost, rtol=1e-5), \
        f"graft entry: card vs CPU modes {agree:.4f}"
    graft_entry.dryrun_multichip(2)
    print(f"phase 29 round trip: encode_frames (\"jax\", numpy; 5), the "
          f"numpy engine LD-P with me_engine pallas and None (4, equal "
          f"streams), meshed RA on [cuda:0, cuda:0] ({len(small)}) at 128x64 "
          f"decode bit-exactly; graft_entry.entry() on the card: modes "
          f"agree with the CPU's on {agree:.4f} of the blocks, costs to "
          f"rtol 1e-5; dryrun_multichip(2) on make_mesh(2) = "
          f"{len(make_mesh(2))} card(s) passed", flush=True)


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    # tools/ is a directory, not a package: a site package named `tools`
    # would shadow `tools.gen_test_content`
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    from xeve_tpu_torch.native.build import get_lib as get_native_lib
    from xeve_tpu_torch.params import EncoderParams
    from xeve_tpu_torch.api import Encoder, GopEncoder
    from xeve_tpu_torch.enc import analysis_main_torch as amt
    from xeve_tpu_torch.enc import device_analyzer as dan
    from xeve_tpu_torch.enc.me_torch import integer_me_plain
    from xeve_tpu_torch.ops import _build, me_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build("me_full_search")
    t1 = time.perf_counter()
    # the host C coding pass builds (gcc) at first use: build it here so
    # that the encode phases time encoding only
    get_native_lib()
    print(f"phase 2 build: {os.path.relpath(lib, ROOT)} in {t1 - t0:.2f} s;"
          f" native C pass in {time.perf_counter() - t1:.2f} s", flush=True)

    rec = phase_kernel(me_cuda, integer_me_plain)
    phase_analysis()

    frames = _frames(W, H, 17)
    launches = phase_encode(
        "phase 5 LD-P", Encoder,
        EncoderParams(w=W, h=H, qp=QP, keyint=0, preset="medium"),
        frames[:3], me_cuda, 2)
    launches += phase_encode(
        "phase 6 RA", GopEncoder,
        EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15,
                      preset="medium"), frames, me_cuda, 31)

    small = _frames(128, 64, 18)
    phase_round_trip(7, (
        ("LD-P", Encoder, dict(keyint=0), small[:4], "jax"),
        ("RA", GopEncoder, dict(keyint=0, bframes=15), small[:17], "jax")),
        EncoderParams)

    phase_fused(dan)
    phase_dispatch(dan)
    me_cuda.LAUNCHES = 0
    phase_device_encode("phase 10 AI", Encoder,
                        EncoderParams(w=W, h=H, qp=QP, keyint=1,
                                      preset="medium"), frames[:4])
    phase_device_encode("phase 11 LD-P", Encoder,
                        EncoderParams(w=W, h=H, qp=QP, keyint=0,
                                      preset="medium"), frames[:8], ahead=3)
    ra_kbps, ra_stream = phase_device_encode(
        "phase 12 RA", GopEncoder,
        EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15,
                      preset="medium"), frames)
    assert me_cuda.LAUNCHES == 0, "the device engine launched the ME kernel"
    phase_round_trip(13, (
        ("device-engine LD-P", Encoder, dict(keyint=0), small[:5],
         "device"),
        ("device-engine RA", GopEncoder, dict(keyint=0, bframes=15), small,
         "device")), EncoderParams)

    phase_main_analysis(amt)
    phase_main_dispatch(amt)
    phase_encode("phase 16 Main AI", Encoder,
                 EncoderParams(w=W, h=H, qp=QP, keyint=1, profile=1,
                               preset="medium"), frames[:2], me_cuda, 0)
    launches += phase_encode(
        "phase 17 Main RA", GopEncoder,
        EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15, profile=1,
                      preset="medium"), frames, me_cuda, 31)
    phase_round_trip(18, (
        ("Main AI", Encoder, dict(keyint=1, profile=1), small[:3], "jax"),
        ("Main LD-P", Encoder, dict(keyint=0, profile=1), small[:4], "jax"),
        ("Main RA", GopEncoder, dict(keyint=0, bframes=15, profile=1),
         small[:17], "jax"),
        ("device-engine Main RA", GopEncoder,
         dict(keyint=0, bframes=15, profile=1), small, "device")),
        EncoderParams)

    # rate control, DRA, checkpoint/resume, the CLIs, the numpy coder
    target = round(2.0 * ra_kbps, 1)     # about 2x phase 12's CQ-32 rate
    me_cuda.LAUNCHES = 0
    phase_abr_ra(GopEncoder, EncoderParams,
                 frames + _frames(W, H, 33, start=17), target)
    assert me_cuda.LAUNCHES == 0, "the device engine launched the ME kernel"
    launches += phase_encode(
        "phase 20 CRF RA", GopEncoder,
        EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15, rc_type="crf",
                      crf=32, preset="medium"), frames, me_cuda, 31)
    phase_scene_cut(Encoder, EncoderParams, target)
    phase_dra_main_ai(Encoder, EncoderParams, frames[0])
    phase_cli(target)
    phase_round_trips_5(Encoder, GopEncoder, EncoderParams, small)

    # the last device graphs and switches: BatchAnalyzer + encode_frames,
    # me_engine on the numpy engine, the meshed RA sub-GOP analysis
    phase_batch_analyzer(frames[:4])
    phase_encode_frames(Encoder, EncoderParams, frames[:8])
    launches += phase_me_engine(Encoder, EncoderParams, frames, me_cuda)
    me_cuda.LAUNCHES = 0
    phase_meshed(GopEncoder, EncoderParams, frames, ra_stream)
    assert me_cuda.LAUNCHES == 0, "the device engine launched the ME kernel"
    phase_round_trips_6(Encoder, GopEncoder, EncoderParams, small)
    assert not any(m.split(".")[0] in ("jax", "xeve_tpu")
                   for m in sys.modules), "the port imported jax or xeve_tpu"

    print(f"wall time of the run: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "me_full_search", "route": "cuda",
        "source": "xeve_tpu_torch/csrc/me_full_search.cu",
        "replaces": "xeve_tpu/ops/pallas_me.py:34",
        "launches": launches, **rec}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
