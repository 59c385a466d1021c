#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xeve_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. card: name and power limit (nvidia-smi); fails without CUDA;
  2. build: compile the ME kernel (csrc/me_full_search.cu) with nvcc and
     the host C coding pass with gcc, so the encode phases time encoding;
  3. kernel: full-search ME at 1920x1088 10-bit, R=16, against its plain
     PyTorch version (random pair, shifted pair): MVs and costs identical;
  4. analysis: intra and inter analysis at 1920x1088 on the card against
     the same calls on the CPU (MV maps identical; modes and splits agree
     on >= 0.99 of the blocks of each level);
  5. LD-P encode, 3 frames at 1920x1088, QP 32, preset medium;
  6. RA GOP16 encode, 17 frames at 1920x1088;
  7. round trip: LD-P and RA streams at 128x64 coded on the card decode
     bit-exactly through the Python conformance decoder.
The kernel launch count is reset before phase 5 and read after phase 6.
The last two lines are the kernel record and {"ok": true, "device": ...}.
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


def _frames(w, h, n):
    import numpy as np
    from gen_test_content import gen_frame
    out = []
    for t in range(n):
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
    from xeve_tpu.ops import mc_np
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
    # timed on the shifted pair, the last one staged
    ms = _cuda_ms(lambda: me_cuda.integer_me(c, r, PAD, 16), 20)
    plain_ms = _cuda_ms(lambda: integer_me_plain(c, r, 16, PAD), 3)
    print(f"phase 3 kernel: {W}x{H} R=16 random+shifted pairs identical; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events)",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_analysis():
    import numpy as np
    import torch
    from xeve_tpu.constants import chroma_qp_dynamic
    from xeve_tpu.ops import mc_np
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


def encode(cls, params, frames, device):
    enc = cls(params, device=device)
    t0 = time.perf_counter()
    out = list(enc.encode_stream(iter(frames)))
    dt = time.perf_counter() - t0
    return enc, out, dt


def phase_encode(label, cls, params, frames, me_cuda):
    import numpy as np
    before = me_cuda.LAUNCHES
    enc, out, dt = encode(cls, params, frames, "cuda")
    n = len(out)
    assert n == len(frames), f"{label}: {n} outputs for {len(frames)} frames"
    assert enc.analysis_calls == n, \
        f"{label}: {enc.analysis_calls} analyses for {n} frames"
    assert me_cuda.LAUNCHES > before, f"{label}: ME kernel never launched"
    nbytes = sum(len(bs) for bs, _rec, _poc in out)
    ps = [_psnr_y(frames[poc][0], rec[0]) for _bs, rec, poc in out]
    assert all(np.isfinite(p) and p > 30.0 for p in ps), f"{label}: {ps}"
    print(f"{label}: {n} frames {params.w}x{params.h} in {dt:.3f} s = "
          f"{n / dt:.4f} fps, {nbytes * 8 * 30.0 / n / 1000.0:.1f} kbps at "
          f"30 fps, PSNR-Y {float(np.mean(ps)):.3f} dB, kernel launches "
          f"{me_cuda.LAUNCHES - before}", flush=True)


def phase_round_trip(Encoder, GopEncoder, EncoderParams):
    import numpy as np
    from xeve_tpu.dec.decoder import BaselineIntraDecoder
    frames = _frames(128, 64, 17)
    for label, cls, kw, fr in (
            ("LD-P", Encoder, dict(keyint=0), frames[:4]),
            ("RA", GopEncoder, dict(keyint=0, bframes=15), frames)):
        _enc, out, _dt = encode(cls, EncoderParams(w=128, h=64, qp=QP, **kw),
                                fr, "cuda")
        recs = {poc: rec for _bs, rec, poc in out}
        dec = BaselineIntraDecoder().decode(b"".join(b for b, _r, _p in out))
        assert len(dec) == len(fr), f"{label}: decoded {len(dec)} frames"
        for f in dec:
            for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
                assert np.array_equal(a, b), f"{label} poc {f.poc} differs"
    print("phase 7 round trip: LD-P (4) and RA (17) at 128x64 decode "
          "bit-exactly", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    # tools/ is a directory, not a package: a site package named `tools`
    # would shadow `tools.gen_test_content`
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    from xeve_tpu.native.build import get_lib as get_native_lib
    from xeve_tpu.params import EncoderParams
    from xeve_tpu_torch.api import Encoder, GopEncoder
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
    me_cuda.LAUNCHES = 0
    phase_encode("phase 5 LD-P", Encoder,
                 EncoderParams(w=W, h=H, qp=QP, keyint=0, preset="medium"),
                 frames[:3], me_cuda)
    phase_encode("phase 6 RA", GopEncoder,
                 EncoderParams(w=W, h=H, qp=QP, keyint=0, bframes=15,
                               preset="medium"),
                 frames, me_cuda)
    launches = me_cuda.LAUNCHES

    phase_round_trip(Encoder, GopEncoder, EncoderParams)
    assert "jax" not in sys.modules, "the port imported jax"

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
