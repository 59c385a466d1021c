"""xeve_tpu_torch.app: CLI encoder of the PyTorch port, the twin of
xeve_tpu_app.py (same flags and summary lines) with one flag more,
--device.

Examples:
  python -m xeve_tpu_torch.app -i in.yuv -w 352 -h2 288 -q 32 -I 1 -o out.evc
  python -m xeve_tpu_torch.app -i in.y4m -q 30 -b 15 --rc abr --bitrate 900 \\
      -o out.evc -r recon.yuv                       # RA GOP16, ABR, on the card
  python -m xeve_tpu_torch.app -i in.y4m -q 30 --device cpu -o out.evc

--device cuda (the default) runs on the card and exits non-zero where
torch finds none; it never carries on on the CPU.  --analysis auto picks
the fused device engine ("device") on the card and the numpy engine with
--device cpu.
"""
import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="MPEG-5 EVC encoder (PyTorch port)")
    ap.add_argument("-i", "--input", required=True, help="raw YUV or .y4m")
    ap.add_argument("-o", "--output", help="output bitstream (.evc)")
    ap.add_argument("-r", "--recon", help="recon dump (10-bit LE yuv)")
    ap.add_argument("-w", "--width", type=int, default=0)
    ap.add_argument("-h2", "--height", type=int, default=0)
    ap.add_argument("-q", "--qp", type=int, default=32)
    ap.add_argument("-d", "--input-depth", type=int, default=8, choices=(8, 10))
    ap.add_argument("--codec-bd", type=int, default=10, choices=(8, 10),
                    help="internal coding bit depth")
    ap.add_argument("-I", "--keyint", type=int, default=0,
                    help="0: first frame I only; 1: all-intra; N: I every N")
    ap.add_argument("-b", "--bframes", type=int, default=0,
                    help="15: random-access GOP16 hierarchical B")
    ap.add_argument("--frames", type=int, default=0, help="max frames (0=all)")
    ap.add_argument("--btt", type=int, default=0,
                    help="BTT split-tree syntax (Main; stage-1 quad-as-binary emission)")
    ap.add_argument("--tile-columns", type=int, default=1)
    ap.add_argument("--tile-rows", type=int, default=1)
    ap.add_argument("-m", "--threads", type=int, default=1)
    ap.add_argument("--ref", type=int, default=-1, dest="ref_pics",
                    help="active reference pictures per list (1-2; "
                         "-1 = preset default)")
    ap.add_argument("--aq", type=int, default=0, dest="aq_mode",
                    choices=(0, 1, 2),
                    help="adaptive quantization (1: variance AQ, "
                         "2: AQ + cutree-lite)")
    ap.add_argument("--config", default=None,
                    help="config file, one key=value per line "
                         "('#' comments); applied before --set")
    ap.add_argument("--set", action="append", default=[], dest="kv",
                    metavar="KEY=VALUE",
                    help="set any EncoderParams field by name "
                         "(xeve_param_parse analog; repeatable)")
    ap.add_argument("--preset", default="medium",
                    choices=("fast", "medium", "slow", "placebo"))
    ap.add_argument("--tune", default="", choices=("", "zerolatency", "psnr"))
    ap.add_argument("--profile", default="baseline",
                    choices=("baseline", "main"))
    ap.add_argument("--rc", default="cqp", choices=("cqp", "abr", "crf"))
    ap.add_argument("--bitrate", type=int, default=0, help="kbps (abr)")
    ap.add_argument("--crf", type=int, default=26)
    ap.add_argument("--no-deblock", action="store_true")
    ap.add_argument("--no-rdoq", action="store_true")
    ap.add_argument("--hash", action="store_true",
                    help="embed picture-signature SEI")
    ap.add_argument("--analysis", default="auto",
                    choices=("auto", "device", "jax", "numpy"))
    ap.add_argument("--coder", default="native", choices=("native", "numpy"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device of the analysis (cuda: the card, "
                         "which must be present)")
    ap.add_argument("-v", "--verbose", type=int, default=2)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device (pass "
              "--device cpu to encode on the CPU)", file=sys.stderr)
        return 2

    from .api import Encoder, GopEncoder, psnr
    from .io.video import open_video, write_recon_frame
    from .params import EncoderParams, apply_param_strings

    reader = open_video(args.input, args.width, args.height, args.input_depth,
                        codec_depth=args.codec_bd)
    w, h = getattr(reader, "w", args.width), getattr(reader, "h", args.height)

    analysis = args.analysis
    if analysis == "auto":
        analysis = "device" if args.device == "cuda" else "numpy"

    params = EncoderParams(
        w=w, h=h, qp=args.qp, keyint=args.keyint, bframes=args.bframes,
        profile=1 if args.profile == "main" else 0,
        preset=args.preset, tune=args.tune,
        tile_columns=args.tile_columns, btt=args.btt, tile_rows=args.tile_rows,
        threads=args.threads, ref_pics=args.ref_pics,
        aq_mode=args.aq_mode,
        rc_type=args.rc if args.rc != "cqp" else "cq",
        bitrate_kbps=args.bitrate, crf=args.crf,
        use_deblock=not args.no_deblock, rdoq=not args.no_rdoq,
        use_pic_sign=args.hash, codec_bit_depth=args.codec_bd)
    if args.config:
        with open(args.config) as cf:
            apply_param_strings(params, cf)
    apply_param_strings(params, args.kv)
    cls = GopEncoder if params.bframes >= 15 else Encoder
    enc = cls(params, analysis=analysis, coder=args.coder, device=args.device)
    if args.verbose >= 3:
        print(f"analysis engine {analysis}, coder {args.coder}, device "
              f"{enc.device}")

    fo = open(args.output, "wb") if args.output else None
    fr = open(args.recon, "wb") if args.recon else None

    def read_frames():
        n = 0
        while True:
            fr_data = reader.read_frame()
            if fr_data is None or (args.frames and n >= args.frames):
                return
            yield fr_data
            n += 1

    originals = []          # display-order originals for PSNR
    out_by_poc = {}
    n = 0
    total_bytes = 0
    psnrs = []
    t0 = time.time()

    def frames_teed():
        for f in read_frames():
            originals.append(f[0])
            yield f

    try:
        for bs, rec, poc in enc.encode_stream(frames_teed()):
            total_bytes += len(bs)
            if fo:
                fo.write(bs)
            p = psnr(rec[0][:originals[poc].shape[0],
                            :originals[poc].shape[1]],
                     originals[poc], bd=args.codec_bd)
            psnrs.append(p)
            if fr:
                out_by_poc[poc] = rec
                while n in out_by_poc:       # emit recon in display order
                    write_recon_frame(fr, *out_by_poc.pop(n))
                    n += 1
            else:
                n += 1
            if args.verbose >= 3:
                print(f"poc {poc}: {len(bs)} bytes  PSNR-Y {p:.2f}")
    finally:
        if fo:
            fo.close()
        if fr:
            fr.close()
        reader.close()
    dt = time.time() - t0
    if args.verbose >= 2 and n:
        print("=== Summary " + "=" * 40)
        print(f"Frames              : {n}")
        print(f"Bitrate @30fps      : {total_bytes * 8 * 30 / n / 1000:.2f} kbps")
        print(f"Avg PSNR-Y          : {np.mean(psnrs):.3f} dB")
        print(f"Encoding speed      : {n / dt:.3f} frames/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
