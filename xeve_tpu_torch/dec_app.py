"""xeve_tpu_torch.dec_app: the port's conformance decoder CLI, the twin of
xeve_tpu_dec.py — decodes EVC Baseline and Main streams (the port's or the
reference encoder's) and dumps 10-bit recon YUV.

  python -m xeve_tpu_torch.dec_app -i out.evc -o dec.yuv
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="EVC conformance decoder (PyTorch port)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", help="recon YUV (10-bit LE planar)")
    ap.add_argument("-v", "--verbose", type=int, default=2)
    args = ap.parse_args(argv)

    from .dec.decoder import BaselineIntraDecoder, DecodeError
    from .io.video import write_recon_frame

    with open(args.input, "rb") as fi:
        stream = fi.read()
    try:
        frames = BaselineIntraDecoder().decode(stream)
    except DecodeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.verbose >= 2:
        for f in frames:
            st = {0: "B", 1: "P", 2: "I"}.get(f.slice_type, "?")
            print(f"poc {f.poc}  {st}-slice  qp {f.qp}  {f.y.shape[1]}x{f.y.shape[0]}")
        print(f"decoded {len(frames)} frames")
    if args.output:
        with open(args.output, "wb") as fo:
            for f in frames:
                write_recon_frame(fo, f.y, f.u, f.v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
