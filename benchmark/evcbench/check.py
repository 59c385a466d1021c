"""What decides `correct`: the timed path's outputs against the plain
reference under evcbench/reference/, which imports nothing of the
program.

Six numbers, each against its limit (benchmark/limits/):

- order_errors: emitted frames whose display index is not the one the
  traffic's coding order puts there.
- dispatch_errors: analyses the program dispatched with another qp, or
  other reference frames, than the coding structure that the traffic
  file states gives (`Structure`).
- decode_errors: frames of the decoded sample that the frozen decoder
  refuses, or that decode to anything but the encoder's reconstruction
  (the syntax and entropy coding, and the reconstruction).
- far_frames: frames of the quality set whose reconstruction lies below
  `psnr_floor_db` of luma PSNR from its own source frame (a frame coded
  from the wrong picture decodes to its reconstruction all the same).
- mv_off, decisions_off: the fused analyzer's decisions on a sample of the
  window's frames against the reference analysis in float64, worked out
  again from the benchmark's own source frames: the count of MV entries
  that differ, and the share of intra-mode and split entries that differ.
"""
from __future__ import annotations

import numpy as np

from .reference import constants as rc
from .reference import fused
from .reference.dec.decoder import BaselineIntraDecoder, DecodeError
from .timeline import ra_coding_order


def pad_frame(y, u, v, w, h):
    """Edge-pad a source frame to the coded size (multiples of 8)."""
    wa, ha = (w + 7) & ~7, (h + 7) & ~7
    ey, ex = ha - h, wa - w
    if not (ey or ex):
        return y, u, v
    y = np.pad(y, ((0, ey), (0, ex)), mode="edge")
    u = np.pad(u, ((0, ey // 2 + (ey & 1)), (0, ex // 2 + (ex & 1))),
               mode="edge")[:ha // 2, :wa // 2]
    v = np.pad(v, ((0, ey // 2 + (ey & 1)), (0, ex // 2 + (ex & 1))),
               mode="edge")[:ha // 2, :wa // 2]
    return y, u, v


def qp_triplet(qp, bd, iqt):
    """(qp_y, qp_u, qp_v) at the codec bit depth, with no chroma qp
    offset (the configurations set none)."""
    qc = rc.chroma_qp_dynamic(int(np.clip(qp, -6 * (bd - 8), 57)), iqt)
    return qp + 6 * (bd - 8), qc + 6 * (bd - 8), qc + 6 * (bd - 8)


class Structure:
    """The coding structure that a traffic file states under `structure`,
    and what the check derives from it:

      encoder       the class of xeve_tpu_torch.api that the cell drives
      order         "ai" (every frame intra, in display order), "ld" (I
                    frames, then P frames in display order) or "ra"
                    (hierarchical B in sub-GOPs of `gop` frames, each in
                    coding order: its anchor, then the levels)
      gop           sub-GOP length of "ra", a power of two
      intra_period  "ld": an I frame at every multiple (0: the first alone;
                    "ra" has none, as the port's RA route)
      refs          "ld": active L0 references of a P frame (1 or 2: the
                    previous frame and the one before, not across an I)
      qp            {"model": "fixed"}: every frame at the configured qp;
                    {"model": "ladder", "table": <name in
                    reference/constants.py>, "i_depth": d, "tid_depth":
                    [d per temporal id]}: qp + the table's offsets at that
                    depth; {"model": "rc"}: the qp is the rate control's,
                    so only its chroma pair and the references are checked

    The analyses take source frames as references (the port's default;
    closed-loop LD analyses against reconstructions and is not covered).
    """

    def __init__(self, spec):
        self.encoder = spec["encoder"]
        self.order = spec["order"]
        if self.order not in ("ai", "ld", "ra"):
            raise ValueError(f"unknown order {self.order!r}")
        self.gop = int(spec.get("gop", 1))
        if self.order == "ra" and (self.gop < 2 or self.gop & (self.gop - 1)):
            raise ValueError(f"an RA sub-GOP of {self.gop} frames")
        self.intra_period = 1 if self.order == "ai" else int(
            spec.get("intra_period", 0))
        if self.order == "ra" and self.intra_period:
            raise ValueError("RA with an intra period is not covered")
        self.refs = int(spec.get("refs", 1))
        if self.refs not in (1, 2) or (self.order == "ra" and self.refs != 1):
            raise ValueError(f"{self.refs} references on order {self.order}")
        self.qp = dict(spec["qp"])
        if self.qp["model"] not in ("fixed", "ladder", "rc"):
            raise ValueError(f"unknown qp model {self.qp['model']!r}")
        if self.qp["model"] == "ladder":
            self.table = getattr(rc, self.qp["table"])

    def coding_order(self, n):
        """(display index, temporal id) of each of the first n
        emissions."""
        if self.order != "ra":
            return [(d, 0) for d in range(n)]
        return ra_coding_order(-(-n // self.gop) + 1, self.gop)[:n]

    def _tid(self, poc):
        low = poc & -poc
        return 0 if low >= self.gop else self.gop.bit_length() - \
            low.bit_length()

    def frame(self, poc):
        """(intra, temporal id, l0, l1, l0b) of display index poc; a
        reference that the frame does not have is None."""
        if poc == 0 or (self.intra_period > 0
                        and poc % self.intra_period == 0):
            return True, 0, None, None, None
        if self.order == "ld":
            last_i = (poc // self.intra_period) * self.intra_period \
                if self.intra_period > 0 else 0
            l0b = poc - 2 if self.refs > 1 and poc - 2 >= last_i else None
            return False, 0, poc - 1, None, l0b
        tid = self._tid(poc)
        if tid == 0:
            return False, 0, poc - self.gop, None, None
        low = poc & -poc
        return False, tid, poc - low, poc + low, None

    def slice_qp(self, qp, poc):
        """The qp of display index poc, or None under rate control."""
        m = self.qp["model"]
        if m == "fixed":
            return qp
        if m == "rc":
            return None
        intra, tid = self.frame(poc)[:2]
        depth = self.qp["i_depth"] if intra else self.qp["tid_depth"][tid]
        off_layer, off_model, scale_model = self.table[depth]
        q = qp + off_layer
        dqp = q * scale_model + off_model + 0.5
        q += int(np.floor(np.clip(dqp, 0.0, 3.0)))
        return int(np.clip(q, 0, 51))


def expected_order(n, structure):
    """Display index of each of the first n emissions."""
    return [d for d, _ in structure.coding_order(n)]


def dispatch_errors(records, qp, bd, iqt, structure):
    """Count the recorded dispatches (args, kwargs) whose qp, chroma qps or
    reference frames differ from the structure's."""
    bad = 0
    for a, k in records:
        poc, got = a[0], tuple(a[1:5])
        q = structure.slice_qp(qp, poc)
        q = got[0] if q is None else q
        _i, _t, l0, l1, l0b = structure.frame(poc)
        r0, r1 = k.get("ref_poc"), k.get("ref1_poc")
        if r1 == r0:
            r1 = None
        if (got != (q, *qp_triplet(q, bd, iqt)) or (r0, r1) != (l0, l1)
                or k.get("ref0b_poc") != l0b
                or k.get("ref1b_poc") is not None):
            bad += 1
    return bad


def decode_errors(streams, recons):
    """Decode the concatenated streams with the frozen decoder; count the
    frames that do not decode, in decoding order, to their reconstruction
    (all of them when the stream is refused)."""
    try:
        frames = BaselineIntraDecoder().decode(b"".join(streams))
    except DecodeError:
        return len(recons)
    bad = abs(len(frames) - len(recons))
    for f, rec in zip(frames, recons):
        if not all(np.array_equal(a, np.asarray(b))
                   for a, b in zip((f.y, f.u, f.v), rec)):
            bad += 1
    return bad


def decisions(ref: dict, prog) -> tuple:
    """(MV entries that differ, mode/split entries that differ, mode/split
    entries) of the program's analysis result against the reference's."""
    mv_bad, ms_bad, ms_n = 0, 0, 0
    for key, want in ref.items():
        got = getattr(prog, key, None)
        for lg, a in want.items():
            b = None if got is None else got.get(lg)
            b = None if b is None else np.asarray(b)
            n = a.size
            diff = n if b is None or b.shape != a.shape else int(
                np.count_nonzero(a != b.astype(a.dtype)))
            if key in ("mode", "split"):
                ms_bad += diff
                ms_n += n
            else:
                mv_bad += diff
    return mv_bad, ms_bad, ms_n


def analyzer_readings(samples, src, qp, bd, iqt, structure, device):
    """mv_off and decisions_off over the sampled analyses.

    samples: [(display index, the qp the program dispatched it at, the
    program's analysis result)]; src(i) gives the padded source (y, u, v)
    of display index i.  The reference analyses at the structure's qp,
    and at the dispatched one under rate control."""
    import torch
    mv_bad, ms_bad, ms_n = 0, 0, 0
    for poc, q_prog, prog in samples:
        q = structure.slice_qp(qp, poc)
        q = q_prog if q is None else q
        _i, _t, l0, l1, l0b = structure.frame(poc)
        refs = {k: src(i) for k, i in (("l0", l0), ("l1", l1), ("l0b", l0b))
                if i is not None}
        ref = fused.analyze(src(poc), refs, q, *qp_triplet(q, bd, iqt),
                            bd=bd, dtype=torch.float64, device=device)
        a, b, n = decisions(ref, prog)
        mv_bad, ms_bad, ms_n = mv_bad + a, ms_bad + b, ms_n + n
    return mv_bad, ms_bad / max(ms_n, 1)
