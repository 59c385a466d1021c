"""What decides `correct`: the timed path's outputs against the plain
reference under evcbench/reference/ and the engine modules' plain
references, which import nothing of the program.

Six numbers, each against its limit (benchmark/limits/):

- order_errors: emitted frames whose display index is not the one the
  traffic's coding order puts there.
- dispatch_errors: analysis records of the stream (`record`) whose qp,
  chroma qps or reference frames differ from what the coding structure
  that the traffic file states gives (`Structure`).
- decode_errors: frames of the decoded sample that the frozen decoder
  refuses, or that decode to anything but the encoder's reconstruction
  (the syntax and entropy coding, and the reconstruction).
- far_frames: frames of the quality set whose reconstruction lies below
  `psnr_floor_db` of luma PSNR from its own source frame (a frame coded
  from the wrong picture decodes to its reconstruction all the same).
- mv_off, decisions_off: the engine's decisions on a sample of the
  window's analysis records against the engine's plain reference
  analysis, worked out again from the benchmark's own source frames (and,
  for an engine that analyses against reconstructions, the frozen
  decoder's pictures of them): the count of MV entries that differ, and
  the share of intra-mode and split entries that differ.  An empty
  sample counts as many MV entries off as it should have had frames.
"""
from __future__ import annotations

import numpy as np

from .reference import constants as rc
from .reference.dec.decoder import BaselineIntraDecoder, DecodeError
from .timeline import ra_coding_order

REFS = ("l0", "l1", "l0b", "l1b")


def record(poc, qp, qps, l0=None, l1=None, l0b=None, l1b=None):
    """One analysis record, as an engine module's taps keep it for each
    frame the route analyses: its display index `poc`, the `qp` and the
    (qp_y, qp_u, qp_v) `qps` it was analysed at, its references as display
    indices (None where absent; an L1 reference that is the L0 picture is
    no second list: None), and its `result`, None until the program has
    it."""
    return {"poc": poc, "qp": qp, "qps": tuple(qps), "l0": l0,
            "l1": None if l1 == l0 else l1, "l0b": l0b, "l1b": l1b,
            "result": None}


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

    It says which frames an analysis references; the engine module says
    whether it takes their sources or their reconstructions (REFERENCES).
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
        """(intra, temporal id, refs) of display index poc: refs maps each
        of REFS to the display index of that reference, None where the
        frame has none (l1b always: no structure here has one)."""
        none = dict.fromkeys(REFS)
        if poc == 0 or (self.intra_period > 0
                        and poc % self.intra_period == 0):
            return True, 0, none
        if self.order == "ld":
            last_i = (poc // self.intra_period) * self.intra_period \
                if self.intra_period > 0 else 0
            l0b = poc - 2 if self.refs > 1 and poc - 2 >= last_i else None
            return False, 0, dict(none, l0=poc - 1, l0b=l0b)
        tid = self._tid(poc)
        if tid == 0:
            return False, 0, dict(none, l0=poc - self.gop)
        low = poc & -poc
        return False, tid, dict(none, l0=poc - low, l1=poc + low)

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
    """Count the analysis records whose qp, chroma qps or reference frames
    differ from the structure's."""
    bad = 0
    for r in records:
        q = structure.slice_qp(qp, r["poc"])
        q = r["qp"] if q is None else q
        if ((r["qp"], *r["qps"]) != (q, *qp_triplet(q, bd, iqt))
                or {k: r[k] for k in REFS} != structure.frame(r["poc"])[2]):
            bad += 1
    return bad


def decode(streams):
    """The frozen decoder's frames of the concatenated streams, in decoding
    order, or None where it refuses them."""
    try:
        return BaselineIntraDecoder().decode(b"".join(streams))
    except DecodeError:
        return None


def decode_errors(frames, recons):
    """Count the reconstructions that `frames` (decode's, None for a
    refused stream) do not give, in decoding order (all of them when the
    stream was refused)."""
    if frames is None:
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


def analyzer_readings(samples, src, picture, qp, bd, iqt, structure,
                      reference, *, want, device, params):
    """mv_off and decisions_off over the sampled analysis records.

    src(i) gives the padded source (y, u, v) of display index i, picture(i)
    the picture the engine takes as reference i (the source, or the frozen
    decoder's picture), reference the engine module's plain reference.
    The reference analyses at the structure's qp (the record's under rate
    control) against the structure's references.  An empty sample, where
    the traffic asks for `want` frames, reads `want` MV entries off."""
    if not samples:
        return want, 0.0
    mv_bad, ms_bad, ms_n = 0, 0, 0
    for r in samples:
        poc = r["poc"]
        q = structure.slice_qp(qp, poc)
        q = r["qp"] if q is None else q
        refs = {k: picture(i) for k, i in structure.frame(poc)[2].items()
                if i is not None}
        ref = reference(src(poc), refs, q, qp_triplet(q, bd, iqt), bd=bd,
                        device=device, params=params)
        a, b, n = decisions(ref, r["result"])
        mv_bad, ms_bad, ms_n = mv_bad + a, ms_bad + b, ms_n + n
    return mv_bad, ms_bad / max(ms_n, 1)
