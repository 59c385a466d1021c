"""Encoder checkpoint / resume (SURVEY.md §5.4).

The reference has no checkpointing; its natural resume point is an IDR
boundary (xeve_enc.c:1975 re-emits SPS/PPS).  For long production encodes
the TPU build checkpoints the FULL mid-stream state so an encode can be
stopped (preemption) and resumed bit-exactly at any frame boundary:

  - DPB (reconstructed reference planes + motion maps + marking state)
  - POC counters and the decoder-derivation mirror (PocState)
  - rate-control model (adaptive k, budget, VBV fullness)
  - RA GOP reorder buffer and AQ/complexity carry-over

Resume contract (asserted in tests/test_checkpoint.py): prefix bitstream
+ resumed bitstream == unbroken encode of the same input, byte for byte.
"""
from __future__ import annotations

import io
import pickle

import numpy as np

_FORMAT = 1


def save_state(enc) -> bytes:
    """Serialize the full mid-stream encoder state to bytes."""
    rc = None
    if enc.rc is not None:
        rc = dict(enc.rc.__dict__)
    st = {
        "format": _FORMAT,
        "params": dict(enc.p.__dict__),
        "pic_cnt": enc.pic_cnt,
        "poc": enc.poc,
        "last_intra_poc": enc.last_intra_poc,
        "poc_state": dict(enc._poc_state.__dict__),
        "rc": rc,
        "last_qp": getattr(enc, "_last_qp", None),
        "prev_orig_y": None if enc._prev_orig_y is None
        else np.asarray(enc._prev_orig_y),
        "gop_base": enc._gop_base,
        "first_done": enc._first_done,
        "gop_in": [tuple(np.asarray(p) for p in f) for f in enc._gop_in],
        "dpb": [
            {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in pic.items()}
            for pic in enc.dpb
        ],
    }
    buf = io.BytesIO()
    pickle.dump(st, buf, protocol=4)
    return buf.getvalue()


def load_state(enc, blob: bytes) -> None:
    """Restore a checkpoint into a freshly-constructed encoder.  The
    encoder must have been created with the same EncoderParams."""
    st = pickle.loads(blob)
    assert st["format"] == _FORMAT, "incompatible checkpoint format"
    for k, v in st["params"].items():
        cur = getattr(enc.p, k, None)
        assert cur == v, f"checkpoint param mismatch: {k}={v} vs {cur}"
    enc.pic_cnt = st["pic_cnt"]
    enc.poc = st["poc"]
    enc.last_intra_poc = st["last_intra_poc"]
    for k, v in st["poc_state"].items():
        setattr(enc._poc_state, k, v)
    if st["rc"] is not None:
        assert enc.rc is not None, "checkpoint carries RC state"
        for k, v in st["rc"].items():
            setattr(enc.rc, k, v)
    if st["last_qp"] is not None:
        enc._last_qp = st["last_qp"]
    enc._prev_orig_y = st["prev_orig_y"]
    enc._gop_base = st["gop_base"]
    enc._first_done = st["first_done"]
    enc._gop_in = [tuple(p for p in f) for f in st["gop_in"]]
    enc.dpb = st["dpb"]
