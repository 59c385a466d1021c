"""Checkpoint/resume in the torch port (its copy of xeve_tpu/state.py):
stop an encode mid-stream, restore into a fresh encoder, and the
concatenated output equals the unbroken encode byte for byte — twins of
test_checkpoint.py on the numpy engine, LD and RA resume on the "jax"
engine, and the device engine's resume held to what the JAX package does
(save_state does not carry the device analyzer's frame ring)."""
import pickle

import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu import state as jax_state
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch import state as torch_state
from xeve_tpu_torch.api import Encoder, GopEncoder
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams
from xeve_tpu_torch.state import load_state, save_state

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)


def _frames(n, w=64, h=64):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _push_all(enc, frames, ra):
    bs = b""
    for f in frames:
        if ra:
            bs += b"".join(o[0] for o in enc.push_frame(*f))
        else:
            bs += enc.encode_frame(*f)[0]
    return bs


def _make(cls, p, engine):
    return cls(p, analysis=engine, coder="native", device="cpu")


def _run(cls, p, frames, ra=False, engine="numpy"):
    enc = _make(cls, p, engine)
    bs = _push_all(enc, frames, ra)
    if ra:
        bs += b"".join(o[0] for o in enc.flush())
    return bs


def _run_split(cls, p, frames, cut, ra=False, engine="numpy"):
    enc = _make(cls, p, engine)
    bs = _push_all(enc, frames[:cut], ra)
    blob = save_state(enc)
    enc2 = _make(cls, p, engine)
    load_state(enc2, blob)
    bs += _push_all(enc2, frames[cut:], ra)
    if ra:
        bs += b"".join(o[0] for o in enc2.flush())
    return bs


@pytest.mark.parametrize("engine", ["numpy", "jax"])
def test_resume_ld_bit_exact(engine):
    frames = _frames(8)
    p = dict(w=64, h=64, qp=30, keyint=0, bframes=0)
    assert _run(Encoder, EncoderParams(**p), frames, engine=engine) == \
        _run_split(Encoder, EncoderParams(**p), frames, 4, engine=engine)


def test_resume_ld_rc_bit_exact():
    """The rate model's state (adaptive k, budget, VBV) survives."""
    frames = _frames(8)
    p = dict(w=64, h=64, keyint=0, bframes=0, rc_type="abr",
             bitrate_kbps=300, fps=30)
    whole = _run(Encoder, EncoderParams(**p), frames)
    assert whole == _run_split(Encoder, EncoderParams(**p), frames, 5)
    # and the checkpointed encode is the JAX package's
    ref = jax_api.Encoder(JaxParams(**p), analysis="numpy")
    assert whole == b"".join(ref.encode_frame(*f)[0] for f in frames)


@pytest.mark.parametrize("engine,cuts", [("numpy", (8, 17)), ("jax", (17,))])
def test_resume_ra_bit_exact(engine, cuts):
    """Cut inside the GOP reorder buffer: the buffered display frames and
    derivation state survive the checkpoint."""
    frames = _frames(18)
    p = dict(w=64, h=64, qp=30, keyint=0, bframes=15)
    whole = _run(GopEncoder, EncoderParams(**p), frames, ra=True,
                 engine=engine)
    for cut in cuts:
        assert whole == _run_split(GopEncoder, EncoderParams(**p), frames,
                                   cut, ra=True, engine=engine), f"cut {cut}"


def test_resume_stream_decodes():
    frames = _frames(8)
    p = EncoderParams(w=64, h=64, qp=30, keyint=0, bframes=0, aq_mode=1)
    bs = _run_split(Encoder, p, frames, 5)
    assert len(BaselineIntraDecoder().decode(bs)) == 8


def test_checkpoint_blob_equals_jax():
    """save_state of the port and of the JAX package after the same
    frames hold the same state (parameters, counters, rate model, DPB)."""
    frames = _frames(3)
    p = dict(w=64, h=64, keyint=0, rc_type="abr", bitrate_kbps=300)
    enc = Encoder(EncoderParams(**p), analysis="numpy", device="cpu")
    ref = jax_api.Encoder(JaxParams(**p), analysis="numpy")
    for f in frames:
        enc.encode_frame(*f)
        ref.encode_frame(*f)
    a = pickle.loads(save_state(enc))
    b = pickle.loads(jax_state.save_state(ref))
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "dpb":
            assert len(a[k]) == len(b[k])
            for pa, pb in zip(a[k], b[k]):
                assert sorted(pa) == sorted(pb)
                for f in pa:
                    assert np.array_equal(pa[f], pb[f]), f
        elif k == "prev_orig_y":
            assert np.array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


# (label, class, parameters, frames, cut, push/flush)
DEVICE_CASES = [
    ("ld", "Encoder", dict(keyint=0), 6, 3, False),
    ("ra_mid_subgop", "GopEncoder", dict(keyint=0, bframes=15), 20, 8, True),
    ("ra_at_subgop", "GopEncoder", dict(keyint=0, bframes=15), 20, 17, True),
    ("ai", "Encoder", dict(keyint=1), 4, 2, False),
]


def _resume_outcome(mod, P, state, cls, kw, n, cut, ra, **ekw):
    """Bytes of a split encode on the device engine, or the KeyError the
    resumed encoder raised, as ("KeyError", args)."""
    frames = _frames(n)

    def push(enc, fs):
        out = b""
        for f in fs:
            out += b"".join(o[0] for o in enc.push_frame(*f)) if ra \
                else enc.encode_frame(*f)[0]
        return out

    p = dict(w=64, h=64, qp=30, **kw)
    enc = getattr(mod, cls)(P(**p), analysis="device", **ekw)
    bs = push(enc, frames[:cut])
    enc2 = getattr(mod, cls)(P(**p), analysis="device", **ekw)
    state.load_state(enc2, state.save_state(enc))
    try:
        bs += push(enc2, frames[cut:])
        if ra:
            bs += b"".join(o[0] for o in enc2.flush())
    except KeyError as e:
        return "KeyError", e.args
    return bs


@pytest.mark.parametrize("label,cls,kw,n,cut,ra", DEVICE_CASES)
def test_device_engine_resume_matches_jax(label, cls, kw, n, cut, ra):
    """The checkpoint does not carry the device analyzer's frame ring.  A
    resumed device-engine encode does what the JAX package's does: where a
    dispatch needs a reference frame from before the cut it raises the
    same KeyError (LD-P; RA inside a sub-GOP), elsewhere it gives the same
    bytes (all-intra; RA cut at a sub-GOP boundary)."""
    got = _resume_outcome(torch_api, EncoderParams, torch_state, cls, kw, n,
                          cut, ra, device="cpu")
    ref = _resume_outcome(jax_api, JaxParams, jax_state, cls, kw, n, cut, ra)
    assert got == ref
    assert isinstance(ref, tuple) == (label in ("ld", "ra_mid_subgop"))
