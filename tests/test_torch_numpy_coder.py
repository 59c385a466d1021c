"""The port's numpy coding-pass oracle (coder="numpy": enc/frame_pass and
enc/main_intra_frame, copies of the JAX package's) on the CPU: its streams
equal the JAX package's coder="numpy" streams and the port's own native C
pass (exact_rd=0, as test_native_inter.py and test_main_intra.py hold the
JAX package's two coders), and they decode bit-exactly."""
import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)


def _frames(n, w=64, h=64):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


# (parameters, frames): FramePass I, P and B slices, MainIntraFramePass
CASES = {
    "ai": (dict(keyint=1), 2),
    "ldp": (dict(keyint=0), 4),
    "ra": (dict(keyint=0, bframes=15), 9),
    "main_ai": (dict(keyint=1, profile=1), 1),
}


def _encode(enc, frames):
    return [(bs, rec) for bs, rec, _p in enc.encode_stream(iter(frames))]


@pytest.mark.parametrize("case", list(CASES))
def test_numpy_coder_equals_native_and_jax(case):
    kw, n = CASES[case]
    kw = dict(w=64, h=64, qp=32, exact_rd=0, **kw)
    frames = _frames(n)
    out = _encode(torch_api.GopEncoder(EncoderParams(**kw), coder="numpy",
                                       device="cpu"), frames)
    native = _encode(torch_api.GopEncoder(EncoderParams(**kw),
                                          device="cpu"), frames)
    ref = _encode(jax_api.GopEncoder(JaxParams(**kw), analysis="jax",
                                     coder="numpy"), frames)
    for other in (native, ref):
        assert [bs for bs, _r in out] == [bs for bs, _r in other]
        for (_b, ra), (_c, rb) in zip(out, other):
            for a, b in zip(ra, rb):
                assert np.array_equal(a, b)
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r in out))
    assert len(dec) == n
    for f, (_bs, rec) in zip(dec, out):          # coding order
        assert np.array_equal(f.y, rec[0])


def test_numpy_coder_reaches_no_c_pass(monkeypatch):
    """coder="numpy" codes Baseline I, P and B slices without the C pass
    (both of its entry points are patched to raise)."""
    def refuse(*a, **k):
        raise AssertionError("the native C pass was reached")

    monkeypatch.setattr(torch_api, "encode_frame_native", refuse)
    monkeypatch.setattr(torch_api, "encode_intra_frame_native", refuse)
    enc = torch_api.GopEncoder(EncoderParams(w=64, h=64, qp=34, keyint=0,
                                             bframes=15),
                               coder="numpy", device="cpu")
    assert len(list(enc.encode_stream(iter(_frames(3))))) == 3


@pytest.mark.parametrize("kw", [dict(aq_mode=1), dict(ref_pics=2)])
def test_numpy_coder_refuses_native_only_tools(kw):
    """AQ (cu_qp_delta) and two reference pictures need the C pass."""
    with pytest.raises(ValueError, match="native"):
        torch_api.Encoder(EncoderParams(w=64, h=64, keyint=0, **kw),
                          coder="numpy", device="cpu")
