"""The port's numpy engine (analysis="numpy", the JAX package's default):
its streams equal the JAX package's numpy engine byte for byte, at a fixed
qp and under ABR and CRF, for Baseline AI, LD-P and RA GOP16 and Main AI,
and it touches no torch op."""
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


GOPS = {"ai": (dict(keyint=1), 3), "ldp": (dict(keyint=0), 5),
        "ra": (dict(keyint=0, bframes=15), 17),
        "main_ai": (dict(keyint=1, profile=1), 2)}
RC = {"cq": {}, "abr": dict(rc_type="abr", bitrate_kbps=120.0),
      "crf": dict(rc_type="crf", crf=30)}
CASES = [(g, r) for g in GOPS for r in RC
         if not (g == "main_ai" and r != "cq")]


@pytest.mark.parametrize("gop,rc", CASES)
def test_numpy_engine_stream_equals_jax(gop, rc):
    """Same bytes as the JAX package's numpy engine; the stream decodes
    to the port's reconstructions; every frame went through the engine
    (analysis_calls)."""
    kw, n = GOPS[gop]
    if gop == "ra" and rc == "crf":
        n = 9                 # the truncated sub-GOP (flush) route
    kw = dict(w=64, h=64, qp=32, **kw, **RC[rc])
    frames = _frames(n)
    ref = jax_api.GopEncoder(JaxParams(**kw), analysis="numpy")
    enc = torch_api.GopEncoder(EncoderParams(**kw), analysis="numpy",
                               device="cpu")
    bs_ref = [bs for bs, _r, _p in ref.encode_stream(iter(frames))]
    out = list(enc.encode_stream(iter(frames)))
    assert [bs for bs, _r, _p in out] == bs_ref
    assert enc.analysis_calls == n
    if rc != "cq":
        assert enc.rc.__dict__ == ref.rc.__dict__
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
    assert len(dec) == n
    for f, (_bs, rec, poc) in zip(dec, out):        # coding order
        assert np.array_equal(f.y, rec[0]), f"display {poc}"


def test_numpy_engine_runs_no_torch_op(monkeypatch):
    """The numpy engine never reaches a torch analysis (they are patched
    to raise) and prewarm is a no-op for it."""
    def refuse(*a, **k):
        raise AssertionError("a torch analysis was reached")

    for name in ("analyze_frame_torch", "analyze_frame_main_torch",
                 "analyze_frame_inter_torch", "dispatch_main_torch",
                 "DeviceAnalyzer"):
        monkeypatch.setattr(torch_api, name, refuse)
    enc = torch_api.GopEncoder(EncoderParams(w=64, h=64, qp=32, keyint=0),
                               analysis="numpy", device="cpu")
    assert enc.prewarm() == 0.0
    out = list(enc.encode_stream(iter(_frames(3))))
    assert len(out) == 3 and enc.analysis_calls == 3
    assert enc._dev is None


def test_me_engine_is_not_ported():
    """me_engine is ported (test_torch_me_engine.py): None, "numpy", "jax"
    and "pallas" construct; an unknown name is refused, as an unknown coder
    is."""
    for me_engine in (None, "numpy", "jax", "pallas"):
        torch_api.Encoder(EncoderParams(w=64, h=64), analysis="numpy",
                          me_engine=me_engine, device="cpu")
    with pytest.raises(ValueError, match="me_engine"):
        torch_api.Encoder(EncoderParams(w=64, h=64), analysis="numpy",
                          me_engine="cuda", device="cpu")
