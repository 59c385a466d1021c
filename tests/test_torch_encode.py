"""End to end on the CPU: the torch port's streams equal the JAX engine's
byte for byte (LD-P and RA GOP16), decode bit-exactly, and every coded
frame was analysed by the port."""
import numpy as np
import pytest
import torch

from test_inter_jax import synth
from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import analysis_np as port_analysis_np
from xeve_tpu_torch.enc import device_analyzer as port_device_analyzer
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)


def _ra_frames(n, w=128, h=64):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _assert_decodes(bs, recs):
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == len(recs)
    for f in dec:
        assert np.array_equal(f.y, recs[f.poc][0]), f"poc {f.poc}"
        assert np.array_equal(f.u, recs[f.poc][1]), f"poc {f.poc}"


def test_ldp_stream_equals_jax_engine():
    frames = synth(4, 128, 64)
    p = dict(w=128, h=64, qp=30, keyint=0)
    ref = jax_api.Encoder(JaxParams(**p), analysis="jax")
    enc = torch_api.Encoder(EncoderParams(**p), device="cpu")
    bs_ref = [bs for bs, _rec, _poc in ref.encode_stream(iter(frames))]
    out = list(enc.encode_stream(iter(frames)))
    assert [bs for bs, _rec, _poc in out] == bs_ref
    assert enc.analysis_calls == len(frames)
    _assert_decodes(b"".join(bs for bs, _r, _p in out),
                    {poc: rec for _bs, rec, poc in out})


def test_ra_stream_equals_jax_engine():
    frames = _ra_frames(17)
    p = dict(w=128, h=64, qp=32, keyint=0, bframes=15)
    ref = jax_api.GopEncoder(JaxParams(**p), analysis="jax")
    enc = torch_api.GopEncoder(EncoderParams(**p), device="cpu")
    bs_ref = [bs for bs, _rec, _poc in ref.encode_stream(iter(frames))]
    out = list(enc.encode_stream(iter(frames)))
    assert len(out) == 17
    assert [bs for bs, _rec, _poc in out] == bs_ref
    assert enc.analysis_calls == 17
    _assert_decodes(b"".join(bs for bs, _r, _p in out),
                    {poc: rec for _bs, rec, poc in out})


def test_intra_frames_use_port_analysis(monkeypatch):
    """I slices go through the torch intra analysis, never the numpy
    oracle (the port's copy is reachable only from the device analyzer's
    host fallback)."""
    def refuse(*a, **k):
        raise AssertionError("numpy intra analysis reached")

    calls = []
    real = torch_api.analyze_frame_torch

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_analysis_np, "analyze_frame", refuse)
    monkeypatch.setattr(port_device_analyzer, "analyze_frame", refuse)
    monkeypatch.setattr(torch_api, "analyze_frame_torch", counted)
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=1),
                            device="cpu")
    for f in _ra_frames(2, 64, 64):
        enc.encode_frame(*f)
    assert enc.analysis_calls == 2 and len(calls) == 2


@pytest.mark.parametrize("kw", [
    dict(rc_type="abr", bitrate_kbps=500.0),
    dict(profile=1, tool_dra=1),
])
def test_unported_configurations_raise(kw):
    """Rate control and encoder-side DRA, refused before the port had them,
    now construct, encode and decode (test_torch_rc.py and test_torch_dra.py
    hold them to the JAX package)."""
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, **kw), device="cpu")
    out = list(enc.encode_stream(iter(_ra_frames(2, 64, 64))))
    assert len(out) == 2 and enc.analysis_calls == 2
    assert len(BaselineIntraDecoder().decode(
        b"".join(bs for bs, _r, _p in out))) == 2


def test_unported_entry_points_raise():
    """encode_frames and encode_stream_meshed, refused before the port had
    them, now encode, and their streams decode to their reconstructions
    (test_torch_batch.py and test_torch_mesh.py hold them to the JAX
    package)."""
    from xeve_tpu_torch.parallel.mesh import make_mesh
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, keyint=1),
                            device="cpu")
    frames = _ra_frames(3, 64, 64)
    out = enc.encode_frames(frames, batch=2)
    _assert_decodes(b"".join(bs for bs, _r in out),
                    {i: rec for i, (_bs, rec) in enumerate(out)})
    enc = torch_api.GopEncoder(EncoderParams(w=64, h=64, bframes=15),
                               analysis="device", device="cpu")
    out = list(enc.encode_stream_meshed(iter(frames),
                                        mesh=make_mesh(2, "cpu")))
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
    assert len(out) == len(dec) == 3
    for f, (_bs, rec, _poc) in zip(dec, out):         # coding order
        assert np.array_equal(f.y, rec[0]) and np.array_equal(f.u, rec[1])


def test_unported_coders_raise():
    """coder="numpy" is the numpy FramePass oracle (the JAX package's name
    for it) and encodes; any other name, "python" included, is refused."""
    enc = torch_api.Encoder(EncoderParams(w=64, h=64), coder="numpy",
                            device="cpu")
    assert len(enc.encode_frame(*_ra_frames(1, 64, 64)[0])[0]) > 0
    with pytest.raises(ValueError, match="coding pass"):
        torch_api.Encoder(EncoderParams(w=64, h=64), coder="python",
                          device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_api.Encoder(EncoderParams(w=64, h=64))
