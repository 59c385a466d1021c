"""The port's batched all-intra route: BatchAnalyzer against the JAX
package's BatchAnalyzer and the port's single-frame analysis, and
Encoder.encode_frames streams byte-equal to the JAX package's on its
three engines, with what the route does under Main, rate control and
DRA pinned to the JAX package's behaviour."""
import os

import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.constants import chroma_qp_dynamic
from xeve_tpu.enc import analysis_inter_np as jax_inter_np
from xeve_tpu.enc.analysis_jax import BatchAnalyzer as JaxBatchAnalyzer
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder, DecodeError
from xeve_tpu_torch.enc.analysis_torch import BatchAnalyzer, \
    analyze_frame_torch
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_me_engine(monkeypatch):
    """A JAX encoder with analysis="jax" sets the JAX package's
    process-global ME_ENGINE; put it back after each test."""
    monkeypatch.setattr(jax_inter_np, "ME_ENGINE", jax_inter_np.ME_ENGINE)


def _fixture_frames():
    """Three 96x80 frames: s96 frames 0-1 and s96b frame 2."""
    out = []
    for name, i in (("s96", 0), ("s96", 1), ("s96b", 2)):
        y, u, v = load_yuv8(os.path.join(DATA, f"{name}.yuv"), 96, 80, i)
        out.append(tuple(np.asarray(p << 2, np.int16) for p in (y, u, v)))
    return out


def _frames(n, w, h):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


@pytest.mark.parametrize("qp", [22, 27, 37])
def test_batch_analyzer_equals_jax_and_single_frame(qp):
    """Modes and splits equal the JAX BatchAnalyzer's (leaf costs to rtol
    1e-5: the f32 products above 2^24 may sum in another order) and equal
    the port's single-frame analysis exactly, costs included."""
    frames = _fixture_frames()
    qp_y, qp_c = qp + 12, chroma_qp_dynamic(qp) + 12
    res = BatchAnalyzer(96, 80, qp, qp_y, qp_c, qp_c,
                        device="cpu").analyze(frames)
    ref = JaxBatchAnalyzer(96, 80, qp, qp_y, qp_c, qp_c).analyze(frames)
    assert len(res) == len(ref) == 3
    for f, a, b in zip(frames, res, ref):
        one = analyze_frame_torch(*f, qp, qp_y, qp_c, qp_c, 10,
                                  device="cpu")
        assert sorted(a.mode) == sorted(b.mode) == list(range(2, 7))
        for lg in b.mode:
            assert np.array_equal(a.mode[lg], b.mode[lg]), lg
            assert np.array_equal(a.split[lg], b.split[lg]), lg
            np.testing.assert_allclose(a.leaf_cost[lg], b.leaf_cost[lg],
                                       rtol=1e-5)
            assert np.array_equal(a.mode[lg], one.mode[lg]), lg
            assert np.array_equal(a.split[lg], one.split[lg]), lg
            assert np.array_equal(a.leaf_cost[lg], one.leaf_cost[lg]), lg


def test_batch_analyzer_one_upload_one_download(monkeypatch):
    """The batch crosses to the device as one int16 array and back as one
    (B, .) f32 array."""
    from xeve_tpu_torch.enc import analysis_torch
    seen = []
    real = analysis_torch.to_device

    def spy(a, dtype, device):
        seen.append((a.shape, a.dtype, dtype))
        return real(a, dtype, device)

    monkeypatch.setattr(analysis_torch, "to_device", spy)
    ba = BatchAnalyzer(96, 80, 32, 44, 41, 41, device="cpu")
    out = ba._run(real(np.zeros((2, ba.n_y + 2 * ba.n_c), np.int16),
                       torch.int16, ba.device))
    n = sum(2 * (80 >> lg) * (96 >> lg) for lg in range(2, 7))
    assert out.shape == (2, n) and out.dtype == torch.float32
    ba.analyze(_fixture_frames())
    assert seen == [((3, 96 * 80 + 2 * 48 * 40), np.int16, torch.int16)]


@pytest.mark.parametrize("engine", ["jax", "numpy", "device"])
@pytest.mark.parametrize("w,h,n,batch", [(64, 64, 5, 2), (96, 80, 3, 4),
                                         (96, 80, 7, 3)])
def test_encode_frames_equals_jax(engine, w, h, n, batch):
    """Byte-equal to the JAX package's encode_frames on the same engine,
    the last chunk ragged; the stream decodes to the returned recon."""
    kw = dict(w=w, h=h, qp=32, keyint=1)
    frames = _frames(n, w, h)
    enc = torch_api.Encoder(EncoderParams(**kw), analysis=engine,
                            device="cpu")
    out = enc.encode_frames(frames, batch=batch)
    ref = jax_api.Encoder(JaxParams(**kw), analysis=engine) \
        .encode_frames(frames, batch=batch)
    assert [bs for bs, _r in out] == [bs for bs, _r in ref]
    assert enc.analysis_calls == n and enc.pic_cnt == n
    assert (enc._batch_analyzer is not None) == (engine == "jax")
    assert enc._dev is None and enc.dpb == []
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r in out))
    assert len(dec) == n
    for f, (_bs, rec) in zip(dec, out):
        for a, b in zip((f.y, f.u, f.v), rec):
            assert np.array_equal(a, b), f"poc {f.poc}"


def test_encode_frames_jax_engine_uses_batch_analyzer(monkeypatch):
    """analysis="jax" analyses each chunk with one BatchAnalyzer call and
    never with the numpy oracle."""
    def refuse(*a, **k):
        raise AssertionError("numpy analyze_frame reached")

    calls = []
    real = BatchAnalyzer.analyze
    monkeypatch.setattr(torch_api, "analyze_frame", refuse)
    monkeypatch.setattr(BatchAnalyzer, "analyze",
                        lambda self, ch: calls.append(len(ch))
                        or real(self, ch))
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=1),
                            device="cpu")
    assert len(enc.encode_frames(_frames(5, 64, 64), batch=2)) == 5
    assert calls == [2, 2, 1]


def test_encode_frames_producer_error_reaches_caller(monkeypatch):
    """An exception in the analysis thread is raised to the caller (the
    call must fail, not wait on its queue)."""
    def broken(self, chunk):
        raise RuntimeError("analysis failed")

    monkeypatch.setattr(BatchAnalyzer, "analyze", broken)
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=1),
                            device="cpu")
    with pytest.raises(RuntimeError, match="analysis failed"):
        enc.encode_frames(_frames(3, 64, 64), batch=2)


@pytest.mark.parametrize("engine", ["jax", "numpy"])
def test_encode_frames_main_profile_as_reference(engine):
    """The JAX package's route codes Baseline I slices whatever the
    profile: under Main (DRA too) the stream carries a Main SPS over
    Baseline slices, and the decoder refuses it.  The port reproduces the
    bytes and the refusal (ROADMAP §3)."""
    frames = _frames(2, 64, 64)
    for kw in (dict(profile=1), dict(profile=1, tool_dra=1)):
        kw = dict(w=64, h=64, qp=32, keyint=1, **kw)
        out = torch_api.Encoder(EncoderParams(**kw), analysis=engine,
                                device="cpu").encode_frames(frames)
        ref = jax_api.Encoder(JaxParams(**kw), analysis=engine) \
            .encode_frames(frames)
        assert [bs for bs, _r in out] == [bs for bs, _r in ref]
        with pytest.raises(DecodeError):
            BaselineIntraDecoder().decode(b"".join(bs for bs, _r in out))


@pytest.mark.parametrize("rc", [dict(rc_type="abr", bitrate_kbps=120.0),
                                dict(rc_type="crf", crf=30)])
def test_encode_frames_ignores_rate_control(rc):
    """The route codes at the fixed p.qp and feeds no rate model: under ABR
    and CRF its stream equals the JAX package's and the fixed-qp one."""
    frames = _frames(3, 64, 64)
    base = dict(w=64, h=64, qp=32, keyint=1)
    enc = torch_api.Encoder(EncoderParams(**base, **rc), device="cpu")
    out = [bs for bs, _r in enc.encode_frames(frames, batch=2)]
    ref = [bs for bs, _r in jax_api.Encoder(JaxParams(**base, **rc),
                                            analysis="jax")
           .encode_frames(frames, batch=2)]
    cq = [bs for bs, _r in torch_api.Encoder(EncoderParams(**base),
                                             device="cpu")
          .encode_frames(frames, batch=2)]
    assert out == ref == cq
    assert enc.rc is not None and enc.rc.__dict__ == \
        torch_api.Encoder(EncoderParams(**base, **rc),
                          device="cpu").rc.__dict__


@pytest.mark.cuda
def test_batch_analyzer_on_card_equals_single_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _fixture_frames()
    qp_y, qp_c = 44, chroma_qp_dynamic(32) + 12
    res = BatchAnalyzer(96, 80, 32, qp_y, qp_c, qp_c,
                        device="cuda").analyze(frames)
    for f, a in zip(frames, res):
        one = analyze_frame_torch(*f, 32, qp_y, qp_c, qp_c, 10,
                                  device="cuda")
        for lg in one.mode:
            assert np.array_equal(a.mode[lg], one.mode[lg])
            assert np.array_equal(a.split[lg], one.split[lg])
