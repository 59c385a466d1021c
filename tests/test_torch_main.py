"""Main profile in the torch port: the 33-mode EIPD analysis against its JAX
twin (analysis_main_jax) and the numpy oracle, and Main streams byte-equal
to the JAX package's engine of the same name, each decoding bit-exactly
through the port's decoder.

Tolerance: predictions, neighbour arrays and weights are exact integers
and must be bit-identical; modes and splits must be identical; a block's
minimum cost may differ from JAX's by the rounding of the f32 transform
products (above 2^24) on the two CPU backends, held to rtol 1e-5."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_inter_jax import synth
from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.constants import chroma_qp_dynamic
from xeve_tpu.enc import analysis_main_jax
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import analysis_main_torch as amt
from xeve_tpu_torch.enc.analysis_main_np import analyze_frame_main
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _frames(n, w, h):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _qps(qp=32):
    qc = chroma_qp_dynamic(qp, 1) + 12
    return qp, qp + 12, qc, qc


def _frame(w, h, t=1):
    return tuple(np.asarray(p, np.int32) for p in _frames(t + 1, w, h)[t])


# ---------------------------------------------------------------------------
# each function against its JAX twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 4, 8, 16, 32, 64])
def test_ang_weights_equal_jax(s):
    wu, wl = analysis_main_jax._ang_weights(s)
    pu, pl = amt._ang_weights_np(s)
    assert np.array_equal(pu, wu) and np.array_equal(pl, wl)
    W = amt._ang_weights(s, CPU).numpy()
    n = 2 * s + 1
    assert W.shape == (2 * n, 30 * s * s)
    assert np.array_equal(W[:n], wu.reshape(-1, n).T)
    assert np.array_equal(W[n:], wl.reshape(-1, n).T)
    assert amt._ang_weights(s, CPU) is amt._ang_weights(s, CPU)


@pytest.mark.parametrize("s", [2, 4, 8, 16, 32, 64])
def test_neighbours_and_predictions_bit_identical(s):
    """Random 10-bit planes, among them widths that are not a multiple of
    s or of 64 (the real pixels in [wc, w) feed the up row) and a plane
    one block high or wide."""
    rng = np.random.default_rng(s)
    for h, w in ((80, 200), (s, 3 * s + 1), (2 * s + 3, s)):
        plane = rng.integers(0, 1024, (h, w)).astype(np.float32)
        uj, lj = analysis_main_jax._nbr_main_jax(jnp.asarray(plane), s, 10)
        ut, lt = amt._nbr_main_torch(torch.as_tensor(plane), s, 10)
        assert np.array_equal(ut.numpy(), np.asarray(uj)), (h, w)
        assert np.array_equal(lt.numpy(), np.asarray(lj)), (h, w)
        pj = analysis_main_jax._pred_all_modes_main(uj, lj, s, 10)
        pt = amt._pred_all_modes_main(ut, lt, s, 10)
        assert pt.shape == (h // s, w // s, 33, s, s)
        assert np.array_equal(pt.numpy(), np.asarray(pj)), (h, w)


@pytest.mark.parametrize("lg", [2, 3, 4, 5, 6])
def test_level_cost_equals_jax(lg):
    y, u, v = _frame(200, 136)
    prm = amt.level_params_main(*_qps(), 10, lg)
    assert np.array_equal(prm, analysis_main_jax.level_params_main(
        *_qps(), 10, lg))
    mj, cj = analysis_main_jax._level_cost_main(
        *(jnp.asarray(p, jnp.float32) for p in (y, u, v)),
        jnp.asarray(prm), bd=10, lg=lg)
    mt, ct = amt._level_cost_main(
        *(torch.as_tensor(p, dtype=torch.float32) for p in (y, u, v)),
        torch.as_tensor(prm), bd=10, lg=lg)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5)


@pytest.mark.parametrize("w,h", [(128, 64), (96, 80)])
def test_analysis_equals_jax(w, h):
    y, u, v = _frame(w, h)
    aj = analysis_main_jax.analyze_frame_main_jax(y, u, v, *_qps(), 10)
    at = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cpu")
    assert at.eipd_modes
    for lg in range(2, 7):
        assert np.array_equal(at.mode[lg], aj.mode[lg]), lg
        assert np.array_equal(at.split[lg], aj.split[lg]), lg
        np.testing.assert_allclose(at.leaf_cost[lg], aj.leaf_cost[lg],
                                   rtol=1e-5)


def test_analysis_agrees_with_numpy_oracle():
    """The floor of test_main_intra.py's JAX-vs-numpy check."""
    y, u, v = _frame(128, 64)
    a1 = analyze_frame_main(y, u, v, *_qps(), 10)
    a2 = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cpu")
    for lg in range(2, 7):
        assert (a1.mode[lg] == a2.mode[lg]).mean() > 0.97, lg
        assert (a1.split[lg] == a2.split[lg]).mean() > 0.97, lg


def test_dispatch_then_collect_equals_one_shot():
    y, u, v = _frame(96, 80)
    hd = amt.dispatch_main_torch(y, u, v, *_qps(), 10, device="cpu")
    vec, levels, h, w = hd[:4]
    assert isinstance(vec, torch.Tensor) and (h, w) == (80, 96)
    assert levels == [2, 3, 4, 5, 6]
    assert vec.numel() == sum(2 * (80 >> lg) * (96 >> lg) for lg in levels)
    a = amt.collect_main_torch(hd)
    b = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cpu")
    for lg in levels:
        assert np.array_equal(a.mode[lg], b.mode[lg])
        assert np.array_equal(a.split[lg], b.split[lg])


def test_levels_larger_than_the_picture():
    """A 48x40 picture has no block of level 6: its maps stay empty, as in
    the JAX twin."""
    y, u, v = _frame(48, 40)
    hd = amt.dispatch_main_torch(y, u, v, *_qps(), 10, device="cpu")
    assert hd[1] == [2, 3, 4, 5]
    a = amt.collect_main_torch(hd)
    aj = analysis_main_jax.analyze_frame_main_jax(y, u, v, *_qps(), 10)
    for lg in range(2, 7):
        assert a.mode[lg].shape == aj.mode[lg].shape
        assert np.array_equal(a.mode[lg], aj.mode[lg])
        assert np.array_equal(a.split[lg], aj.split[lg])


def test_flat_plane_ties_take_the_first_mode():
    """On a flat mid-grey frame every mode predicts the frame exactly, so
    all 33 costs tie and argmin takes the first (DC), as in JAX."""
    y = np.full((64, 128), 512, np.int32)
    c = np.full((32, 64), 512, np.int32)
    aj = analysis_main_jax.analyze_frame_main_jax(y, c, c, *_qps(), 10)
    at = amt.analyze_frame_main_torch(y, c, c, *_qps(), 10, device="cpu")
    for lg in range(2, 7):
        assert np.array_equal(at.mode[lg], aj.mode[lg])
        assert np.array_equal(at.split[lg], aj.split[lg])
        assert not at.mode[lg].any()


def test_dispatch_makes_no_host_readback(monkeypatch):
    """dispatch_main_torch only enqueues: no tensor is read back to the
    host (a readback would synchronise with the card and serialise the
    dispatch-ahead route)."""
    y, u, v = _frame(96, 80)
    want = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("host readback in dispatch")

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "numpy", "tolist", "__bool__",
                     "__float__", "__int__", "__index__"):
            m.setattr(torch.Tensor, name, refuse)
        hd = amt.dispatch_main_torch(y, u, v, *_qps(), 10, device="cpu")
    got = amt.collect_main_torch(hd)
    for lg in range(2, 7):
        assert np.array_equal(got.mode[lg], want.mode[lg])


def test_analysis_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, u, v = _frame(64, 64, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        amt.dispatch_main_torch(y, u, v, *_qps(), 10, device="cuda")


@pytest.mark.parametrize("engine", ["jax", "device"])
def test_main_prewarm_runs_the_eipd_and_inter_analyses(engine, monkeypatch):
    """Main warms the EIPD intra analysis (and the inter analysis for
    P/B) on either engine, as the JAX package does; the device engine's
    fused analyzer is not created."""
    calls = []
    real = torch_api.analyze_frame_main_torch

    def counted(*a, **k):
        calls.append(k["min_log2"])
        return real(*a, **k)

    monkeypatch.setattr(torch_api, "analyze_frame_main_torch", counted)
    enc = torch_api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=0,
                                          profile=1),
                            analysis=engine, device="cpu")
    assert enc.prewarm() > 0.0
    assert calls == [enc.p.min_cu_log2] and enc._dev is None
    assert enc.analysis_calls == 0


@pytest.mark.cuda
def test_card_analysis_agrees_with_cpu():
    """Card against CPU at 416x240: modes and splits agree on >= 0.99 of
    the blocks of each level (f32 sums may round apart near ties)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    y, u, v = _frame(416, 240)
    ag = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cuda")
    ac = amt.analyze_frame_main_torch(y, u, v, *_qps(), 10, device="cpu")
    for lg in range(2, 7):
        assert (ag.mode[lg] == ac.mode[lg]).mean() >= 0.99, lg
        assert (ag.split[lg] == ac.split[lg]).mean() >= 0.99, lg


# ---------------------------------------------------------------------------
# streams on the CPU, byte-equal to the JAX package's engine of that name
# ---------------------------------------------------------------------------


def _assert_decodes(out):
    """Every frame of a (bs, rec, poc) list decodes bit-exactly."""
    recs = {poc: rec for _bs, rec, poc in out}
    dec = BaselineIntraDecoder()
    frames = dec.decode(b"".join(bs for bs, _r, _p in out))
    assert dec.sps.profile_idc == 1 and dec.sps.tool_eipd == 1
    assert len(frames) == len(out)
    for f in frames:
        for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
            assert np.array_equal(a, b), f"poc {f.poc}"
    return dec


def _stream_pair(cls, p, frames, engine="jax", **kw):
    ref = getattr(jax_api, cls)(JaxParams(**p), analysis=engine)
    enc = getattr(torch_api, cls)(EncoderParams(**p), analysis=engine,
                                  device="cpu")
    want = [bs for bs, _r, _p in ref.encode_stream(iter(frames), **kw)]
    out = list(enc.encode_stream(iter(frames), **kw))
    assert [bs for bs, _r, _p in out] == want
    return enc, out


def test_main_ai_encode_frame_equals_jax_engine():
    frames = _frames(2, 96, 80)
    p = dict(w=96, h=80, qp=30, keyint=1, profile=1, use_pic_sign=True)
    ref = jax_api.Encoder(JaxParams(**p), analysis="jax")
    enc = torch_api.Encoder(EncoderParams(**p), device="cpu")
    out = []
    for f in frames:
        bs, rec = enc.encode_frame(*f)
        assert bs == ref.encode_frame(*f)[0]
        out.append((bs, rec, enc.poc - 1))
    assert enc.p.btt == 1 and enc.analysis_calls == 2
    assert _assert_decodes(out).signatures_checked == 2


def test_main_ai_encode_stream_equals_jax_engine(monkeypatch):
    """The dispatch-ahead route keeps `ahead` + 1 frames in flight: with
    ahead=2 the first collect comes after the third dispatch."""
    events = []
    real_dispatch, real_collect = (torch_api.dispatch_main_torch,
                                   torch_api.collect_main_torch)

    def dispatch(*a, **k):
        events.append("d")
        return real_dispatch(*a, **k)

    def collect(hd):
        events.append("c")
        return real_collect(hd)

    monkeypatch.setattr(torch_api, "dispatch_main_torch", dispatch)
    monkeypatch.setattr(torch_api, "collect_main_torch", collect)
    frames = _frames(4, 128, 64)
    enc, out = _stream_pair("Encoder", dict(w=128, h=64, qp=32, keyint=1,
                                            profile=1), frames, ahead=2)
    assert events == list("dddcdccc")
    assert enc.analysis_calls == 4
    _assert_decodes(out)


def test_main_ldp_stream_equals_jax_engine():
    frames = synth(3, 128, 64)
    enc, out = _stream_pair("Encoder", dict(w=128, h=64, qp=30, keyint=0,
                                            profile=1), frames)
    assert enc.analysis_calls == 3
    _assert_decodes(out)


def test_main_ra_stream_equals_jax_engine():
    """Main RA GOP16, 18 frames: one I (EIPD analysis), one sub-GOP of 16
    B frames through the inter analysis, and a truncated one."""
    frames = _frames(18, 128, 64)
    enc, out = _stream_pair("GopEncoder", dict(w=128, h=64, qp=32, keyint=0,
                                               bframes=15, profile=1),
                            frames)
    assert len(out) == 18 and enc.analysis_calls == 18
    _assert_decodes(out)


def test_main_ra_btt_device_engine_equals_jax_package():
    """Twin of test_btt_encode.py's RA round trip: the fused device
    analyzer with btt=1 on a frame that is not a multiple of 64."""
    frames = _frames(18, 96, 80)
    enc, out = _stream_pair("GopEncoder", dict(w=96, h=80, qp=30, keyint=0,
                                               bframes=15, profile=1, btt=1),
                            frames, engine="device")
    assert enc._device().dispatches == 18 and enc._device().failures == 0
    assert _assert_decodes(out).sps.sps_btt_flag == 1


@pytest.mark.parametrize("keyint", [0, 1])
def test_main_device_engine_equals_jax_package(keyint):
    """The device engine's Main LD-P (its I frame from the fused
    analyzer) and Main AI (the EIPD dispatch-ahead route, no fused
    dispatch) streams."""
    frames = _frames(4 - 2 * keyint, 128, 64)
    enc, out = _stream_pair("Encoder", dict(w=128, h=64, qp=32,
                                            keyint=keyint, profile=1),
                            frames, engine="device")
    if keyint:
        assert enc.analysis_calls == 2 and enc._dev is None
    else:
        assert enc._device().dispatches == 4
    _assert_decodes(out)


def test_main_ai_tiles_equal_jax_engine():
    """2x1 tiles (twin of test_tiles.py's own multi-tile encode): entry
    points in the slice header, same bytes as the JAX package."""
    frames = _frames(1, 176, 144)
    p = dict(w=176, h=144, qp=32, keyint=1, profile=1, tile_columns=2,
             threads=2, use_pic_sign=True)
    ref = jax_api.Encoder(JaxParams(**p), analysis="jax")
    enc = torch_api.Encoder(EncoderParams(**p), device="cpu")
    bs, rec = enc.encode_frame(*frames[0])
    assert bs == ref.encode_frame(*frames[0])[0]
    dec = _assert_decodes([(bs, rec, 0)])
    assert dec.pps.num_tile_columns_minus1 == 1
    assert len(dec.sh.entry_point_offsets) == 1
