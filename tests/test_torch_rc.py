"""Rate control in the torch port (enc/rc and the api's RC routes) against
the JAX package on the CPU.

ABR and CRF streams are byte-equal to the JAX package's for AI, LD-P and
RA GOP16 on the "jax" and device engines (the numpy engine's are in
test_torch_numpy_engine.py).  On the device engine the I/P/B complexity
is the packed `rc_cost`, an f32 sum that matches XLA's only to rel 1e-5
(test_torch_device_analyzer.py); the fixtures here show no qp flip, so
they are held byte-equal too.  The lookahead twin of test_rc_lookahead.py
runs on the port's device engine: a hard scene cut becomes a decodable
non-IDR I slice, the VBV never overflows and ABR lands near its target."""
import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.constants import SLICE_I
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc.rc import RateControl
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
        "ra": (dict(keyint=0, bframes=15), 17)}
RC = {"abr": dict(rc_type="abr", bitrate_kbps=120.0),
      "crf": dict(rc_type="crf", crf=30)}


@pytest.mark.parametrize("rc", list(RC))
@pytest.mark.parametrize("gop", list(GOPS))
@pytest.mark.parametrize("engine", ["jax", "device"])
def test_rc_stream_equals_jax(engine, gop, rc):
    """The port's RC stream is the JAX package's, frame for frame, and it
    decodes to the port's reconstructions."""
    kw, n = GOPS[gop]
    if gop == "ra" and rc == "crf":
        n = 9                 # the truncated sub-GOP (flush) route
    kw = dict(w=64, h=64, qp=32, **kw, **RC[rc])
    frames = _frames(n)
    ref = jax_api.GopEncoder(JaxParams(**kw), analysis=engine)
    enc = torch_api.GopEncoder(EncoderParams(**kw), analysis=engine,
                               device="cpu")
    bs_ref = [bs for bs, _r, _p in ref.encode_stream(iter(frames))]
    out = list(enc.encode_stream(iter(frames)))
    assert [bs for bs, _r, _p in out] == bs_ref
    assert enc.rc.__dict__ == ref.rc.__dict__
    # coding order on both sides (a truncated first sub-GOP is coded under
    # decoder-derived pocs that are not the display indices)
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
    assert len(dec) == n
    for f, (_bs, rec, poc) in zip(dec, out):
        assert np.array_equal(f.y, rec[0]), f"display {poc}"


def test_config_set_bitrate_mid_stream():
    """config_set("bitrate_kbps") retargets the rate model between frames,
    as in the JAX package: the same bytes after the change."""
    kw = dict(w=64, h=64, keyint=0, rc_type="abr", bitrate_kbps=200.0)
    frames = _frames(6)
    streams = []
    for enc in (jax_api.Encoder(JaxParams(**kw), analysis="numpy"),
                torch_api.Encoder(EncoderParams(**kw), analysis="numpy",
                                  device="cpu")):
        bs = [enc.encode_frame(*f)[0] for f in frames[:3]]
        enc.config_set("bitrate_kbps", 800)
        assert enc.config_get("bitrate_kbps") == 800.0
        assert enc.rc.bpf == pytest.approx(800e3 / 30.0)
        bs += [enc.encode_frame(*f)[0] for f in frames[3:]]
        streams.append(bs)
    assert streams[0] == streams[1]
    # the higher target spends more bits per P frame
    assert sum(map(len, streams[1][3:])) > sum(map(len, streams[1][1:3]))


W, H, FPS = 96, 80, 30.0


def _scene_clip(n, cut):
    """test_rc_lookahead.py's clip: a slow-moving box over a gradient, with
    a hard scene change (inverted, reshuffled texture) at `cut`."""
    rng = np.random.RandomState(7)
    tex_a = rng.randint(0, 40, (H, W)).astype(np.int32)
    tex_b = rng.randint(0, 40, (H, W)).astype(np.int32)
    grad = (np.arange(W)[None, :] * 2 + np.arange(H)[:, None]).astype(np.int32)
    out = []
    for t in range(n):
        if t < cut:
            y = (grad + tex_a) % 256
        else:
            y = (255 - (grad[:, ::-1] + tex_b) % 256)
        y = y.copy()
        x0 = (4 + 2 * t) % (W - 16)
        y[20:36, x0:x0 + 16] = 220
        u = np.full((H // 2, W // 2), 120, np.int32)
        v = np.full((H // 2, W // 2), 130, np.int32)
        out.append(((y << 2).astype(np.int16), (u << 2).astype(np.int16),
                    (v << 2).astype(np.int16)))
    return out


def test_scene_cut_keyframe_and_abr():
    """Twin of test_rc_lookahead.py on the port's device engine (on the
    CPU): the cut is detected and coded as an I slice, the VBV buffer never
    overflows, ABR lands within 15% of the target (or undershoots at the qp
    floor), and the stream with its mid-stream non-IDR I slice decodes."""
    n, cut = 60, 30
    frames = _scene_clip(n, cut)
    kbps = 150.0
    enc = torch_api.Encoder(EncoderParams(w=W, h=H, qp=32, keyint=0,
                                          rc_type="abr", bitrate_kbps=kbps,
                                          fps=FPS),
                            analysis="device", device="cpu")
    total = 0
    slice_types, qps = [], []
    vbv_ok = True
    bs_all = b""
    for bs, _rec, _poc in enc.encode_stream(iter(frames)):
        total += len(bs)
        bs_all += bs
        slice_types.append(enc.last_stat.slice_type)
        qps.append(enc.last_stat.qp)
        if enc.rc.vbv_fullness > enc.rc.vbv_size:
            vbv_ok = False
    assert cut in enc._force_idr
    assert slice_types[cut] == SLICE_I
    assert vbv_ok
    target_bits = kbps * 1000.0 * n / FPS
    err = abs(total * 8 - target_bits) / target_bits
    floor_limited = (total * 8 < target_bits and min(qps) == enc.rc.qp_min)
    assert err < 0.15 or floor_limited, \
        f"ABR error {err:.1%} (got {total * 8} vs {target_bits}, qps " \
        f"{sorted(set(qps))})"
    assert enc._device().dispatches == n and enc._device().failures == 0
    assert len(BaselineIntraDecoder().decode(bs_all)) == n


def test_forecast_tightens_before_the_cut():
    """The port's RateControl: the frame just before the cut must not get
    a LOWER qp than it would with a flat target."""
    rc_flat = RateControl("abr", W, H, FPS, bitrate_kbps=200.0)
    rc_fcst = RateControl("abr", W, H, FPS, bitrate_kbps=200.0)
    for rc in (rc_flat, rc_fcst):
        for i in range(5):
            qp = rc.pick_qp(1, 0, 1000.0)
            rc.update(1, qp, int(200000 / 30), 1000.0)
    q_flat = rc_flat.pick_qp(1, 0, 1000.0)
    q_fcst = rc_fcst.pick_qp(1, 0, 1000.0, fcst_ratio=0.2)
    assert q_fcst > q_flat
