"""Encoder-side DRA in the torch port against the JAX package on the CPU.

The forward map applies once per frame on every route of the port.  Its
`encode_frame` and `push_frame`/`flush` streams equal the JAX package's
(which map once there too).  Its `encode_stream` on the Main AI and the
device-engine LD routes equals the JAX package's `encode_frame` loop (on
the device engine, the loop fed the JAX device analyzer's decisions, as
the JAX package's own dispatch-ahead route feeds them): the JAX package's
`encode_stream` maps a frame twice on those routes (xeve_tpu/api.py:938
or :987, then :521), which test_reference_encode_stream_maps_twice
pins."""
import functools

import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.ops import dra_np as jax_dra_np
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)

W, H = 64, 64
MAIN_AI = dict(w=64, h=64, qp=32, keyint=1, profile=1, tool_dra=1)
DEVICE_LD = dict(w=64, h=64, qp=32, keyint=0, profile=1, tool_dra=1)


def _frames(n, w=W, h=H):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _same(a, b):
    """Two lists of (bs, rec) are equal, bytes and planes."""
    assert len(a) == len(b)
    for i, ((ba, ra), (bb, rb)) in enumerate(zip(a, b)):
        assert ba == bb, f"frame {i}: bitstream"
        for pa, pb in zip(ra, rb):
            assert np.array_equal(pa, pb), f"frame {i}: recon"


def _loop(enc, frames):
    return [enc.encode_frame(*f) for f in frames]


def _stream(enc, frames):
    return [(bs, rec) for bs, rec, _poc in enc.encode_stream(iter(frames))]


ROUTES = {"main_ai": (MAIN_AI, "jax", 2), "device_ld": (DEVICE_LD, "device", 4)}


def _jax_device_loop(enc, frames):
    """The JAX package's encode_frame loop on its device engine, each frame
    coded with the decisions its DeviceAnalyzer dispatched for the frame
    mapped once (by _pad_input), as xeve_tpu/api.py:985-1053 does.  (A
    plain encode_frame loop cannot code Main LD-P on that engine: its Main
    I frame never enters the analyzer's frame ring, so the first P frame's
    reference is missing.)"""
    dev = enc._device()
    out = []
    for disp, f in enumerate(frames):
        y, u, v = enc._pad_input(*f)
        qp = enc._slice_qp(enc._slice_type_for(disp))
        dev.put_frame(disp, y, u, v)
        hd = dev.dispatch(disp, qp, *enc._qp_triplet(qp),
                          ref_poc=disp - 1 if disp else None)
        out.append(enc.encode_frame(*f, analysis_pre=dev.collect(hd)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_loop(route):
    """The JAX package's single-map encode_frame loop on a route's
    fixture."""
    kw, engine, n = ROUTES[route]
    enc = jax_api.Encoder(JaxParams(**kw), analysis=engine)
    return (_jax_device_loop if engine == "device" else _loop)(enc,
                                                               _frames(n))


@pytest.mark.parametrize("ki,bf", [(1, 0), (0, 0), (0, 15)])
def test_dra_own_roundtrip(ki, bf):
    """Twin of test_dra.py::test_dra_own_roundtrip on the port (numpy
    engine): the port's decoder returns the display-domain recon the
    encoder returns, and the stream is the JAX package's."""
    n = 17 if bf else 3
    frames = _frames(n)
    kw = dict(w=W, h=H, qp=32, keyint=ki, bframes=bf, profile=1, tool_dra=1)
    enc = torch_api.GopEncoder(EncoderParams(**kw), analysis="numpy",
                               device="cpu")
    bs = b""
    recs = {}
    for out, rec, poc in enc.encode_stream(iter(frames)):
        bs += out
        recs[poc] = rec
    dec = BaselineIntraDecoder()
    for f in dec.decode(bs):
        assert np.array_equal(f.y, recs[f.poc][0][:H, :W])
        assert np.array_equal(f.u, recs[f.poc][1][:H // 2, :W // 2])
        assert np.array_equal(f.v, recs[f.poc][2][:H // 2, :W // 2])
    assert dec.pps.pic_dra_enabled_flag == 1
    ref = jax_api.GopEncoder(JaxParams(**kw), analysis="numpy")
    assert bs == b"".join(b for b, _r, _p in ref.encode_stream(iter(frames)))


def test_encode_frame_equals_jax():
    """Main AI, "jax" engine, one encode_frame per frame: bytes and the
    backward-mapped recon equal the JAX package's."""
    _same(_loop(torch_api.Encoder(EncoderParams(**MAIN_AI), device="cpu"),
                _frames(2)), _jax_loop("main_ai"))


def test_push_frame_flush_equal_jax():
    """Main RA GOP16 through push_frame/flush, a truncated sub-GOP
    included."""
    frames = _frames(9)
    kw = dict(MAIN_AI, keyint=0, bframes=15)
    out = []
    for enc in (torch_api.GopEncoder(EncoderParams(**kw), device="cpu"),
                jax_api.GopEncoder(JaxParams(**kw), analysis="jax")):
        res = []
        for f in frames:
            res += enc.push_frame(*f)
        res += enc.flush()
        out.append([(bs, rec) for bs, rec, _poc in res])
    _same(*out)


def _count_forward(monkeypatch, module):
    """Patch module.apply_dra to count its forward maps."""
    forward = []
    real = module.apply_dra

    def counted(y, u, v, maps, backward=False):
        if not backward:
            forward.append(1)
        return real(y, u, v, maps, backward=backward)

    monkeypatch.setattr(module, "apply_dra", counted)
    return forward


@pytest.mark.parametrize("route", ["main_ai", "device_ld"])
def test_encode_stream_maps_once(route, monkeypatch):
    """The port's dispatch-ahead routes hand the padded, mapped frame to
    the coding pass without mapping it again (one forward map per frame):
    encode_stream equals the JAX package's encode_frame loop (bytes and
    display-domain recon)."""
    kw, engine, n = ROUTES[route]
    expected = _jax_loop(route)
    forward = _count_forward(monkeypatch, torch_api)
    enc = torch_api.Encoder(EncoderParams(**kw), analysis=engine,
                            device="cpu")
    out = _stream(enc, _frames(n))
    _same(out, expected)
    assert len(forward) == n
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r in out))
    for f, (_bs, rec) in zip(dec, out):
        assert np.array_equal(f.y, rec[0]) and np.array_equal(f.v, rec[2])
    if engine == "device":
        assert enc._device().dispatches == n


@pytest.mark.parametrize("route", ["main_ai", "device_ld"])
def test_reference_encode_stream_maps_twice(route, monkeypatch):
    """The reference's fault, pinned: on these routes the JAX package's
    encode_stream applies the forward map twice per frame (its encode_frame
    loop once), and its stream differs from its own encode_frame loop."""
    kw, engine, n = ROUTES[route]
    expected = _jax_loop(route)
    forward = _count_forward(monkeypatch, jax_dra_np)
    stream = _stream(jax_api.Encoder(JaxParams(**kw), analysis=engine),
                     _frames(n))
    assert len(forward) == 2 * n
    assert [bs for bs, _r in stream] != [bs for bs, _r in expected]


def test_backward_mapped_recon_is_display_domain():
    """The recon returned by every entry point is in the display domain:
    close to the original, far from the forward-mapped original."""
    frames = _frames(2)
    enc = torch_api.Encoder(EncoderParams(**MAIN_AI), device="cpu")
    for (y, _u, _v), (_bs, rec) in zip(frames, _stream(enc, frames)):
        assert torch_api.psnr(rec[0], y) > 30.0
        mapped = enc._pad_input(y, _u, _v)[0]
        assert torch_api.psnr(rec[0], y) > torch_api.psnr(rec[0], mapped)
