"""End to end on the CPU with the device engine: the torch port's
`analysis="device"` streams equal the JAX device engine's byte for byte
(twins of test_device_analyzer.py and test_frame_parallel.py, plus a
placebo RA stream that codes the second reference of each list, and RA
streams of several sub-GOPs whose C passes overlap), decode bit-exactly,
and every frame went through one fused dispatch."""
import numpy as np
import pytest

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import device_analyzer as dt
from xeve_tpu_torch.params import EncoderParams

W, H = 128, 64


def _frames(n, w=W, h=H):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _encode(mod, cls, p, frames, **kw):
    if mod is jax_api:
        enc = getattr(mod, cls)(JaxParams(**p), analysis="device")
    else:
        enc = getattr(mod, cls)(EncoderParams(**p), analysis="device",
                                device="cpu")
    out = list(enc.encode_stream(iter(frames), **kw))
    return enc, out


def _check(p, frames, cls="Encoder", **kw):
    """Port stream == JAX stream, chunk by chunk; decodes bit-exactly."""
    _, ref = _encode(jax_api, cls, p, frames, **kw)
    enc, out = _encode(torch_api, cls, p, frames, **kw)
    assert [(bs, poc) for bs, _r, poc in out] == \
        [(bs, poc) for bs, _r, poc in ref]
    dev = enc._device()
    assert dev.dispatches == len(frames) and dev.failures == 0
    recs = {poc: rec for _bs, rec, poc in out}
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
    assert len(dec) == len(frames)
    for f in dec:
        for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
            assert np.array_equal(a, b), f"poc {f.poc}"
    return enc


@pytest.mark.parametrize("closed_loop", [0, 1])
def test_ldp_stream_equals_jax_device_engine(closed_loop):
    _check(dict(w=W, h=H, qp=30, keyint=0, closed_loop_ld=closed_loop),
           _frames(5), ahead=2)


def test_ra_stream_equals_jax_device_engine():
    _check(dict(w=W, h=H, qp=30, keyint=0, bframes=15), _frames(18),
           cls="GopEncoder")


@pytest.mark.parametrize("workers", [3, 1])
def test_ra_frame_parallel_equals_jax(workers, monkeypatch):
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", str(workers))
    _check(dict(w=W, h=H, qp=30, keyint=0, bframes=15), _frames(20),
           cls="GopEncoder")


def test_ai_frame_parallel_equals_jax(monkeypatch):
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", "3")
    _check(dict(w=W, h=H, qp=30, keyint=1), _frames(6))


def test_placebo_ra_codes_second_refs(monkeypatch):
    """preset placebo: two refs per list, so dispatches carry the L0r1
    and L1r1 planes."""
    planes = []
    real = dt.DeviceAnalyzer.dispatch

    def record(self, *a, **k):
        hd = real(self, *a, **k)
        planes.append(hd.planes)
        return hd

    monkeypatch.setattr(dt.DeviceAnalyzer, "dispatch", record)
    _check(dict(w=W, h=H, qp=32, keyint=0, bframes=15, preset="placebo"),
           _frames(18), cls="GopEncoder")
    assert any(pl[1] for pl in planes) and any(pl[3] for pl in planes)


@pytest.mark.parametrize("workers,preset", [(4, "medium"), (1, "medium"),
                                            (4, "placebo")])
def test_ra_subgops_overlap_equals_jax(workers, preset, monkeypatch):
    """Three full sub-GOPs and a truncated tail: on more than one worker
    sub-GOP k+1's anchor is handed to a worker before sub-GOP k's last
    emission (once anchor k is done, before k's other 15 emissions), and
    placebo's second refs reach into the previous sub-GOP."""
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", str(workers))
    enc = _check(dict(w=W, h=H, qp=32, keyint=0, bframes=15, preset=preset),
                 _frames(52), cls="GopEncoder")
    if workers > 1:
        assert enc.ahead_tasks >= 2
    else:
        assert enc.ahead_tasks == 0
    assert (enc._gop_base, len(enc._gop_in)) == (51, 1)

