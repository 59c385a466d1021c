"""The port's `me_engine`: the numpy engine's integer ME (and the device
analyzer's host fallback) on ops/me_cuda.integer_me_np, the CUDA kernel on
the card and its plain version on the CPU.  Streams equal the JAX
package's (its "pallas" route runs only on a TPU, so the port's "pallas"
streams are held to the JAX package's "jax" and numpy ME streams: every
integer-ME engine is exact), and the setting belongs to one encoder."""
import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.enc import analysis_inter_np as jax_inter_np
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import analysis_inter_np as port_inter_np
from xeve_tpu_torch.ops import me_cuda
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_me_engine(monkeypatch):
    """The JAX package's me_engine is a process global; put it back after
    each test."""
    monkeypatch.setattr(jax_inter_np, "ME_ENGINE", jax_inter_np.ME_ENGINE)


def _frames(n, w=64, h=64):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


@pytest.fixture
def me_calls(monkeypatch):
    """Counts the calls of the kernel wrapper (the CPU runs its plain
    version, so LAUNCHES does not move here)."""
    calls = []
    real = me_cuda.integer_me

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(me_cuda, "integer_me", counted)
    return calls


GOPS = {"ldp": (dict(keyint=0), 5, "native"),
        "ra": (dict(keyint=0, bframes=15), 17, "native"),
        "ldp_numpy_coder": (dict(keyint=0), 4, "numpy")}
# integer ME searches per stream: one per P frame; RA GOP16 one per
# reference of each of its 16 B frames (the anchor has one)
SEARCHES = {"ldp": 4, "ra": 31, "ldp_numpy_coder": 3}


@pytest.mark.parametrize("me_engine", ["pallas", "jax"])
@pytest.mark.parametrize("gop", list(GOPS))
def test_numpy_engine_stream_equals_jax(gop, me_engine, me_calls):
    """Byte-equal to the JAX package's numpy engine with its ME on JAX
    (me_engine="jax") and on numpy (None); every search went through the
    kernel's wrapper."""
    kw, n, coder = GOPS[gop]
    kw = dict(w=64, h=64, qp=32, **kw)
    frames = _frames(n)
    enc = torch_api.GopEncoder(EncoderParams(**kw), analysis="numpy",
                               coder=coder, me_engine=me_engine,
                               device="cpu")
    out = list(enc.encode_stream(iter(frames)))
    assert len(me_calls) == SEARCHES[gop]
    refs = []
    for jax_me in ("jax", None):
        ref = jax_api.GopEncoder(JaxParams(**kw), analysis="numpy",
                                 coder=coder, me_engine=jax_me)
        if jax_me is None:      # the global keeps the last value set
            jax_inter_np.ME_ENGINE = "numpy"
        assert jax_inter_np.ME_ENGINE == (jax_me or "numpy")
        refs.append([bs for bs, _r, _p in ref.encode_stream(iter(frames))])
    assert [bs for bs, _r, _p in out] == refs[0] == refs[1]
    dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
    assert len(dec) == n


def test_me_engine_is_per_encoder(me_calls):
    """An encoder with me_engine set leaves a second encoder's ME on the
    numpy search; the port has no process-global switch."""
    frames = _frames(3)
    p = dict(w=64, h=64, qp=32, keyint=0)
    kern = torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                             me_engine="pallas", device="cpu")
    plain = torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                              device="cpu")
    assert not hasattr(port_inter_np, "ME_ENGINE")
    assert plain._integer_me is None and kern._integer_me is not None
    a = list(plain.encode_stream(iter(frames)))
    assert me_calls == []
    b = list(kern.encode_stream(iter(frames)))
    assert len(me_calls) == 2
    c = list(torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                               me_engine="numpy", device="cpu")
             .encode_stream(iter(frames)))
    assert len(me_calls) == 2
    assert [o[0] for o in a] == [o[0] for o in b] == [o[0] for o in c]


def test_device_host_fallback_takes_me_engine(me_calls):
    """The device analyzer's host fallback (numpy inter analysis) runs its
    encoder's me_engine, with the numpy oracle's result."""
    frames = _frames(2)
    p = EncoderParams(w=64, h=64, qp=32, keyint=0)
    results = []
    for me_engine in ("pallas", None):
        dev = torch_api.Encoder(p, analysis="device", me_engine=me_engine,
                                device="cpu")._device()
        for poc, f in enumerate(frames):
            dev.put_frame(poc, *f)
        hd = dev.dispatch(1, 32, 44, 41, 41, ref_poc=0)
        results.append(dev._host_fallback(hd))
    assert len(me_calls) == 1
    for lg in results[1].mv:
        assert np.array_equal(results[0].mv[lg], results[1].mv[lg])
        assert np.array_equal(results[0].mode[lg], results[1].mode[lg])


def test_integer_me_np_crops_like_the_oracle():
    """Frames whose size is not a multiple of 16: the 16-aligned region is
    searched, as the numpy oracle does."""
    from xeve_tpu_torch.ops import mc_np
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 1024, (72, 104)).astype(np.int32)
    cur = np.roll(ref, (1, 2), axis=(0, 1))
    ref_pad = mc_np.pad_picture(ref, 80)
    mv, cost = me_cuda.integer_me_np(cur, ref_pad, 80, 8, device="cpu")
    mv0, cost0 = port_inter_np.integer_me(cur, ref_pad, 80, 8)
    assert mv.shape == (4, 6, 2) and mv.dtype == np.int32
    assert cost.dtype == np.int64
    assert np.array_equal(mv, mv0) and np.array_equal(cost, cost0)


def test_numpy_engine_needs_16_aligned_size_as_reference():
    """At a coded size that is not a multiple of 16 (96x72) the numpy
    inter analysis indexes past its 16x16 MV grid, in the JAX package and
    so in the port (ROADMAP §3)."""
    frames = _frames(2, 96, 72)
    p = dict(w=96, h=72, qp=32, keyint=0)
    with pytest.raises(IndexError):
        list(jax_api.Encoder(JaxParams(**p), analysis="numpy")
             .encode_stream(iter(frames)))
    for me_engine in (None, "pallas"):
        with pytest.raises(IndexError):
            list(torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                                   me_engine=me_engine, device="cpu")
                 .encode_stream(iter(frames)))


@pytest.mark.cuda
def test_pallas_engine_launches_kernel_on_card():
    """On the card me_engine="pallas" launches csrc/me_full_search.cu once
    per P frame, and the stream equals the numpy search's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(3)
    p = dict(w=64, h=64, qp=32, keyint=0)
    before = me_cuda.LAUNCHES
    a = list(torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                               me_engine="pallas", device="cuda")
             .encode_stream(iter(frames)))
    assert me_cuda.LAUNCHES == before + 2
    b = list(torch_api.Encoder(EncoderParams(**p), analysis="numpy",
                               device="cuda").encode_stream(iter(frames)))
    assert me_cuda.LAUNCHES == before + 2
    assert [o[0] for o in a] == [o[0] for o in b]
