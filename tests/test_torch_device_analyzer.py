"""The fused device analyzer in torch (xeve_tpu_torch.enc.device_analyzer)
against its JAX twin (xeve_tpu.enc.device_analyzer) on the CPU.

The packed vector must equal `_fused_jit`'s for every dispatch signature:
the mode/split sections and every MV section bit for bit, and the RC tail
(a f32 sum of the 16x16 leaf costs, whose summation order differs between
the backends) to relative 1e-5.  The host-side copies must equal their
originals, and failure recovery and prewarm must work as in
test_failover.py and api.prewarm."""
import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from tools.gen_test_content import gen_frame
from xeve_tpu.enc import device_analyzer as dj
from xeve_tpu.enc.analysis_jax import level_params
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import device_analyzer as dt
from xeve_tpu_torch.params import EncoderParams

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)

PAD = dt.PAD
QP = 32

# reference frames (indices into the fixture's frames) per signature;
# frame 1 is the current frame
SIGS = {
    "I": dict(),
    "P": dict(ref0=0),
    "P+ref0b": dict(ref0=0, ref0b=3),
    "B": dict(ref0=0, ref1=2, refine=True),
    "B-norefine": dict(ref0=0, ref1=2, refine=False),
    "B+ref0b+ref1b": dict(ref0=0, ref1=2, ref0b=3, ref1b=4, refine=True),
}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    """Five frames (y, u, v) int16 and the bit depth."""
    if name == "s96":
        path = os.path.join(DATA, "s96b.yuv")
        return tuple(tuple((p << 2).astype(np.int16)
                           for p in load_yuv8(path, 96, 80, t))
                     for t in range(5)), 10
    bd = 8 if name == "gen8" else 10
    out = []
    for t in range(5):
        planes = gen_frame(128, 64, t)
        out.append(tuple((p.astype(np.int16) << (bd - 8)) for p in planes))
    return tuple(out), bd


def _min_log2(bd):
    # 8-bit internal needs 4x4 chroma at least: the JAX intra analysis
    # has a negative dequant shift at 2x2 (analysis_jax.py:160), so
    # 8-bit runs with min_log2 3 (preset fast)
    return 2 if bd == 10 else 3


def _params(bd):
    qp_y = QP + 6 * (bd - 8)
    qp_c = qp_y - 1
    prms = np.stack([level_params(QP, qp_y, qp_c, qp_c, bd, lg)
                     for lg in range(_min_log2(bd), 7)])
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    w_c = 2.0 ** (1 / 3.0)
    return prms, np.array([lam, w_c, w_c], np.float32)


def _call(mod, to, fixture, sig):
    frames, bd = _fixture(fixture)
    prms, prm3 = _params(bd)
    spec = SIGS[sig]
    refs = [None if spec.get(k) is None else tuple(to(a) for a in
                                                    frames[spec[k]])
            for k in ("ref0", "ref0b", "ref1", "ref1b")]
    return mod._fused_impl(*(to(a) for a in frames[1]), *refs, to(prms),
                           to(prm3), bd=bd, R=16, pad=PAD,
                           min_log2=_min_log2(bd), max_log2=6,
                           refine=spec.get("refine", False))


@functools.lru_cache(maxsize=None)
def _jax_vec(fixture, sig):
    mod = type("J", (), {"_fused_impl": staticmethod(dj._fused_jit)})
    return np.asarray(_call(mod, jnp.asarray, fixture, sig))


def _rc(vec):
    return float((int(vec[-2]) << 15) | int(vec[-1])) * 65536.0


CASES = [(f, s) for f in ("s96", "gen10") for s in SIGS] + \
    [("gen8", "P"), ("gen8", "B")]


@pytest.mark.parametrize("fixture,sig", CASES)
def test_packed_vector_equals_fused_jit(fixture, sig):
    vj = _jax_vec(fixture, sig)
    vt = _call(dt, torch.as_tensor, fixture, sig)
    assert vt.dtype == torch.int16
    vt = vt.numpy()
    assert vt.shape == vj.shape
    # modes, splits, every MV section: identical
    assert np.array_equal(vt[:-2], vj[:-2])
    assert _rc(vt) == pytest.approx(_rc(vj), rel=1e-5)


def _same_result(a, b):
    # the port's result classes are its own copies: same name and fields
    assert type(a).__name__ == type(b).__name__
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    for name in ("mode", "split", "mv", "mv1", "mv0b", "mv1b", "mvbi"):
        x, y = getattr(a, name, None), getattr(b, name, None)
        assert (x is None) == (y is None), name
        if x is not None:
            assert sorted(x) == sorted(y), name
            for lg in x:
                assert x[lg].dtype == y[lg].dtype, (name, lg)
                assert np.array_equal(x[lg], y[lg]), (name, lg)
    assert a.rc_cost == b.rc_cost


@pytest.mark.parametrize("sig", list(SIGS))
def test_parse_equals_original(sig):
    vec = _jax_vec("s96", sig)
    spec = SIGS[sig]
    kind = "I" if "ref0" not in spec else ("B" if "ref1" in spec else "P")
    planes = tuple(k in spec for k in ("ref0", "ref0b", "ref1", "ref1b")) \
        + (bool(spec.get("refine")),)
    hj = dj._Handle(vec, kind, 80, 96, 2, 6, planes=planes)
    ht = dt._Handle(vec, kind, 80, 96, 2, 6, planes=planes)
    _same_result(dt.DeviceAnalyzer._parse(None, ht, vec),
                 dj.DeviceAnalyzer._parse(None, hj, vec))


@pytest.mark.parametrize("lg", [2, 3, 4, 5, 6])
def test_host_copies_equal_originals(lg):
    assert dt.PAD == dj.PAD and dt.RESEARCH_OFFS == dj.RESEARCH_OFFS
    for a, b in ((7, 2), (-7, 2), (96, 16), (80, 16), (0, 4)):
        assert dt._ceil_div(a, b) == dj._ceil_div(a, b)
    rng = np.random.default_rng(lg)
    mv16c = rng.integers(-100, 101, (6, 9, 2)).astype(np.int32)
    s = 1 << lg
    for h, w in ((96, 144), (80, 96), (64, 128)):
        a = dt._mv_for_level_np(mv16c, lg, h // s, w // s)
        b = dj._mv_for_level_np(mv16c, lg, h // s, w // s)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the gather's call sites at their extreme MVs (offsets at the ends of the
# patch; the JAX one-hot form would zero an out-of-range window)
# ---------------------------------------------------------------------------


def _planes10():
    frames, _bd = _fixture("gen10")
    y, u, v = (np.asarray(p, np.int32) for p in frames[1])
    ry, ru, rv = (np.asarray(p, np.int32) for p in frames[0])
    return y, u, v, ry, ru, rv


@pytest.mark.parametrize("mx,my", [(100, 100), (-100, -100), (100, -100),
                                   (-100, 100)])
def test_research_and_chroma_at_extreme_mvs(mx, my):
    """mv16c beyond the +-92 clamp: the re-search offsets reach [4, 50];
    the researched MVs reach +-96, the chroma offsets [4, 28]."""
    y, u, v, ry, ru, rv = _planes10()
    h, w = y.shape
    mv16c = np.tile(np.array([mx, my], np.int32), (h // 16, w // 16, 1))
    mv16c[0, 0] = [-mx, -my]
    ry_pad = np.pad(ry, PAD, mode="edge")
    ru_pad = np.pad(ru, PAD // 2, mode="edge")
    rv_pad = np.pad(rv, PAD // 2, mode="edge")
    T, J = torch.as_tensor, jnp.asarray
    for lg in (5, 6):
        mt, dY_t = dt._research_level(T(y), T(ry_pad), T(mv16c), lg, 10,
                                      PAD, h, w)
        mj, dY_j = dj._research_level(J(y), J(ry_pad), J(mv16c), lg, 10,
                                      PAD, h, w)
        assert np.array_equal(mt.numpy(), np.asarray(mj))
        assert np.array_equal(dY_t.numpy(), np.asarray(dY_j))
        mv_l = np.broadcast_to(np.sign([mx, my]).astype(np.int32) * 96,
                               mt.shape).copy()
        ct = dt._chroma_ssd_level(T(u), T(v), T(ru_pad), T(rv_pad), T(mv_l),
                                  lg, PAD // 2, h, w)
        cj = dj._chroma_ssd_level(J(u), J(v), J(ru_pad), J(rv_pad), J(mv_l),
                                  lg, PAD // 2, h, w)
        for a, b in zip(ct, cj):
            assert np.array_equal(a.numpy(), np.asarray(b))
    # 8x8 chroma predictions at the extreme chroma MVs of +-100 qpel
    nby, nbx = h // 16, w // 16
    mvc = np.tile(np.array([(mx + 4) >> 3, (my + 4) >> 3], np.int32),
                  (nby, nbx, 1))
    gt = dt._chroma_pred8(T(ru.astype(np.int16)), T(mvc), PAD // 2, nby, nbx)
    gj = dj._chroma_pred8(J(ru.astype(np.int16)), J(mvc), PAD // 2, nby, nbx)
    assert np.array_equal(gt.numpy(), np.asarray(gj))


def test_ref_luma_at_the_coarse_clamp():
    """Content moving 24 pels drives the coarse MVs to the +-23 clamp, so
    the 32x32 extraction offsets reach 2 and 48 of the 80-patch."""
    ref = gen_frame(160, 96, 0)[0].astype(np.int32) << 2
    cur = np.roll(ref, (24, -24), axis=(0, 1))
    h, w = cur.shape
    rt = dt._ref_luma(torch.as_tensor(cur), torch.as_tensor(
        ref.astype(np.int16)), PAD, 10, h, w)
    rj = dj._ref_luma(jnp.asarray(cur), jnp.asarray(ref.astype(np.int16)),
                      PAD, 10, h, w)
    m = rt[5].numpy()
    assert (m == 23).any() and (m == -23).any()
    for a, b in zip(rt, rj):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# DeviceAnalyzer: ring, recovery, prewarm
# ---------------------------------------------------------------------------


def _frames(n, w=96, h=80):
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


class _DeadVec:
    """A device buffer whose readback always fails (a lost device)."""
    def __array__(self, *a, **k):
        raise RuntimeError("device lost")


def _ld_encoder():
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0)
    return torch_api.Encoder(p, analysis="device", coder="native",
                             device="cpu")


def test_collect_survives_device_loss():
    """Twin of test_failover.py: every readback and every re-dispatch
    dies, so the numpy oracle carries every frame."""
    frames = _frames(5)
    enc = _ld_encoder()
    dev = enc._device()
    assert isinstance(dev, dt.DeviceAnalyzer)
    real_dispatch = dt.DeviceAnalyzer.dispatch

    def dead_dispatch(self, *a, **k):
        hd = real_dispatch(self, *a, **k)
        hd.vec = _DeadVec()
        return hd

    dev.dispatch = dead_dispatch.__get__(dev)
    outs = list(enc.encode_stream(iter(frames)))
    assert len(outs) == 5
    assert dev.failures >= 1
    dec = BaselineIntraDecoder().decode(b"".join(o[0] for o in outs))
    assert len(dec) == 5
    for d, (_, rec, _) in zip(dec, outs):
        assert np.array_equal(d.y, rec[0])


def test_redispatch_recovers():
    """Twin of test_failover.py: the first readback fails once; the
    re-dispatch succeeds and the stream equals an undisturbed run."""
    frames = _frames(3)
    ref_bs = b"".join(o[0] for o in _ld_encoder().encode_stream(
        iter(frames)))
    enc = _ld_encoder()
    dev = enc._device()
    real_dispatch = dt.DeviceAnalyzer.dispatch
    state = {"armed": True}

    def flaky_dispatch(self, *a, **k):
        hd = real_dispatch(self, *a, **k)
        if state["armed"]:
            state["armed"] = False
            hd.vec = _DeadVec()
        return hd

    dev.dispatch = flaky_dispatch.__get__(dev)
    bs = b"".join(o[0] for o in enc.encode_stream(iter(frames)))
    assert dev.failures == 1
    assert dev.dispatches == 4        # 3 frames + the re-dispatch
    assert bs == ref_bs


@pytest.mark.parametrize("bframes,sigs", [(0, 3), (15, 5)])
def test_prewarm_runs_every_signature(bframes, sigs):
    """api.prewarm on the port's engine: one dispatch per signature (I, P,
    P+ref0b and, for RA, B and B+ref0b+ref1b with placebo's two refs),
    each read back through np.asarray(hd.vec); the dummy frames leave
    the ring."""
    p = EncoderParams(w=64, h=64, qp=32, keyint=0, bframes=bframes,
                      preset="placebo")
    enc = torch_api.GopEncoder(p, analysis="device", device="cpu")
    assert enc.prewarm() >= 0.0
    dev = enc._device()
    assert dev.dispatches == sigs and dev.failures == 0
    assert not dev.ring and not dev.host_ring


def test_device_vec_reads_back_through_asarray():
    t = torch.arange(5, dtype=torch.int16)
    a = np.asarray(dt._DeviceVec(t))
    assert a.dtype == np.int16 and np.array_equal(a, t.numpy())
    assert np.asarray(dt._DeviceVec(t), np.int32).dtype == np.int32


def test_no_cpu_continuation_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.DeviceAnalyzer(64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_api.Encoder(EncoderParams(w=64, h=64), analysis="device")
    # the numpy engine runs on the CPU when the caller asks for it; an
    # unknown engine is refused
    enc = torch_api.Encoder(EncoderParams(w=64, h=64), analysis="numpy",
                            device="cpu")
    assert enc.analysis_engine == "numpy" and enc.device.type == "cpu"
    with pytest.raises(ValueError, match="engine"):
        torch_api.Encoder(EncoderParams(w=64, h=64), analysis="pallas",
                          device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sig", list(SIGS))
def test_fused_card_equals_cpu(sig):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    vg = _call(dt, lambda a: torch.as_tensor(a, device=dev), "gen10", sig)
    vc = _call(dt, torch.as_tensor, "gen10", sig).numpy()
    vg = vg.cpu().numpy()
    assert np.array_equal(vg[:-2], vc[:-2])
    assert _rc(vg) == pytest.approx(_rc(vc), rel=1e-5)
