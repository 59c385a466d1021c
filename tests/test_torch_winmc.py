"""Motion primitives of the device analyzer in torch (winmc_torch) against
their JAX twins (winmc_jax): every function is integer-exact, so every
output must be bit-identical on the same inputs."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from tools.gen_test_content import gen_frame
from xeve_tpu.enc import winmc_jax as wj
from xeve_tpu.ops import mc_np
from xeve_tpu_torch import tables
from xeve_tpu_torch.enc import winmc_torch as wt

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)

PAD = 80


def _same(a_torch, a_jax):
    a = a_torch.numpy()
    b = np.asarray(a_jax)
    assert a.shape == b.shape
    assert np.array_equal(a, b.astype(a.dtype)) and \
        np.array_equal(a.astype(b.dtype), b)


def _planes(kind, seed=0, bd=10):
    """(cur, ref) luma pairs: s96b frames 0/1, 128x64 gen_frame content,
    random planes, and a pair shifted by 24 pels (past the +-23 clamp)."""
    rng = np.random.default_rng(seed)
    if kind == "s96":
        cur = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 1)[0] << 2
        ref = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 0)[0] << 2
    elif kind == "gen":
        cur = gen_frame(128, 64, 1)[0].astype(np.int32) << 2
        ref = gen_frame(128, 64, 0)[0].astype(np.int32) << 2
    elif kind == "random":
        cur = rng.integers(0, 1 << bd, (64, 96)).astype(np.int32)
        ref = rng.integers(0, 1 << bd, (64, 96)).astype(np.int32)
    else:   # "shift": cur(y, x) = ref(y - 24, x + 24), MV (24, -24)
        ref = gen_frame(160, 96, 0)[0].astype(np.int32) << 2
        cur = np.roll(ref, (24, -24), axis=(0, 1))
    return cur.astype(np.int32), mc_np.pad_picture(ref.astype(np.int32), PAD)


def test_host_tables_equal_originals():
    assert np.array_equal(wt.MC_L, wj.MC_L)
    assert np.array_equal(tables._MC_L, wj.MC_L)
    assert np.array_equal(wt._T12, wj._T12)
    assert np.array_equal(wt._T16, wj._T16)
    for args in ((8, 3, 7), (2, 1, 5), (0, 3, 7)):
        for a, b in zip(wt._cand_table(*args), wj._cand_table(*args)):
            assert np.array_equal(a, np.asarray(b))
    assert wt.MAX_MV_PEL == wj.MAX_MV_PEL


@pytest.mark.parametrize("kind", ["s96", "gen", "random", "shift"])
def test_coarse_me_exact(kind):
    cur, ref_pad = _planes(kind)
    nby, nbx = cur.shape[0] // 16, cur.shape[1] // 16
    mt = wt.coarse_me(torch.as_tensor(cur, dtype=torch.float32),
                      torch.as_tensor(ref_pad, dtype=torch.float32), PAD,
                      nby, nbx)
    mj = wj.coarse_me(jnp.asarray(cur, jnp.float32),
                      jnp.asarray(ref_pad, jnp.float32), PAD, nby, nbx)
    assert mt.dtype == torch.int32
    _same(mt, mj)
    if kind == "shift":
        # the true motion (24, -24) lies past the clamp
        inner = mt[2:-1, 1:-2].reshape(-1, 2).numpy()
        assert (inner == [23, -23]).all(-1).mean() > 0.8


# (bs, k, off, pad): every build_patches call of the device analyzer
PATCH_SITES = [(16, 5, 32, 80), (8, 5, 16, 40), (32, 3, 32, 80),
               (64, 2, 32, 80), (16, 3, 16, 40), (32, 2, 16, 40)]


@pytest.mark.parametrize("bs,k,off,pad", PATCH_SITES)
def test_build_patches_exact(bs, k, off, pad):
    rng = np.random.default_rng(bs + k)
    h, w = 2 * bs, 3 * bs
    plane = mc_np.pad_picture(rng.integers(0, 1024, (h, w)).astype(np.int32),
                              pad)
    pt = wt.build_patches(torch.as_tensor(plane), bs, k, off, h // bs,
                          w // bs, pad)
    pj = wj.build_patches(jnp.asarray(plane), bs, k, off, h // bs, w // bs,
                          pad)
    assert pt.dtype == torch.int16
    _same(pt, pj)


# (bs, k, window): every onehot_extract call (patch k*bs, window oh = ow)
EXTRACT_SITES = [(16, 5, 32), (8, 5, 8), (32, 3, 44), (64, 2, 76),
                 (16, 3, 16), (32, 2, 32)]


@pytest.mark.parametrize("bs,k,win", EXTRACT_SITES)
def test_onehot_extract_equals_gather_at_extremes(bs, k, win):
    """The gather equals the one-hot matmuls at both ends of the offset
    range [0, k*bs - win] and in between."""
    rng = np.random.default_rng(win)
    P = rng.integers(0, 1024, (3, 4, k * bs, k * bs)).astype(np.int16)
    hi = k * bs - win
    offs = np.array([[0, hi, hi // 2, 1], [hi, 0, 0, hi],
                     [hi - 1, hi, 2, 0]], np.int32)
    offc = offs[::-1].copy()
    et = wt.onehot_extract(torch.as_tensor(P), torch.as_tensor(offs),
                           torch.as_tensor(offc), win, win)
    ej = wj.onehot_extract(jnp.asarray(P), jnp.asarray(offs),
                           jnp.asarray(offc), win, win)
    assert et.dtype == torch.int32
    _same(et, ej)


@pytest.mark.parametrize("bd", [8, 10])
def test_phase_windows_exact(bd):
    rng = np.random.default_rng(bd)
    W32 = rng.integers(0, 1 << bd, (3, 4, 32, 32)).astype(np.int32)
    W32[0, 0] = (1 << bd) - 1            # saturating window
    W32[0, 1] = 0
    pt = wt.phase_windows(torch.as_tensor(W32), bd)
    pj = wj.phase_windows(jnp.asarray(W32), bd)
    assert pt.dtype == torch.int16 and pt.shape == (3, 4, 16, 24, 24)
    _same(pt, pj)


def _qpel_inputs(seed, bd=10):
    """Phase windows of extraction windows around real motion, with flat
    blocks (every candidate ties) mixed in."""
    rng = np.random.default_rng(seed)
    cur, ref_pad = _planes("gen")
    nby, nbx = cur.shape[0] // 16, cur.shape[1] // 16
    m = rng.integers(-23, 24, (nby, nbx, 2)).astype(np.int32)
    P = wj.build_patches(jnp.asarray(ref_pad), 16, 5, 32, nby, nbx, PAD)
    W32 = np.asarray(wj.onehot_extract(P, jnp.asarray(m[..., 1] + 25),
                                       jnp.asarray(m[..., 0] + 25), 32, 32)
                     ).astype(np.int32)
    W32[0, :2] = 512
    cur16 = cur.reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3).copy()
    cur16[0, 0] = 512
    vw = np.array(wj.phase_windows(jnp.asarray(W32), bd))
    return cur16, vw, W32


@pytest.mark.parametrize("want_pred", [True, False])
def test_eval_qpel_exact(want_pred):
    cur16, vw, W32 = _qpel_inputs(0)
    rt = wt.eval_qpel(torch.as_tensor(cur16), torch.as_tensor(vw),
                      want_pred=want_pred, W32=torch.as_tensor(W32))
    rj = wj.eval_qpel(jnp.asarray(cur16), jnp.asarray(vw),
                      want_pred=want_pred, W32=jnp.asarray(W32))
    assert len(rt) == len(rj) == 4
    for a, b in zip(rt, rj):
        if b is None:
            assert a is None
        else:
            _same(a, b)
    assert (rt[0][0, 0] == 0).all()      # flat block: zero offset wins ties


def test_eval_qpel_target_exact():
    cur16, vw, W32 = _qpel_inputs(1)
    rng = np.random.default_rng(1)
    pred0 = rng.integers(0, 1024, cur16.shape).astype(np.int32)
    tgt = 2 * cur16 - pred0
    qt = wt.eval_qpel_target(torch.as_tensor(tgt), torch.as_tensor(vw))
    qj = wj.eval_qpel_target(jnp.asarray(tgt), jnp.asarray(vw))
    _same(qt, qj)


@pytest.mark.parametrize("table,q_lo,s,bd", [
    ("_T12", -4, 32, 10), ("_T12", -4, 64, 8), ("_T16", -8, 16, 10),
    ("_T16", -8, 16, 8)])
def test_perblock_mc_every_q(table, q_lo, s, bd):
    """Every (q_x, q_y) pair in the table's range, one block each."""
    nq = getattr(wj, table).shape[0]
    win = s + 12 if table == "_T12" else 32
    rng = np.random.default_rng(s + bd)
    W = rng.integers(0, 1 << bd, (nq, nq, win, win)).astype(np.int32)
    W[0, 0] = (1 << bd) - 1
    qx = np.tile(np.arange(nq, dtype=np.int32)[None, :] + q_lo, (nq, 1))
    qy = qx.T.copy()
    mt = wt.perblock_mc(torch.as_tensor(W), torch.as_tensor(qx),
                        torch.as_tensor(qy), s, bd,
                        table=getattr(wt, table), q_lo=q_lo)
    mj = wj.perblock_mc(jnp.asarray(W), jnp.asarray(qx), jnp.asarray(qy), s,
                        bd, table=getattr(wj, table), q_lo=q_lo)
    assert mt.dtype == torch.int32 and mt.shape == (nq, nq, s, s)
    _same(mt, mj)
