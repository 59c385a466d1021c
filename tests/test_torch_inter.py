"""Inter analysis of the torch port: every integer-exact stage equals its
JAX twin bit for bit, and the frame-level MV maps equal the JAX maps."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from xeve_tpu.constants import chroma_qp_dynamic
from xeve_tpu.enc import analysis_inter_jax as aij
from xeve_tpu.ops import mc_np
from xeve_tpu_torch.enc import analysis_inter_torch as ait

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)

PAD = aij.PAD


def _ref_pad(seed=0, h=64, w=64, bd=10):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    return mc_np.pad_picture(ref, PAD)


@pytest.mark.parametrize("bd", [8, 10])
def test_phase_planes_exact(bd):
    ref_pad = _ref_pad(seed=bd, h=32, w=48, bd=bd)
    pj = np.asarray(aij._phase_planes(jnp.asarray(ref_pad, jnp.int32), bd))
    pt = ait._phase_planes(torch.as_tensor(ref_pad), bd)
    assert pt.dtype == torch.int16
    assert np.array_equal(pt.numpy(), pj)


def test_int16_wrap_of_separable_intermediate():
    x = torch.tensor([-40000, -32769, -32768, -1, 0, 32767, 32768, 70000])
    want = x.numpy().astype(np.int16).astype(np.int64)
    assert np.array_equal(ait._wrap(x, 16).numpy(), want)


def test_gather_blocks_exact_and_matches_mc_luma():
    ref_pad = _ref_pad()
    planes_t = ait._phase_planes(torch.as_tensor(ref_pad), 10)
    planes_j = jnp.asarray(planes_t.numpy())
    for mv in ((0, 0), (5, -3), (-2, 7), (1, 1), (-9, -6), (3, 2),
               (-400, 390)):
        mv_q = np.tile(np.asarray(mv, np.int32), (2, 2, 1))
        gt = ait._gather_blocks(planes_t, torch.as_tensor(mv_q), 16, PAD,
                                2, 2).numpy()
        gj = np.asarray(aij._gather_blocks(planes_j, jnp.asarray(mv_q), 16,
                                           PAD, 2, 2))
        assert np.array_equal(gt, gj), f"mv {mv}"
        if abs(mv[0]) > 4 * PAD:
            continue            # clipped indices: no mc_luma counterpart
        for by in range(2):
            for bx in range(2):
                gx = (((bx * 16) << 2) + mv[0]) << 2
                gy = (((by * 16) << 2) + mv[1]) << 2
                exact = mc_np.mc_luma(ref_pad, PAD, gx, gy, 16, 16, 10)
                assert np.array_equal(gt[by, bx], exact), f"mv {mv}"


def test_subpel_refine_exact():
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 1024, (48, 64)).astype(np.int32)
    ref[:16] = 512                       # flat rows: SAD ties
    cur = np.clip(np.roll(ref, (1, 2), axis=(0, 1))
                  + rng.integers(-6, 7, ref.shape), 0, 1023).astype(np.int32)
    ref_pad = mc_np.pad_picture(ref, PAD)
    int_mv = rng.integers(-3, 4, (3, 4, 2)).astype(np.int32)
    planes_t = ait._phase_planes(torch.as_tensor(ref_pad), 10)
    bt = ait._subpel_refine(ait._cur_blocks(torch.as_tensor(cur), 16),
                            planes_t, torch.as_tensor(int_mv), PAD)
    bj = aij._subpel_refine(aij._cur_blocks(jnp.asarray(cur), 16),
                            jnp.asarray(planes_t.numpy()),
                            jnp.asarray(int_mv), PAD)
    assert np.array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("lg", [2, 3, 4, 5, 6])
def test_mv_for_level_exact(lg):
    """4- and 16-value medians with odd sums of negative MVs: the JAX
    median truncates the mean of the middle two toward zero."""
    rng = np.random.default_rng(lg)
    mv16 = rng.integers(-37, 20, (8, 12, 2)).astype(np.int32)
    mv16[0, 0:2, 0] = [-3, -2]           # middle pair sums to -5
    mv16[1, 0:2, 0] = [-3, -2]
    s = 1 << lg
    nby, nbx = 128 // s, 192 // s
    mt = ait._mv_for_level(torch.as_tensor(mv16), lg, nby, nbx)
    mj = aij._mv_for_level(jnp.asarray(mv16), lg, nby, nbx)
    assert mt.dtype == torch.int32
    assert np.array_equal(mt.numpy(), np.asarray(mj))


def test_mvd_bits_exact():
    mv = np.stack(np.meshgrid(np.arange(-300, 301, 7),
                              np.array([-70000, -65, -1, 0, 1, 2, 66000])),
                  axis=-1).astype(np.int32)
    bt = ait._mvd_bits(torch.as_tensor(mv)).numpy()
    bj = np.asarray(aij._mvd_bits(jnp.asarray(mv)))
    assert np.array_equal(bt, bj)


def _frame(i, name="s96b.yuv"):
    y, u, v = load_yuv8(os.path.join(DATA, name), 96, 80, i)
    return (y << 2).astype(np.int32), (u << 2).astype(np.int32), \
        (v << 2).astype(np.int32)


def _ref(i, poc):
    y, u, v = _frame(i)
    return {"poc": poc, "y_pad": mc_np.pad_picture(y, PAD),
            "u_pad": mc_np.pad_picture(u, PAD // 2),
            "v_pad": mc_np.pad_picture(v, PAD // 2)}


@pytest.mark.parametrize("slice_kind", ["P", "B"])
def test_analyze_frame_inter_maps_equal_jax(slice_kind):
    y, u, v = _frame(2)
    qp = 32
    qp_y, qp_u = qp + 12, chroma_qp_dynamic(qp) + 12
    refp = [_ref(0, 0)]
    refp1 = [_ref(4, 4)] if slice_kind == "B" else None
    args = (y, u, v, refp, qp, qp_y, qp_u, qp_u, 10)
    aj = aij.analyze_frame_inter_jax(*args, search_range=16, refp1=refp1)
    at = ait.analyze_frame_inter_torch(*args, search_range=16, refp1=refp1,
                                       device="cpu")
    for lg in aj.mv:
        assert at.mv[lg].dtype == np.int32
        assert np.array_equal(at.mv[lg], aj.mv[lg]), f"mv level {lg}"
        assert np.array_equal(at.mode[lg], aj.mode[lg])
        assert np.array_equal(at.split[lg], aj.split[lg])
        np.testing.assert_allclose(at.leaf_cost[lg], aj.leaf_cost[lg],
                                   rtol=1e-5)
        if slice_kind == "B":
            assert np.array_equal(at.mv1[lg], aj.mv1[lg]), f"mv1 level {lg}"
    assert (at.mv1 is None) == (slice_kind == "P")
    assert any(np.any(m != 0) for m in at.mv.values())
