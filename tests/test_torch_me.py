"""Full-search integer ME of the torch port: the plain version against the
numpy oracle and the JAX twin (the Pallas kernel is covered as the JAX
tests cover it, through integer_me_jax and the oracle), the wrapper's
CPU route and input checks, and the CUDA kernel against the plain version
on the card."""
import os

import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from xeve_tpu.enc.analysis_inter_np import integer_me
from xeve_tpu.enc.me_jax import integer_me_jax
from xeve_tpu.ops import mc_np
from xeve_tpu_torch.enc.me_torch import integer_me_plain
from xeve_tpu_torch.ops import me_cuda

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)

PAD = 80


def _s96b_pair():
    y0, _, _ = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 0)
    y1, _, _ = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 1)
    return (y1 << 2).astype(np.int32), (y0 << 2).astype(np.int32)


def _random_pair(bd, seed=7, h=72, w=104):
    """Shifted content plus noise, so the minimum is not at (0, 0), and
    flat areas, so ties occur."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    ref = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    ref[:, :24] = mx // 2
    cur = np.roll(ref, (2, -3), axis=(0, 1)) + rng.integers(-3, 4, (h, w))
    return np.clip(cur, 0, mx).astype(np.int32), ref


@pytest.mark.parametrize("case,R", [("s96b", 8), ("s96b", 16),
                                    ("rand8", 16), ("rand10", 16)])
def test_plain_me_equals_oracle_and_jax(case, R):
    if case == "s96b":
        cur, ref = _s96b_pair()
    else:
        cur, ref = _random_pair(8 if case == "rand8" else 10)
    ref_pad = mc_np.pad_picture(ref, PAD)
    mv_np, sad_np = integer_me(cur, ref_pad, PAD, R)
    mv_jx, sad_jx = integer_me_jax(cur, ref_pad, PAD, R)
    mv_t, sad_t = me_cuda.integer_me_np(cur, ref_pad, PAD, R, device="cpu")
    assert mv_t.dtype == np.int32 and sad_t.dtype == np.int64
    assert np.array_equal(mv_t, mv_np) and np.array_equal(sad_t, sad_np)
    assert np.array_equal(mv_t, mv_jx) and np.array_equal(sad_t, sad_jx)
    assert np.any(mv_t != 0)


def test_wrapper_runs_plain_version_on_cpu():
    cur, ref = _random_pair(10, seed=3, h=48, w=64)
    ref_pad = mc_np.pad_picture(ref, PAD)
    c = torch.as_tensor(cur)
    r = torch.as_tensor(ref_pad)
    before = me_cuda.LAUNCHES
    mv, cost = me_cuda.integer_me(c, r, PAD, 8)
    mv0, cost0 = integer_me_plain(c, r, 8, PAD)
    assert me_cuda.LAUNCHES == before, "no kernel launch for a CPU tensor"
    assert torch.equal(mv, mv0) and torch.equal(cost, cost0)
    assert mv.dtype == torch.int32 and cost.dtype == torch.int32


@pytest.mark.parametrize("bad", ["range", "shape", "ref", "dtype"])
def test_wrapper_rejects_bad_input(bad):
    cur = torch.zeros((32, 48), dtype=torch.int32)
    ref = torch.zeros((32 + 2 * PAD, 48 + 2 * PAD), dtype=torch.int32)
    R = 8
    err = ValueError
    if bad == "range":
        R = PAD + 1
    elif bad == "shape":
        cur = cur[:, :40]
        ref = ref[:, :40 + 2 * PAD]
    elif bad == "ref":
        ref = ref[:-1]
    else:
        cur = cur.to(torch.int64)
        err = TypeError
    with pytest.raises(err):
        me_cuda.integer_me(cur, ref, PAD, R)


def _card_pair(kind, h, w, seed):
    """random: shifted content with flat areas (_random_pair); flat: one
    constant plane, so every SAD is 0 and the zero MV must win on its bias;
    binary: samples in {0, 1}, so many candidates tie on cost and the
    first in raster order must win."""
    if kind == "random":
        return _random_pair(10, seed=seed, h=h, w=w)
    if kind == "flat":
        ref = np.full((h, w), 517, np.int32)
        return ref.copy(), ref
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (h, w)).astype(np.int32),
            rng.integers(0, 2, (h, w)).astype(np.int32))


# R from 0 to PAD, where every R but 16 gives 2R + 1 that is not a
# multiple of the kernel's strip of 11 dx, and block counts per row that
# are not a multiple of its group of 4 blocks (nbx = 1, 5, 6, 7)
@pytest.mark.cuda
@pytest.mark.parametrize("h,w,R,kind", [
    (64, 96, 0, "random"), (64, 96, 1, "random"), (64, 96, 4, "random"),
    (80, 96, 8, "random"), (80, 96, 16, "random"), (48, 80, 23, "random"),
    (48, 64, 40, "random"), (48, 112, 16, "flat"), (32, 16, 40, "flat"),
    (64, 80, 16, "binary"), (48, 112, 23, "binary"), (16, 64, 80, "random")])
def test_kernel_equals_plain_on_card(h, w, R, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cur, ref = _card_pair(kind, h, w, seed=h + R)
    c = torch.as_tensor(cur, device="cuda")
    r = torch.as_tensor(mc_np.pad_picture(ref, PAD), device="cuda")
    before = me_cuda.LAUNCHES
    mv, cost = me_cuda.integer_me(c, r, PAD, R)
    torch.cuda.synchronize()
    assert me_cuda.LAUNCHES == before + 1
    mv0, cost0 = integer_me_plain(c, r, R, PAD)
    assert torch.equal(mv, mv0) and torch.equal(cost, cost0)
    if kind == "flat":
        assert not mv.any() and not cost.any()
