"""Intra analysis of the torch port against the JAX twin (analysis_jax) and
the numpy oracle, and the host-side copies against their originals.

Tolerance: the f32 transform products exceed 2^24, so the CPU backends of
XLA and torch may round a cost differently.  Modes must be identical and
each block's minimum cost must agree to rtol 1e-5 (measured: at most
2e-7 on these inputs)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA, load_yuv8
from xeve_tpu.constants import chroma_qp_dynamic
from xeve_tpu.enc import analysis_inter_jax, analysis_jax
from xeve_tpu.enc.analysis_np import analyze_frame
from xeve_tpu_torch import tables
from xeve_tpu_torch.enc import analysis_torch

# One intra-op thread: the test workers share the CPU, and torch's
# OpenMP threads would spin against each other on the port's many
# small ops (a 3 s encode took minutes under a full parallel run).
torch.set_num_threads(1)

FIXTURES = {"s96": ("s96.yuv", 96, 80), "cif": ("cif.yuv", 352, 288)}


def _load(name):
    fn, w, h = FIXTURES[name]
    y8, u8, v8 = load_yuv8(os.path.join(DATA, fn), w, h, 0)
    return y8 << 2, u8 << 2, v8 << 2


def _qps(qp):
    return qp, qp + 12, chroma_qp_dynamic(qp) + 12, chroma_qp_dynamic(qp) + 12


def test_tables_equal_originals():
    for n in (2, 4, 8, 16, 32, 64):
        assert np.array_equal(tables._SCAN_RANK[n], analysis_jax._SCAN_RANK[n])
        for a, b in zip(tables._sel_matrices(n),
                        analysis_jax._sel_matrices(n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        tabs = tables.load_tables(torch.device("cpu"))
        assert np.array_equal(tabs["tm"][n].numpy(),
                              np.asarray(analysis_jax._TMf[n]))
        assert np.array_equal(tabs["scan_rank"][n].numpy(),
                              analysis_jax._SCAN_RANK[n])
    assert np.array_equal(tables._MC_L, analysis_inter_jax._MC_L)


@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_host_param_copies_equal_originals(qp):
    qp_y, qp_u = qp + 12, chroma_qp_dynamic(qp) + 12
    for lg in range(2, 7):
        for ch_lg in (lg, lg - 1):
            assert analysis_torch.quant_params(qp_y, 10, ch_lg) == \
                analysis_jax.quant_params(qp_y, 10, ch_lg)
        a = analysis_torch.level_params(qp, qp_y, qp_u, qp_u + 1, 10, lg)
        b = analysis_jax.level_params(qp, qp_y, qp_u, qp_u + 1, 10, lg)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_unpack_and_partition_dp_copies_equal_originals():
    rng = np.random.default_rng(5)
    h, w = 80, 96       # 80 is not a multiple of 32/64: invalid leaves
    n = sum((h >> lg) * (w >> lg) for lg in range(2, 7))
    vec = np.empty(2 * n, np.float32)
    off = 0
    for lg in range(2, 7):
        k = (h >> lg) * (w >> lg)
        vec[off:off + k] = rng.integers(0, 5, k)
        vec[off + k:off + 2 * k] = rng.uniform(10, 1e5, k)
        off += 2 * k
    m_t, c_t = analysis_torch._unpack(vec, h, w, 2, 6)
    m_j, c_j = analysis_jax._unpack(vec, h, w, 2, 6)
    for lg in m_j:
        assert m_t[lg].dtype == m_j[lg].dtype
        assert np.array_equal(m_t[lg], m_j[lg])
        assert np.array_equal(c_t[lg], c_j[lg])
    a = analysis_torch._partition_dp(m_t, c_t, h, w, 300.0, 2, 6)
    b = analysis_jax._partition_dp(m_j, c_j, h, w, 300.0, 2, 6)
    for lg in b.split:
        assert np.array_equal(a.split[lg], b.split[lg])
        assert np.array_equal(a.tree_cost[lg], b.tree_cost[lg])


@pytest.mark.parametrize("s", [2, 4, 8, 16, 32])
def test_neighbors_and_predictions_exact(s):
    y, _, _ = _load("s96")
    yj = jnp.asarray(y, jnp.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    nj = analysis_jax._neighbors(yj, s, 10)
    nt = analysis_torch._neighbors(yt, s, 10)
    for a, b in zip(nj, nt):
        assert np.array_equal(np.asarray(a), b.numpy())
    pj = analysis_jax._pred_all_modes(*nj, s)
    pt = analysis_torch._pred_all_modes(*nt, s)
    assert np.array_equal(np.asarray(pj), pt.numpy())
    assert np.array_equal(np.asarray(analysis_jax._blocks(yj, s)),
                          analysis_torch._blocks(yt, s).numpy())


@pytest.mark.parametrize("name", ["s96", "cif"])
@pytest.mark.parametrize("qp", [22, 32, 42])
def test_level_cost_matches_jax(name, qp):
    y, u, v = _load(name)
    qp, qp_y, qp_u, qp_v = _qps(qp)
    planes_j = [jnp.asarray(p, jnp.float32) for p in (y, u, v)]
    planes_t = [torch.as_tensor(p, dtype=torch.float32) for p in (y, u, v)]
    for lg in range(2, 7):
        prm = analysis_jax.level_params(qp, qp_y, qp_u, qp_v, 10, lg)
        mj, cj = analysis_jax._level_cost(*planes_j, jnp.asarray(prm),
                                          bd=10, lg=lg)
        mt, ct = analysis_torch._level_cost_impl(*planes_t,
                                                 torch.as_tensor(prm),
                                                 bd=10, lg=lg)
        assert mt.dtype == torch.int32 and ct.dtype == torch.float32
        assert np.array_equal(mt.numpy(), np.asarray(mj)), f"level {lg}"
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   err_msg=f"level {lg}")


def test_analyze_frame_agrees_with_numpy_and_jax():
    y, u, v = _load("s96")
    qp, qp_y, qp_u, qp_v = _qps(32)
    a_np = analyze_frame(y, u, v, qp, qp_y, qp_u, qp_v, 10)
    a_jx = analysis_jax.analyze_frame_jax(y, u, v, qp, qp_y, qp_u, qp_v, 10)
    a_t = analysis_torch.analyze_frame_torch(y, u, v, qp, qp_y, qp_u, qp_v,
                                             10, device="cpu")
    for lg in a_np.mode:
        assert (a_np.mode[lg] == a_t.mode[lg]).mean() > 0.90
        assert (a_np.split[lg] == a_t.split[lg]).mean() > 0.90
        assert np.array_equal(a_t.mode[lg], a_jx.mode[lg])
        assert np.array_equal(a_t.split[lg], a_jx.split[lg])
        np.testing.assert_allclose(a_t.leaf_cost[lg], a_jx.leaf_cost[lg],
                                   rtol=1e-5)


def test_analysis_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, u, v = _load("s96")
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis_torch.analyze_frame_torch(y, u, v, *_qps(32), 10,
                                           device="cuda")
