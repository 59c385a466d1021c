"""The port's multi-device path (parallel/mesh.py and
GopEncoder.encode_stream_meshed) on meshes of CPU devices: the twin of
test_multichip.py.  The meshed stream equals the port's one-device
encode_stream and the JAX package's encode_stream_meshed on its 8-device
virtual mesh for every mesh size; meshed_analysis_step equals the JAX
package's on its 1-, 2- and 8-device meshes (modes exact, costs and the
psum'd total to rtol 1e-5, the f32 transform products above 2^24 and the
total's additions may round in another order); graft_entry is the twin of
__graft_entry__.py."""
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from tools.gen_test_content import gen_frame
from xeve_tpu import api as jax_api
from xeve_tpu.params import EncoderParams as JaxParams
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch import graft_entry
from xeve_tpu_torch.constants import chroma_qp_dynamic
from xeve_tpu_torch.enc.analysis_torch import _level_cost_impl, level_params
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams
from xeve_tpu_torch.parallel import mesh as port_mesh

# One intra-op thread: the test workers share the CPU (test_torch_encode.py)
torch.set_num_threads(1)

W, H = 128, 64
P = dict(w=W, h=H, qp=33, keyint=0, bframes=15)


def _frames(n):
    out = []
    for t in range(n):
        y, u, v = gen_frame(W, H, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


@pytest.fixture(scope="module")
def streams():
    """For 17 frames (one full sub-GOP) and 18 (and a flush): the port's
    one-device encode_stream and the JAX package's meshed stream."""
    import jax
    from xeve_tpu.parallel.mesh import make_mesh as jax_make_mesh
    out = {}
    for n in (17, 18):
        frames = _frames(n)
        one = torch_api.GopEncoder(EncoderParams(**P), analysis="device",
                                   device="cpu")
        ref = jax_api.GopEncoder(JaxParams(**P), analysis="device")
        mesh = jax_make_mesh(len(jax.devices()))
        out[n] = (frames,
                  [bs for bs, _r, _p in one.encode_stream(iter(frames))],
                  [bs for bs, _r, _p in ref.encode_stream_meshed(
                      iter(frames), mesh)])
    return out


@pytest.mark.parametrize("n", [17, 18])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_meshed_stream_equals_one_device_and_jax(streams, k, n):
    """k CPU devices (15 B frames: 2, 3 and 8 pad the batch to 16, 15 and
    16): the stream equals encode_stream's and the JAX package's meshed
    stream, and decodes to the returned recon."""
    frames, one, ref = streams[n]
    enc = torch_api.GopEncoder(EncoderParams(**P), analysis="device",
                               device="cpu")
    out = list(enc.encode_stream_meshed(iter(frames),
                                        port_mesh.make_mesh(k, "cpu")))
    bs = [b for b, _r, _p in out]
    assert len(bs) == n
    assert bs == one
    assert bs == ref
    assert enc._device().failures == 0
    recs = {poc: rec for _b, rec, poc in out}
    dec = BaselineIntraDecoder().decode(b"".join(bs))
    assert len(dec) == n
    for f in dec:
        for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
            assert np.array_equal(a, b), f"poc {f.poc}"


def test_meshed_sub_gop_spreads_b_frames(monkeypatch):
    """One sub-GOP on a 3-device mesh: the anchor through the analyzer's
    own dispatch, the 15 B frames (no padding) with bi refinement in
    contiguous shares of 5 per device."""
    seen, scopes = [], []
    real = port_mesh._fused_impl
    real_scope = port_mesh.device_scope

    def spy(*a, **k):
        seen.append(k["refine"])
        return real(*a, **k)

    def scope(d):
        scopes.append(d)
        return real_scope(d)

    monkeypatch.setattr(port_mesh, "_fused_impl", spy)
    monkeypatch.setattr(port_mesh, "device_scope", scope)
    mesh = [torch.device("cpu") for _ in range(3)]   # three distinct objects
    enc = torch_api.GopEncoder(EncoderParams(**P), analysis="device",
                               device="cpu")
    out = list(enc.encode_stream_meshed(iter(_frames(17)), mesh))
    assert len(out) == 17 and seen == [True] * 15
    assert [next(j for j, m in enumerate(mesh) if m is d) for d in scopes] \
        == [0] * 5 + [1] * 5 + [2] * 5
    assert enc._device().dispatches == 2          # the I frame and poc 16


def test_meshed_analysis_pads_and_rejects_ragged_batches():
    fn = port_mesh.meshed_subgop_analysis([torch.device("cpu")] * 2)
    x = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="does not split"):
        fn(*([x] * 11))


# meshed_analysis_step: 8 frames at 128x64, QP 32 (an I frame's Baseline
# qp_y, qp_u, qp_v), the 10-bit samples as f32 as the reference's callers
# give _level_cost_impl
STEP_QP = 32
STEP_QC = chroma_qp_dynamic(STEP_QP) + 12
STEP_ARGS = (W, H, STEP_QP, STEP_QP + 12, STEP_QC, STEP_QC)


def _step_batch(n=8):
    """(y, u, v) f32 stacks of n frames of the content generator (its own
    seed)."""
    fr = _frames(n)
    return tuple(np.stack([f[i] for f in fr]).astype(np.float32)
                 for i in range(3))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's meshed_analysis_step on 1, 2 and 8 virtual
    devices."""
    from xeve_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from xeve_tpu.parallel.mesh import meshed_analysis_step
    batch = _step_batch()
    return {k: [np.asarray(o) for o in meshed_analysis_step(
        jax_make_mesh(k), *STEP_ARGS)(*batch)] for k in (1, 2, 8)}


@pytest.mark.parametrize("k_jax", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_meshed_analysis_step_equals_jax(jax_steps, k, k_jax):
    """The port on k CPU devices against the JAX package on k_jax: modes
    equal, costs and total to rtol 1e-5; every map equals the port's
    single-frame _level_cost_impl bit for bit, and total the float64 sum
    of the lg 6 costs to rtol 1e-5."""
    y, u, v = (torch.as_tensor(a) for a in _step_batch())
    out = port_mesh.meshed_analysis_step(port_mesh.make_mesh(k, "cpu"),
                                         *STEP_ARGS)(y, u, v)
    ref = jax_steps[k_jax]
    assert len(out) == len(ref) == 11
    for j, lg in enumerate(range(2, 7)):
        m, c = out[2 * j], out[2 * j + 1]
        assert m.shape == c.shape == (8, H >> lg, W >> lg)
        assert m.dtype == torch.int32 and c.dtype == torch.float32
        assert np.array_equal(m.numpy(), ref[2 * j]), f"lg {lg} modes"
        np.testing.assert_allclose(c.numpy(), ref[2 * j + 1], rtol=1e-5)
        prm = torch.as_tensor(level_params(*STEP_ARGS[2:], 10, lg))
        for i in range(8):
            m1, c1 = _level_cost_impl(y[i], u[i], v[i], prm, bd=10, lg=lg)
            assert torch.equal(m[i], m1) and torch.equal(c[i], c1), \
                f"lg {lg} frame {i} differs from the single-frame graph"
    total = out[-1]
    assert total.shape == () and total.dtype == torch.float32
    np.testing.assert_allclose(float(total), float(ref[-1]), rtol=1e-5)
    np.testing.assert_allclose(float(total),
                               out[-2].double().sum().item(), rtol=1e-5)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_meshed_analysis_step_refuses_uneven_batch(side):
    """A batch of 6 on 4 devices."""
    batch = _step_batch(6)
    if side == "jax":
        from xeve_tpu.parallel.mesh import make_mesh as jax_make_mesh
        from xeve_tpu.parallel.mesh import meshed_analysis_step
        fn = meshed_analysis_step(jax_make_mesh(4), *STEP_ARGS)
    else:
        fn = port_mesh.meshed_analysis_step(port_mesh.make_mesh(4, "cpu"),
                                            *STEP_ARGS)
        batch = tuple(torch.as_tensor(a) for a in batch)
    with pytest.raises(ValueError, match="divisible|does not split"):
        fn(*batch)


def test_make_mesh(monkeypatch):
    """n entries of the CPU device; the first n CUDA cards, at most as many
    as there are (the JAX package's devs[:n])."""
    cpu = torch.device("cpu")
    assert port_mesh.make_mesh(None, "cpu") == [cpu]
    assert port_mesh.make_mesh(4, "cpu") == [cpu] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert port_mesh.make_mesh() == cards
    assert port_mesh.make_mesh(1) == cards[:1]
    assert port_mesh.make_mesh(4) == cards


def test_make_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_mesh()


@pytest.mark.parametrize("kw", [dict(keyint=1), dict(bframes=0, keyint=0),
                                dict(ref_pics=2)])
def test_meshed_path_asserts_ra_gop16_single_ref(kw):
    p = dict(P, **kw)
    enc = torch_api.GopEncoder(EncoderParams(**p), analysis="device",
                               device="cpu")
    with pytest.raises(AssertionError):
        list(enc.encode_stream_meshed(iter(_frames(2)),
                                      [torch.device("cpu")]))


def test_graft_entry_equals_jax_entry():
    """One intra level (lg 4, 128x128): modes equal, costs to rtol 1e-5
    (the f32 products above 2^24 may sum in another order)."""
    fn, args = graft_entry.entry(device="cpu")
    mode, cost = fn(*args)
    jfn, jargs = jax_graft.entry()
    jmode, jcost = jfn(*jargs)
    assert mode.shape == (8, 8) and mode.dtype == torch.int32
    assert np.array_equal(mode.numpy(), np.asarray(jmode))
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-5)
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_graft_dryrun_multichip():
    graft_entry.dryrun_multichip(2, device="cpu")


@pytest.mark.cuda
def test_meshed_stream_on_card_equals_one_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(17)
    one = [bs for bs, _r, _p in torch_api.GopEncoder(
        EncoderParams(**P), analysis="device", device="cuda")
        .encode_stream(iter(frames))]
    mesh = [torch.device("cuda", 0)] * 2
    out = [bs for bs, _r, _p in torch_api.GopEncoder(
        EncoderParams(**P), analysis="device", device="cuda")
        .encode_stream_meshed(iter(frames), mesh)]
    assert out == one


@pytest.mark.cuda
def test_meshed_analysis_step_on_card_equals_single_frame_graph():
    """[cuda:0, cuda:0]: every map equals the card's single-frame graph;
    the total lies on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    y, u, v = (torch.as_tensor(a, device=dev) for a in _step_batch())
    out = port_mesh.meshed_analysis_step([dev] * 2, *STEP_ARGS)(y, u, v)
    for j, lg in enumerate(range(2, 7)):
        prm = torch.as_tensor(level_params(*STEP_ARGS[2:], 10, lg),
                              device=dev)
        for i in range(8):
            m1, c1 = _level_cost_impl(y[i], u[i], v[i], prm, bd=10, lg=lg)
            assert torch.equal(out[2 * j][i], m1)
            assert torch.equal(out[2 * j + 1][i], c1)
    assert out[-1].device == dev and out[-1].shape == ()
