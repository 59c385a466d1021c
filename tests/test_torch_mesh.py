"""The port's multi-device path (parallel/mesh.py and
GopEncoder.encode_stream_meshed) on meshes of CPU devices: the twin of
test_multichip.py.  The meshed stream equals the port's one-device
encode_stream and the JAX package's encode_stream_meshed on its 8-device
virtual mesh for every mesh size; graft_entry is the twin of
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
