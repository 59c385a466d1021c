"""Frame-parallel analysis over several devices (port of
xeve_tpu/parallel/mesh.py).

A mesh is a list of torch devices.  Both entry points split a batch over
it in contiguous shares, as the JAX package's shard_map splits its "gop"
axis, and run each frame's single-device graph on its device, so their
results do not depend on the mesh:
- meshed_subgop_analysis: the B frames of a RA sub-GOP through the fused
  graph (enc/device_analyzer._fused_impl); the analysis, and the stream
  of api.GopEncoder.encode_stream_meshed, equal the one-device ones.
- meshed_analysis_step: per-level intra (mode, cost) maps of a batch of
  frames (enc/analysis_torch._level_cost_impl) and one cost summed across
  the mesh, the counterpart of the JAX package's only collective (psum).
"""
from __future__ import annotations

import torch

from ..device import device_scope, resolve_device
from ..enc.analysis_torch import _level_cost_impl, level_params
from ..enc.device_analyzer import PAD, _fused_impl


def make_mesh(n_devices: int | None = None, device="cuda") -> list:
    """The first `n_devices` CUDA cards in index order (all of them by
    default; like the JAX package's devs[:n], at most as many as there
    are), or `n_devices` entries of the one CPU device."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:n_devices or len(devs)]


def _share(n: int, mesh) -> int:
    """Frames per device of a batch of n (item i on mesh[i // share])."""
    if n % len(mesh):
        raise ValueError(f"batch of {n} does not split over "
                         f"{len(mesh)} devices")
    return n // len(mesh)


def meshed_subgop_analysis(mesh, bd: int = 10, search_range: int = 16,
                           min_log2: int = 2, max_log2: int = 6):
    """fn(y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, prms, prm3) over stacked
    batches of Bp frames, Bp a multiple of len(mesh): item i runs the fused
    analysis with bi refinement on mesh[i // (Bp // len(mesh))] against its
    L0 and L1 refi-0 originals.  Returns the packed int16 vectors, a list
    in batch order, on the device of the inputs."""
    mesh = list(mesh)

    def fn(*batches):
        n = batches[0].shape[0]
        share = _share(n, mesh)
        out = []
        for i in range(n):
            d = mesh[i // share]
            y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, prms, prm3 = (
                b[i].to(d) for b in batches)
            with device_scope(d):
                vec = _fused_impl(y, u, v, (r0y, r0u, r0v), None,
                                  (r1y, r1u, r1v), None, prms, prm3, bd=bd,
                                  R=int(search_range), pad=PAD,
                                  min_log2=min_log2, max_log2=max_log2,
                                  refine=True)
            out.append(vec.to(batches[0].device))
        return out

    return fn


def meshed_analysis_step(mesh, w: int, h: int, qp: int, qp_y: int,
                         qp_u: int, qp_v: int, bd: int = 10,
                         min_log2: int = 2, max_log2: int = 6):
    """fn(y, u, v) over stacked f32 batches (B, h, w), (B, h/2, w/2) and
    (B, h/2, w/2) of 10-bit samples (f32 is what the JAX package's callers
    hand _level_cost_impl), B a multiple of len(mesh).  Item i runs the
    single-frame intra level costs on mesh[i // (B // len(mesh))].
    Returns (mode_lg, cost_lg for lg = min_log2 .. max_log2, total): each
    map (B, h >> lg, w >> lg), int32 modes and f32 costs, in batch order
    on the device of the inputs, and total, a 0-d f32 tensor there.

    Each frame runs the graph of analyze_frame_torch and BatchAnalyzer, so
    its maps equal theirs on the same device; no product is batched across
    frames (a batched product may sum the f32 transforms in another order,
    analysis_torch.BatchAnalyzer).  The level parameters are the port's
    own copy of the JAX package's level_params (an encoder has no learned
    weights).

    total is the reference's psum: each device sums its share's
    max_log2 costs in f32, and the partials are added in mesh order on
    the inputs' device.  XLA orders that f32 sum its own way, so total
    may differ from the JAX package's by the rounding of its additions;
    the tests hold it to rtol 1e-5."""
    mesh = list(mesh)
    levels = range(min_log2, max_log2 + 1)
    prms = {d: {lg: torch.as_tensor(
        level_params(qp, qp_y, qp_u, qp_v, bd, lg), device=d)
        for lg in levels} for d in set(mesh)}

    def fn(y, u, v):
        share = _share(y.shape[0], mesh)
        home = y.device
        maps = {lg: ([], []) for lg in levels}
        total = torch.zeros((), dtype=torch.float32, device=home)
        for j, d in enumerate(mesh):
            top = []
            with device_scope(d):
                for i in range(j * share, (j + 1) * share):
                    yi, ui, vi = (b[i].to(d, torch.float32)
                                  for b in (y, u, v))
                    for lg in levels:
                        m, c = _level_cost_impl(yi, ui, vi, prms[d][lg],
                                                bd=bd, lg=lg)
                        maps[lg][0].append(m.to(home))
                        maps[lg][1].append(c.to(home))
                        if lg == max_log2:
                            top.append(c)
                part = torch.stack(top).sum()
            total = total + part.to(home)
        out = []
        for lg in levels:
            out += [torch.stack(maps[lg][0]), torch.stack(maps[lg][1])]
        return tuple(out) + (total,)

    return fn
