"""Frame-parallel analysis over several devices (port of
xeve_tpu/parallel/mesh.py).

A mesh is a list of torch devices.  meshed_subgop_analysis spreads the B
frames of a RA sub-GOP over it in contiguous shares, as the JAX package's
shard_map splits its "gop" axis, and runs each frame's single-device
fused graph (enc/device_analyzer._fused_impl) on its device.  Per-frame
math is the graph of the one-device dispatch, so the analysis, and the
stream of api.GopEncoder.encode_stream_meshed, do not depend on the mesh.
There are no collectives.

Not ported: meshed_analysis_step (xeve_tpu/parallel/mesh.py:73), a
batched intra analysis that sums a cost across the mesh with psum.
Nothing in the repo calls it, and that psum is the JAX package's only
collective.
"""
from __future__ import annotations

import torch

from ..device import device_scope, resolve_device
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
        if n % len(mesh):
            raise ValueError(f"batch of {n} does not split over "
                             f"{len(mesh)} devices")
        share = n // len(mesh)
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
