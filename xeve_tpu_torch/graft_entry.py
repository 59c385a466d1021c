"""Driver entry points of the port (the twin of __graft_entry__.py).

entry(device)                -> (fn, args): one intra analysis level of
                                the all-intra encoder, on `device`.
dryrun_multichip(n, device)  -> a RA GOP16 encode whose sub-GOP B-frame
                                analyses run one per device over an
                                n-device mesh; its stream decodes.
"""
from __future__ import annotations

import functools
import importlib.util
import os

import numpy as np
import torch

from .device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cuda"):
    """`_level_cost_impl` at lg 4 on 128x128 random 10-bit planes
    (RandomState(0)), QP 32: fn(*args) gives the per-block best mode and
    its cost."""
    from .enc.analysis_torch import _level_cost_impl, level_params
    dev = resolve_device(device)
    w, h = 128, 128
    rng = np.random.RandomState(0)

    def plane(ph, pw):
        return torch.as_tensor(rng.randint(0, 1024, (ph, pw)),
                               dtype=torch.float32, device=dev)

    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    prm = torch.as_tensor(level_params(32, 44, 41, 41, 10, 4), device=dev)
    fn = functools.partial(_level_cost_impl, bd=10, lg=4)
    return fn, (y, u, v, prm)


def _gen_frame():
    """tools/gen_test_content.gen_frame, loaded by path (tools/ is a
    directory of scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "gen_test_content", os.path.join(ROOT, "tools", "gen_test_content.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gen_frame


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The device engine's RA GOP16 path over make_mesh(n_devices,
    device): 18 frames at 128x64, QP 33, the sub-GOP's B-frame analyses
    one per device, the native C pass; asserts 18 outputs and 18 frames
    decoded by the port's decoder."""
    from .api import GopEncoder
    from .dec.decoder import BaselineIntraDecoder
    from .params import EncoderParams
    from .parallel.mesh import make_mesh

    gen_frame = _gen_frame()
    w, h = 128, 64
    mesh = make_mesh(n_devices, device)
    frames = []
    for t in range(18):
        y, u, v = gen_frame(w, h, t)
        frames.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                       v.astype(np.int16) << 2))
    enc = GopEncoder(EncoderParams(w=w, h=h, qp=33, keyint=0, bframes=15),
                     analysis="device", coder="native", device=device)
    stream = b""
    n_out = 0
    for bs, _rec, _poc in enc.encode_stream_meshed(iter(frames), mesh):
        stream += bs
        n_out += 1
    assert n_out == 18
    decoded = BaselineIntraDecoder().decode(stream)
    assert len(decoded) == 18
