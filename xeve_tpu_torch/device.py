"""Device and precision policy of the port.

Every entry point takes an explicit device.  "cuda" means the card and
fails where there is none: the port never continues on the CPU in its
place.  The CPU runs only when a caller asks for it (the tests do).
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`, with TF32 off.

    The analysis costs are f32 products of integer-valued transforms; TF32
    keeps about three decimal digits and would move mode decisions (the
    JAX package forces Precision.HIGHEST for the same reason,
    winmc_jax.py:73-75)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch "
                               "finds no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_scope(dev: torch.device):
    """A context that makes `dev` the current CUDA device (a thread starts
    on device 0 whatever its parent chose); no-op for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
