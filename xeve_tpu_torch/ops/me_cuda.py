"""Full-search integer ME: the wrapper of csrc/me_full_search.cu.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
runs the plain version, enc/me_torch.integer_me_plain.  LAUNCHES counts
the kernel's launches.  integer_me_np is the numpy-facing form that the
numpy engine's `me_engine` route calls.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..enc.me_torch import BLK, integer_me_plain
from . import _build

LAUNCHES = 0


def _lib():
    lib = _build.load("me_full_search")
    fn = lib.xt_me_full_search
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def integer_me(cur, ref_pad, pad: int, R: int):
    """cur: (hc, wc) int32, hc and wc multiples of 16; ref_pad: the padded
    reference cropped to (hc + 2*pad, wc + 2*pad) int32 on the same device
    (analysis_inter_jax.py:174-177).  Returns mv (nby, nbx, 2) int32 as
    (dx, dy) and cost (nby, nbx) int32."""
    global LAUNCHES
    hc, wc = cur.shape
    if hc % BLK or wc % BLK or hc == 0 or wc == 0:
        raise ValueError(f"cur {tuple(cur.shape)} is not a multiple of {BLK}")
    if tuple(ref_pad.shape) != (hc + 2 * pad, wc + 2 * pad):
        raise ValueError(f"ref_pad {tuple(ref_pad.shape)} does not match cur "
                         f"{tuple(cur.shape)} with pad {pad}")
    if not 0 <= R <= pad:
        raise ValueError(f"search range {R} must lie in [0, pad={pad}]")
    if cur.dtype != torch.int32 or ref_pad.dtype != torch.int32:
        raise TypeError("integer_me takes int32 planes")
    if cur.device != ref_pad.device:
        raise ValueError("cur and ref_pad lie on different devices")
    if cur.device.type == "cpu":
        return integer_me_plain(cur, ref_pad, R, pad)
    if cur.device.type != "cuda":
        raise ValueError(f"no ME kernel for device {cur.device}")
    fn = _lib()
    cur = cur.contiguous()
    ref_pad = ref_pad.contiguous()
    mv = torch.empty((hc // BLK, wc // BLK, 2), dtype=torch.int32,
                     device=cur.device)
    cost = torch.empty((hc // BLK, wc // BLK), dtype=torch.int32,
                       device=cur.device)
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    err = fn(cur.data_ptr(), ref_pad.data_ptr(), mv.data_ptr(),
             cost.data_ptr(), hc, wc, pad, R, stream)
    if err != 0:
        raise RuntimeError(f"me_full_search launch failed: cudaError {err}")
    LAUNCHES += 1
    return mv, cost


def integer_me_np(cur_y, ref_y_pad, pad: int, search_range: int = 16, *,
                  device):
    """analysis_inter_np.integer_me's contract on `device`: numpy planes
    in, the 16-aligned region searched (the crop of
    analysis_inter_torch._int_mv), numpy mv (nby, nbx, 2) int32 and cost
    (nby, nbx) int64 out.  A CUDA device launches the kernel, the CPU runs
    the plain version."""
    h, w = cur_y.shape
    hc, wc = (h // BLK) * BLK, (w // BLK) * BLK
    cur = torch.as_tensor(np.ascontiguousarray(cur_y[:hc, :wc], np.int32))
    ref = torch.as_tensor(np.ascontiguousarray(
        ref_y_pad[:2 * pad + hc, :2 * pad + wc], np.int32))
    mv, cost = integer_me(cur.to(device), ref.to(device), pad,
                          int(search_range))
    return mv.cpu().numpy(), cost.cpu().numpy().astype(np.int64)
