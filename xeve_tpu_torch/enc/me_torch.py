"""Full-search integer motion estimation in plain PyTorch (port of
enc/me_jax.py).

This is the plain version of the hand-written kernel in
csrc/me_full_search.cu: the CPU runs it, and the card compares the
kernel against it.  Contract (analysis_inter_np.integer_me): for every
(dx, dy) in [-R, R]^2 the cost of a 16x16 block is its SAD plus
|dx| + |dy|, and the first minimum in raster order (dy outer, dx inner)
wins.
"""
from __future__ import annotations

import torch

BLK = 16


def integer_me_plain(cur, ref_pad, R: int, pad: int):
    """cur: (H, W) int32, H and W multiples of 16; ref_pad: (H + 2*pad,
    W + 2*pad) int32 on the same device.  Returns the best integer mv
    (nby, nbx, 2) int32 as (dx, dy) and its cost (nby, nbx) int32."""
    H, W = cur.shape
    nby, nbx = H // BLK, W // BLK
    dev = cur.device
    dxs = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    best_sad = torch.full((nby, nbx), torch.iinfo(torch.int32).max,
                          dtype=torch.int32, device=dev)
    best_dx = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    best_dy = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    for dy in range(-R, R + 1):
        # one row strip of candidates; the dx candidates are slices of it
        strip = ref_pad[pad + dy:pad + dy + H]
        cands = torch.stack([strip[:, pad - R + i:pad - R + i + W]
                             for i in range(2 * R + 1)])      # (2R+1, H, W)
        sads = (cur[None] - cands).abs() \
            .reshape(2 * R + 1, nby, BLK, nbx, BLK) \
            .sum(dim=(2, 4), dtype=torch.int32)
        sads = sads + (dxs.abs() + abs(dy))[:, None, None]
        am = torch.argmin(sads, dim=0)           # first minimum along dx
        mn = sads.amin(dim=0)
        upd = mn < best_sad                      # strict: earlier dy wins
        best_sad = torch.where(upd, mn, best_sad)
        best_dx = torch.where(upd, dxs[am], best_dx)
        best_dy = torch.where(upd, torch.full_like(best_dy, dy), best_dy)
    return torch.stack([best_dx, best_dy], dim=-1), best_sad

