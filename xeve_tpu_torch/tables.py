"""Constant tables of the analysis, and their tensors on one device.

The analyzer has no learned parameters: these tables are what it carries
over from the JAX package.  The numpy sources are copies of the host-side
definitions in xeve_tpu/enc/analysis_jax.py and analysis_inter_jax.py
(which import jax); the tests hold each copy equal to its original.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import TM, SCAN

# scan rank matrices: rank of raster position (v,u) in zigzag order
# (analysis_jax.py:51)
_SCAN_RANK = {}
for _n in (2, 4, 8, 16, 32, 64):
    _r = np.empty(_n * _n, dtype=np.float32)
    _r[SCAN[(_n, _n)]] = np.arange(_n * _n, dtype=np.float32)
    _SCAN_RANK[_n] = _r.reshape(_n, _n)

# xeve_tbl_mc_l_coeff rows 0/4/8/12 (xeve_mc.c:39; analysis_inter_jax.py:36)
_MC_L = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                  [0, 1, -5, 52, 20, -5, 1, 0],
                  [0, 2, -10, 40, 40, -10, 2, 0],
                  [0, 1, -5, 20, 52, -5, 1, 0]], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _sel_matrices(s: int):
    """Constant one-hot selection matrices turning the UL/UR angular modes
    into matmuls: pred = SelUp @ up + SelLe @ left (+ mask * ul)
    (analysis_jax.py:93)."""
    n = s * s
    ul_up = np.zeros((n, 2 * s), np.float32)
    ul_le = np.zeros((n, 2 * s), np.float32)
    ul_c = np.zeros((s, s), np.float32)
    ur_up = np.zeros((n, 2 * s), np.float32)
    ur_le = np.zeros((n, 2 * s), np.float32)
    for i in range(s):
        for j in range(s):
            d = i - j
            p = i * s + j
            if d > 0:
                ul_le[p, d - 1] = 1.0
            elif d == 0:
                ul_c[i, j] = 1.0
            else:
                ul_up[p, -d - 1] = 1.0
            ur_up[p, i + j + 1] = 0.5
            ur_le[p, i + j + 1] = 0.5
    return ul_up, ul_le, ul_c, ur_up, ur_le


@functools.lru_cache(maxsize=None)
def load_tables(device: torch.device) -> dict:
    """The tables as f32 tensors on `device`: "tm" and "scan_rank" keyed by
    block size, "sel" by block size (the five _sel_matrices)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    sizes = (2, 4, 8, 16, 32, 64)
    return {
        "tm": {n: t(TM[n]) for n in sizes},
        "scan_rank": {n: t(_SCAN_RANK[n]) for n in sizes},
        "sel": {n: tuple(t(m) for m in _sel_matrices(n)) for n in sizes},
    }
