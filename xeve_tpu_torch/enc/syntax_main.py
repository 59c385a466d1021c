"""Main-profile CU syntax writers (EIPD intra direction, chroma direction,
ADCC coefficients).  Bit-exact counterparts of the reference encoder
(xevem_eco.c:1514 xevem_eco_intra_dir, :1598 xevem_eco_intra_dir_c,
:1103 xeve_eco_adcc) and exact inverses of dec/decoder.py's read paths.
"""
from __future__ import annotations

import numpy as np

from ..entropy.sbac import SbacEncoder, SbacCtx
from ..entropy import adcc
from ..ops import intra_main_np as im


def write_intra_dir_main(sbac: SbacEncoder, ctx: SbacCtx, ipm: int,
                         mpm, mpm_ext, pims):
    """EIPD luma direction (xevem_eco.c:1541)."""
    if ipm == mpm[0] or ipm == mpm[1]:
        sbac.encode_bin(1, ctx.intra_luma_pred_mpm_flag, 0)
        sbac.encode_bin(0 if ipm == mpm[0] else 1,
                        ctx.intra_luma_pred_mpm_idx, 0)
        return
    sbac.encode_bin(0, ctx.intra_luma_pred_mpm_flag, 0)
    for i in range(8):
        if ipm == mpm_ext[i]:
            sbac.encode_bin_ep(1)
            sbac.encode_bins_ep(i, 3)
            return
    sbac.encode_bin_ep(0)
    rank = -1
    for i in range(im.IPD_CNT):
        if ipm == pims[i]:
            rank = i - 10
            break
    assert rank >= 0, "mode missing from pims ordering"
    # truncated binary over IPD_CNT-10 == 23 symbols (threshold 4)
    val, b = 16, (im.IPD_CNT - 10) - 16
    if rank < val - b:
        sbac.encode_bins_ep(rank, 4)
    else:
        sbac.encode_bins_ep(rank + (val - b), 5)


def write_intra_dir_c_main(sbac: SbacEncoder, ctx: SbacCtx, ipm_c: int,
                           ipm_l: int):
    """Chroma direction (xevem_eco.c:1598)."""
    if ipm_c == im.IPD_DM_C:
        sbac.encode_bin(1, ctx.intra_chroma_pred_mode, 0)
        return
    sbac.encode_bin(0, ctx.intra_chroma_pred_mode, 0)
    conv, chk = im.conv_luma_to_chroma(ipm_l)
    remain = ipm_c - 2 if (chk and ipm_c > conv) else ipm_c - 1
    # unary EP capped at IPD_CHROMA_CNT-1 bins (xevem_eco.c:45)
    max_val = im.IPD_CHROMA_CNT - 1
    sbac.encode_bin_ep(1 if remain else 0)
    icounter = 1
    while remain:
        remain -= 1
        if icounter < max_val:
            sbac.encode_bin_ep(1 if remain else 0)
            icounter += 1


def write_coef_block_main(sbac: SbacEncoder, ctx: SbacCtx,
                          levels: np.ndarray, ch_type: int):
    """ADCC coefficient block (xevem_eco.c:1103)."""
    adcc.encode_block(sbac, ctx, levels, ch_type)
