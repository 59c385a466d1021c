"""Motion compensation, exact integer semantics of src_base/xeve_mc.c.

Quarter-pel luma (8-tap, phases 0/4/8/12 of the 1/16 table) and 1/8-pel
chroma (4-tap, phases 0,4,...,28 of the 1/32 table).  Reference pictures
are edge-padded (xeve_picbuf_expand) so MC may read outside the picture
after MV clipping (xeve_mv_clip allows +-MAX_CU_SIZE beyond the borders).
"""
from __future__ import annotations

import numpy as np

# xeve_tbl_mc_l_coeff rows 0/4/8/12 (xeve_mc.c:39)
MC_L_COEFF = {
    0: np.array([0, 0, 0, 64, 0, 0, 0, 0], dtype=np.int64),
    4: np.array([0, 1, -5, 52, 20, -5, 1, 0], dtype=np.int64),
    8: np.array([0, 2, -10, 40, 40, -10, 2, 0], dtype=np.int64),
    12: np.array([0, 1, -5, 20, 52, -5, 1, 0], dtype=np.int64),
}

# xeve_tbl_mc_c_coeff rows 0,4,...,28 (xeve_mc.c:59)
MC_C_COEFF = {
    0: np.array([0, 64, 0, 0], dtype=np.int64),
    4: np.array([-2, 58, 10, -2], dtype=np.int64),
    8: np.array([-4, 52, 20, -4], dtype=np.int64),
    12: np.array([-6, 46, 30, -6], dtype=np.int64),
    16: np.array([-8, 40, 40, -8], dtype=np.int64),
    20: np.array([-6, 30, 46, -6], dtype=np.int64),
    24: np.array([-4, 20, 52, -4], dtype=np.int64),
    28: np.array([-2, 10, 58, -2], dtype=np.int64),
}

MAX_CU_SIZE = 64


def mv_clip(x, y, pic_w, pic_h, w, h, mv):
    """xeve_mv_clip for one list (quarter-pel units)."""
    x4, y4, w4, h4 = x << 2, y << 2, w << 2, h << 2
    min_c = -(MAX_CU_SIZE << 2)
    max_x = (pic_w - 1 + MAX_CU_SIZE) << 2
    max_y = (pic_h - 1 + MAX_CU_SIZE) << 2
    mvx, mvy = int(mv[0]), int(mv[1])
    if x4 + mvx < min_c:
        mvx = min_c - x4
    if y4 + mvy < min_c:
        mvy = min_c - y4
    if x4 + mvx + w4 - 4 > max_x:
        mvx = max_x - x4 - w4 + 4
    if y4 + mvy + h4 - 4 > max_y:
        mvy = max_y - y4 - h4 + 4
    return mvx, mvy


def _interp_h(block, coeff, shift, offset):
    """Horizontal 8/4-tap on rows; block has taps-1 extra columns."""
    taps = len(coeff)
    h, w_ext = block.shape
    w = w_ext - taps + 1
    acc = np.zeros((h, w), dtype=np.int64)
    for k in range(taps):
        acc += coeff[k] * block[:, k:k + w]
    return (acc + offset) >> shift if shift else acc


def _interp_v(block, coeff, shift, offset):
    taps = len(coeff)
    h_ext, w = block.shape
    h = h_ext - taps + 1
    acc = np.zeros((h, w), dtype=np.int64)
    for k in range(taps):
        acc += coeff[k] * block[k:k + h, :]
    return (acc + offset) >> shift if shift else acc


def mc_luma(ref_pad: np.ndarray, pad: int, gmv_x: int, gmv_y: int,
            w: int, h: int, bit_depth: int) -> np.ndarray:
    """Luma MC; gmv in 1/16-pel units relative to the unpadded picture
    origin (i.e. (x<<2 + mv_qpel) << 2).  ref_pad is the padded picture,
    pad = padding amount on each side."""
    dx = gmv_x & 15
    dy = gmv_y & 15
    ix = (gmv_x >> 4) + pad
    iy = (gmv_y >> 4) + pad
    mx = (1 << bit_depth) - 1
    if dx == 0 and dy == 0:
        out = ref_pad[iy:iy + h, ix:ix + w].astype(np.int64)
        return out.astype(np.int32)
    if dy == 0:
        # single-direction paths use NO rounding offset (MAC_ADD_N0 == 0)
        blk = ref_pad[iy:iy + h, ix - 3:ix + w + 4].astype(np.int64)
        out = _interp_h(blk, MC_L_COEFF[dx], 6, 0)
        return np.clip(out, 0, mx).astype(np.int32)
    if dx == 0:
        blk = ref_pad[iy - 3:iy + h + 4, ix:ix + w].astype(np.int64)
        out = _interp_v(blk, MC_L_COEFF[dy], 6, 0)
        return np.clip(out, 0, mx).astype(np.int32)
    # separable: horizontal with shift1, vertical with shift2
    shift1 = min(4, bit_depth - 8)
    shift2 = max(8, 20 - bit_depth)
    blk = ref_pad[iy - 3:iy + h + 4, ix - 3:ix + w + 4].astype(np.int64)
    tmp = _interp_h(blk, MC_L_COEFF[dx], shift1, 0)
    tmp = tmp.astype(np.int16).astype(np.int64)       # s16 intermediate buffer
    out = _interp_v(tmp, MC_L_COEFF[dy], shift2, 1 << (shift2 - 1))
    return np.clip(out, 0, mx).astype(np.int32)


def mc_chroma(ref_pad: np.ndarray, pad: int, gmv_x: int, gmv_y: int,
              w: int, h: int, bit_depth: int) -> np.ndarray:
    """Chroma MC; gmv in 1/32 chroma-pel units."""
    dx = gmv_x & 31
    dy = gmv_y & 31
    ix = (gmv_x >> 5) + pad
    iy = (gmv_y >> 5) + pad
    mx = (1 << bit_depth) - 1
    if dx == 0 and dy == 0:
        return ref_pad[iy:iy + h, ix:ix + w].astype(np.int32)
    if dy == 0:
        blk = ref_pad[iy:iy + h, ix - 1:ix + w + 2].astype(np.int64)
        out = _interp_h(blk, MC_C_COEFF[dx], 6, 0)
        return np.clip(out, 0, mx).astype(np.int32)
    if dx == 0:
        blk = ref_pad[iy - 1:iy + h + 2, ix:ix + w].astype(np.int64)
        out = _interp_v(blk, MC_C_COEFF[dy], 6, 0)
        return np.clip(out, 0, mx).astype(np.int32)
    shift1 = min(4, bit_depth - 8)
    shift2 = max(8, 20 - bit_depth)
    blk = ref_pad[iy - 1:iy + h + 2, ix - 1:ix + w + 2].astype(np.int64)
    tmp = _interp_h(blk, MC_C_COEFF[dx], shift1, 0)
    tmp = tmp.astype(np.int16).astype(np.int64)
    out = _interp_v(tmp, MC_C_COEFF[dy], shift2, 1 << (shift2 - 1))
    return np.clip(out, 0, mx).astype(np.int32)


def mc_cu(x, y, w, h, mv_qpel, ref_y_pad, ref_u_pad, ref_v_pad, pad_l, pad_c,
          pic_w, pic_h, bit_depth):
    """Full-CU MC for one list (xeve_mc semantics, single ref).
    mv_qpel: (mvx, mvy) quarter-pel.  Returns (pred_y, pred_u, pred_v)."""
    mvx, mvy = mv_clip(x, y, pic_w, pic_h, w, h, mv_qpel)
    gx = ((x << 2) + mvx) << 2
    gy = ((y << 2) + mvy) << 2
    py = mc_luma(ref_y_pad, pad_l, gx, gy, w, h, bit_depth)
    pu = mc_chroma(ref_u_pad, pad_c, gx, gy, w >> 1, h >> 1, bit_depth)
    pv = mc_chroma(ref_v_pad, pad_c, gx, gy, w >> 1, h >> 1, bit_depth)
    return py, pu, pv


def pad_picture(plane: np.ndarray, pad: int) -> np.ndarray:
    """xeve_picbuf_expand: edge replication padding."""
    return np.pad(plane, pad, mode="edge")
