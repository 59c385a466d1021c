"""Spec constants for MPEG-5 EVC (ISO/IEC 23094-1), Baseline profile first.

Interoperability constants (transform matrices, scan orders, MPM ranking,
quant scales, deblock strength table, chroma-QP mapping) as required by the
bitstream spec.  Values are cross-checked in tests against the behaviour of
the reference encoder (its xeve_tbl.c holds the corresponding tables:
DCT-2 matrices at xeve_tbl.c:83-236, dequant scales :237, deblock strengths
:239, chroma QP :259, MPM :40).  The port's copy of xeve_tpu/constants.py;
tests hold every value to the original's.

The DCT-2 matrices are *generated* from the canonical formula
    T[n][k] = round(64 * sqrt(N) * T_ortho[n][k]),
    T_ortho[n][k] = sqrt(2/N) * c_n * cos(pi*(2k+1)*n/(2N)),  c_0 = 1/sqrt(2)
which reproduces the spec's 7-bit integer DCT exactly for N = 2..64.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Block geometry
# ---------------------------------------------------------------------------
MIN_CU_LOG2 = 2
MIN_CU_SIZE = 1 << MIN_CU_LOG2
MAX_CU_LOG2_BASE = 6      # Baseline profile CTU 64x64
MAX_TR_LOG2 = 6           # max transform 64
MAX_TX_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
QUANT_IQUANT_SHIFT = 20

# ---------------------------------------------------------------------------
# Intra prediction modes (Baseline)
# ---------------------------------------------------------------------------
IPD_DC_B = 0
IPD_HOR_B = 1
IPD_VER_B = 2
IPD_UL_B = 3
IPD_UR_B = 4
IPD_CNT_B = 5

# ---------------------------------------------------------------------------
# Slice / NAL
# ---------------------------------------------------------------------------
SLICE_B = 0
SLICE_P = 1
SLICE_I = 2

NUT_NONIDR = 0
NUT_IDR = 1
NUT_SPS = 24
NUT_PPS = 25
NUT_APS = 26
NUT_FD = 27
NUT_SEI = 28

PROFILE_BASELINE = 0
PROFILE_MAIN = 1

# ---------------------------------------------------------------------------
# Quantization (xeve_tq.c:37, xeve_tbl.c:237)
# ---------------------------------------------------------------------------
# [tool_iqt][qp % 6]; Baseline uses tool_iqt = 0
QUANT_SCALE = np.array(
    [[26214, 23302, 20560, 18396, 16384, 14764],
     [26214, 23302, 20560, 18396, 16384, 14564]], dtype=np.int64)
DQUANT_SCALE_B = np.array([40, 45, 51, 57, 64, 71], dtype=np.int64)

MAX_QUANT = 51
MIN_QUANT = 0

# ---------------------------------------------------------------------------
# Chroma QP adjustment (derived table used when no explicit chroma QP table is
# signalled; same values as H.264/HEVC table for QP>=30; xeve_tbl.c:259)
# ---------------------------------------------------------------------------
QP_CHROMA_ADJUST = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
     10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
     29, 29, 30, 31, 32, 32, 33, 33, 34, 34,
     35, 35, 36, 36, 36, 37, 37, 37, 38, 38,
     39, 39, 40, 40, 40, 41, 41, 41],
    dtype=np.int32)


# Main-profile chroma QP mapping, selected when tool_iqt is on
# (xevem_tbl.c:102 xevem_tbl_qp_chroma_ajudst; chosen at xevem_util.c:3115)
QP_CHROMA_ADJUST_MAIN = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
     10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
     29, 30, 31, 32, 33, 34, 35, 36, 37, 37,
     38, 39, 40, 40, 41, 42, 43, 44, 45, 46,
     47, 48, 49, 50, 51, 52, 53, 54],
    dtype=np.int32)

# IQT dequant scales (xevem_tbl.c:53); baseline differs only at qp%6==5
DQUANT_SCALE_MAIN = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)


def chroma_qp_dynamic(qp: int, main: int = 0) -> int:
    """Chroma QP from (clipped) luma-derived index; negative indices map to 0
    padding as in the reference's qp_chroma_dynamic_ext layout."""
    if qp < 0:
        return 0
    tbl = QP_CHROMA_ADJUST_MAIN if main else QP_CHROMA_ADJUST
    return int(tbl[qp])

# ---------------------------------------------------------------------------
# Deblocking strength table st[idx][qp] (xeve_tbl.c:239 xeve_tbl_df_st[4][52])
# idx: 0 = at least one side intra, 1 = coded (cbf) edge, 2 = mv-discontinuous,
#      3 = smooth
# ---------------------------------------------------------------------------
DF_ST = np.array([
    # at least one side intra
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     12, 12, 12, 12, 12],
    # non-zero luma coefficients on either side
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10,
     11, 11, 11, 11, 11],
    # no coefficients but |mvd| >= 4 (quarter-pel units)
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 6, 7, 8, 9,
     10, 10, 10, 10, 10],
    # smooth: no filtering
    [0] * 52,
], dtype=np.int32)

# ---------------------------------------------------------------------------
# MPM ranking table (Baseline; xeve_tbl.c:40 xeve_tbl_mpm[6][6][5]).
# mpm_rank = MPM_TBL[ipm_left][ipm_up][ipm]; neighbour indices are
# (neighbour_ipm + 1) when the neighbour is an available intra block in the
# same tile, else 0.
# ---------------------------------------------------------------------------
MPM_TBL = np.array([
    [[0, 2, 3, 1, 4], [0, 2, 1, 3, 4], [0, 2, 1, 3, 4], [1, 2, 0, 3, 4], [0, 2, 1, 3, 4], [0, 1, 2, 3, 4]],
    [[1, 0, 2, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [1, 2, 0, 3, 4], [0, 1, 3, 2, 4], [0, 2, 1, 4, 3]],
    [[1, 0, 2, 3, 4], [1, 0, 2, 3, 4], [1, 0, 2, 3, 4], [2, 0, 1, 3, 4], [1, 0, 3, 2, 4], [0, 1, 2, 4, 3]],
    [[1, 0, 2, 3, 4], [0, 2, 1, 3, 4], [1, 0, 2, 3, 4], [1, 2, 0, 3, 4], [0, 1, 2, 3, 4], [0, 2, 1, 4, 3]],
    [[0, 1, 2, 3, 4], [0, 3, 2, 1, 4], [1, 0, 2, 3, 4], [1, 2, 0, 3, 4], [1, 2, 3, 0, 4], [0, 2, 1, 4, 3]],
    [[0, 1, 2, 3, 4], [0, 1, 2, 4, 3], [0, 1, 2, 4, 3], [0, 2, 1, 4, 3], [0, 1, 2, 3, 4], [0, 1, 2, 4, 3]],
], dtype=np.int32)

# ---------------------------------------------------------------------------
# DCT-2 integer matrices, generated (verified vs xeve_tbl.c:83-236 in tests)
# ---------------------------------------------------------------------------


def dct2_matrix(n: int) -> np.ndarray:
    """Integer DCT-2 matrix of size n (7-bit, max |value| <= 91)."""
    k = np.arange(n)
    row = np.arange(n)[:, None]
    t = np.cos(np.pi * (2 * k[None, :] + 1) * row / (2 * n))
    c = np.full((n, 1), np.sqrt(2.0 / n))
    c[0] *= 1.0 / np.sqrt(2.0)
    ortho = c * t
    return np.round(64.0 * np.sqrt(n) * ortho).astype(np.int64)


TM = {n: dct2_matrix(n) for n in (2, 4, 8, 16, 32, 64)}

# ---------------------------------------------------------------------------
# Zig-zag scan order (xeve_util.c:1085 init_scan, COEF_SCAN_ZIGZAG)
# scan[pos] -> raster index within the (size_x, size_y) block
# ---------------------------------------------------------------------------


def zigzag_scan(size_x: int, size_y: int) -> np.ndarray:
    scan = np.empty(size_x * size_y, dtype=np.int32)
    pos = 0
    scan[pos] = 0
    pos += 1
    for l in range(1, size_x + size_y - 1):
        if l % 2:  # going down-left
            x = min(l, size_x - 1)
            y = max(0, l - (size_x - 1))
            while x >= 0 and y < size_y:
                scan[pos] = y * size_x + x
                pos += 1
                x -= 1
                y += 1
        else:  # going up-right
            y = min(l, size_y - 1)
            x = max(0, l - (size_y - 1))
            while y >= 0 and x < size_x:
                scan[pos] = y * size_x + x
                pos += 1
                x += 1
                y -= 1
    return scan


SCAN = {}
for _lw in range(0, 7):
    for _lh in range(0, 7):
        SCAN[(1 << _lw, 1 << _lh)] = zigzag_scan(1 << _lw, 1 << _lh)


# ---------------------------------------------------------------------------
# Hierarchical-QP adaptation for GOPs (xeve_tbl.c:564 xeve_qp_adapt_param_*)
# Only the all-intra row is needed for the AI path; LD/RA rows are used once
# inter coding lands.  Each entry: (qp_offset_layer, model_scale, model_offset)
# ---------------------------------------------------------------------------
# entries: (qp_offset_layer, qp_offset_model_offset, qp_offset_model_scale)
QP_ADAPT_AI = [(0, 0.0, 0.0)] * 8
# RA gop16 (xeve_qp_adapt_param_ra[1])
QP_ADAPT_RA16 = [(-3, 0.0, 0.0), (1, 0.0, 0.0),
                 (1, -4.8848, 0.2061), (4, -5.7476, 0.2286),
                 (5, -5.9000, 0.2333), (6, -7.1444, 0.3000),
                 (7, -7.1444, 0.3000), (8, -7.1444, 0.3000)]
QP_ADAPT_LD = [(-1, 0.0, 0.0), (1, 0.0, 0.0),
               (4, -6.5, 0.2590), (4, -6.5, 0.2590),
               (5, -6.5, 0.2590), (5, -6.5, 0.2590),
               (5, -6.5, 0.2590), (5, -6.5, 0.2590)]

# lambda model (xeve_enc.c:1515)


def lambda_from_qp(qp: float) -> float:
    return 0.57 * (2.0 ** ((qp - 12.0) / 3.0))
