"""Native (C) closed-loop intra frame pass — fast path of IntraFramePass.

Bit-exact with the numpy IntraFramePass (asserted in tests): same SBAC,
RDOQ, transforms, reconstruction and deblocking semantics.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..native.build import get_lib, XtFrameCfg, XtStats
from .analysis_np import AnalysisResult


def encode_intra_frame_native(w, h, bd, qp, qp_u_off, qp_v_off,
                              orig_y, orig_u, orig_v,
                              analysis: AnalysisResult,
                              use_rdoq=True, use_deblock=True,
                              main_eipd=0, tool_iqt=0, cm_init=0,
                              tile_cols=1, tile_rows=1, threads=1,
                              aq_map=None, cu_qp_delta_area=6,
                              dquant_flag=0, tool_ats=0, tool_htdf=0, tool_addb=0, sps_btt=0,
                              exact_rd=0):
    """Returns (payload_bytes, bin_count, rec_y, rec_u, rec_v,
    tile_lens).  With main_eipd the Main-profile stage-1 pass runs
    (EIPD/IQT/CM_INIT/ADCC; mirrors enc/main_intra_frame.py).  aq_map:
    per-SCU int8 qp offsets; enables cu_qp_delta coding."""
    lib = get_lib()
    cfg = XtFrameCfg(w, h, bd, qp, qp_u_off, qp_v_off,
                     1 if use_rdoq else 0, 1 if use_deblock else 0,
                     main_eipd, tool_iqt, cm_init, tile_cols, tile_rows,
                     threads,
                     1 if aq_map is not None else 0, cu_qp_delta_area,
                     dquant_flag, tool_ats, tool_htdf, tool_addb, 0, 0,
                     sps_btt, 1 if exact_rd else 0)
    oy = np.ascontiguousarray(orig_y, dtype=np.int16)
    ou = np.ascontiguousarray(orig_u, dtype=np.int16)
    ov = np.ascontiguousarray(orig_v, dtype=np.int16)
    rec_y = np.empty((h, w), dtype=np.uint16)
    rec_u = np.empty((h // 2, w // 2), dtype=np.uint16)
    rec_v = np.empty((h // 2, w // 2), dtype=np.uint16)
    cap = w * h * 4 + 65536
    out = np.empty(cap, dtype=np.uint8)
    stats = XtStats()

    def u8(arr):
        a = np.ascontiguousarray(arr, dtype=np.uint8)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    keep = []
    split_ptrs = []
    mode_ptrs = []
    for lg in range(2, 7):
        shape = (h >> lg, w >> lg)
        if lg in analysis.split:
            a, p = u8(analysis.split[lg].astype(np.uint8))
        else:
            a, p = u8(np.zeros(shape, dtype=np.uint8))
        keep.append(a)
        split_ptrs.append(p)
        if lg in analysis.mode:
            a, p = u8(analysis.mode[lg].astype(np.uint8))
        else:
            a, p = u8(np.zeros(shape, dtype=np.uint8))
        keep.append(a)
        mode_ptrs.append(p)

    if aq_map is not None:
        aq_arr = np.ascontiguousarray(aq_map, dtype=np.int8)
        keep.append(aq_arr)
        aq_ptr = aq_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        aq_ptr = None
    fn = lib.xt_encode_main_intra_frame if main_eipd \
        else lib.xt_encode_intra_frame
    ret = fn(
        ctypes.byref(cfg),
        oy.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ou.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ov.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        *split_ptrs, *mode_ptrs,
        aq_ptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(cap),
        rec_y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rec_u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rec_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(stats))
    if ret != 0:
        raise RuntimeError("native intra pass: output buffer overflow")
    payload = bytes(out[:stats.payload_bytes].tobytes())
    tile_lens = [int(stats.tile_len[i]) for i in range(stats.n_tiles)]
    return (payload, int(stats.bin_count),
            rec_y.astype(np.int32), rec_u.astype(np.int32),
            rec_v.astype(np.int32), tile_lens)
