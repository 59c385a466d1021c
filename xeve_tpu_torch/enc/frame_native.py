"""Native (C) closed-loop slice coding pass for I/P/B — fast path of
FramePass (enc/frame_pass.py).

Bit-exact with the numpy FramePass oracle (asserted in tests): same SBAC,
MC, RDOQ, transforms, MVP derivation, mode decisions, reconstruction and
deblocking semantics.  Mirrors the reference's serial pass-2 structure
(xeve_enc.c:416-596) with the closed-loop per-CU choice of xeve_mode.c.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..native.build import get_lib, XtFrameCfg, XtStats, XtRefPic

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _ref_pic(ref: dict, keep: list) -> XtRefPic:
    """Build an XtRefPic from a DPB entry dict (api.py _dpb_push layout)."""
    y = np.ascontiguousarray(ref["y_pad"], dtype=np.uint16)
    u = np.ascontiguousarray(ref["u_pad"], dtype=np.uint16)
    v = np.ascontiguousarray(ref["v_pad"], dtype=np.uint16)
    mv = np.ascontiguousarray(ref["map_mv"], dtype=np.int32)
    keep.extend((y, u, v, mv))
    return XtRefPic(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        mv.ctypes.data_as(_i32p),
        int(ref["poc"]), int(ref.get("list0_poc", ref["poc"])))


# baseline intra mode -> EIPD direction (DC, HOR, VER, UL diag, UR blend);
# used when a 5-mode analysis feeds the Main-profile coding pass
_B2M = np.array([0, 24, 12, 18, 6], dtype=np.uint8)


def encode_frame_native(w, h, bd, qp, qp_u_off, qp_v_off, slice_type, poc,
                        orig_y, orig_u, orig_v, analysis,
                        refp=None, refp1=None, pad_l=80,
                        use_rdoq=True, use_deblock=True,
                        main_eipd=0, tool_iqt=0, cm_init=0,
                        tile_cols=1, tile_rows=1, threads=1,
                        aq_map=None, cu_qp_delta_area=6, dquant_flag=0,
                        tool_ats=0, tool_htdf=0, tool_addb=0, sps_btt=0,
                        exact_rd=0):
    """Code one slice natively.  Returns (payload_bytes, bin_count,
    rec_y, rec_u, rec_v, map_mv, map_refi, tile_lens).  aq_map: per-SCU
    int8 qp offsets; enables cu_qp_delta coding."""
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
    h_scu, w_scu = (h + 3) >> 2, (w + 3) >> 2
    map_mv = np.zeros((h_scu, w_scu, 2, 2), dtype=np.int32)
    map_refi = np.full((h_scu, w_scu, 2), -1, dtype=np.int8)
    cap = w * h * 4 + 65536
    out = np.empty(cap, dtype=np.uint8)
    stats = XtStats()

    keep = []

    def u8_table(maps, default_like):
        tbl = (_u8p * 7)()
        for lg in range(2, 7):
            if maps is not None and lg in maps:
                a = np.ascontiguousarray(maps[lg], dtype=np.uint8)
            else:
                a = np.zeros((h >> lg, w >> lg), dtype=np.uint8)
            keep.append(a)
            tbl[lg] = a.ctypes.data_as(_u8p)
        return tbl

    def i32_table(maps):
        if maps is None:
            return None
        tbl = (_i32p * 7)()
        for lg in range(2, 7):
            if lg in maps:
                a = np.ascontiguousarray(maps[lg], dtype=np.int32)
            else:
                a = np.zeros((h >> lg, w >> lg, 2), dtype=np.int32)
            keep.append(a)
            tbl[lg] = a.ctypes.data_as(_i32p)
        return tbl

    mode_maps = analysis.mode
    if main_eipd and not getattr(analysis, "eipd_modes", False):
        mode_maps = {lg: _B2M[np.asarray(m, np.int64)]
                     for lg, m in analysis.mode.items()}
    split_tbl = u8_table(analysis.split, mode_maps)
    mode_tbl = u8_table(mode_maps, mode_maps)
    mv_tbl = i32_table(getattr(analysis, "mv", None))
    mv1_tbl = i32_table(getattr(analysis, "mv1", None))
    mv0b_tbl = i32_table(getattr(analysis, "mv0b", None))
    mv1b_tbl = i32_table(getattr(analysis, "mv1b", None))
    mvbi_tbl = i32_table(getattr(analysis, "mvbi", None))

    def _ref_list(lst):
        if not lst:
            return None, 0
        arr = (XtRefPic * len(lst))(*[_ref_pic(r, keep) for r in lst])
        keep.append(arr)
        return arr, len(lst)

    refs0, n0 = _ref_list(refp)
    refs1, n1 = _ref_list(refp1)

    if aq_map is not None:
        aq_arr = np.ascontiguousarray(aq_map, dtype=np.int8)
        keep.append(aq_arr)
        aq_ptr = aq_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        aq_ptr = None

    ret = lib.xt_encode_frame(
        ctypes.byref(cfg),
        ctypes.c_int32(slice_type), ctypes.c_int32(poc),
        ctypes.c_int32(pad_l),
        oy.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ou.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ov.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        refs0, ctypes.c_int32(n0),
        refs1, ctypes.c_int32(n1),
        split_tbl, mode_tbl,
        mv_tbl, mv1_tbl,
        mv0b_tbl, mv1b_tbl, mvbi_tbl,
        aq_ptr,
        out.ctypes.data_as(_u8p), ctypes.c_int64(cap),
        rec_y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rec_u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rec_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        map_mv.ctypes.data_as(_i32p),
        map_refi.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.byref(stats))
    if ret != 0:
        raise RuntimeError("native frame pass: output buffer overflow")
    payload = bytes(out[:stats.payload_bytes].tobytes())
    tile_lens = [int(stats.tile_len[i]) for i in range(stats.n_tiles)]
    return (payload, int(stats.bin_count),
            rec_y.astype(np.int32), rec_u.astype(np.int32),
            rec_v.astype(np.int32), map_mv, map_refi, tile_lens)
