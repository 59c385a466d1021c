"""Conformance decoder for EVC Baseline (all-intra subset first).

This decoder is the correctness oracle of the framework: it must decode both
our own bitstreams and the reference encoder's (xeve) bitstreams to the exact
reconstruction the encoder produced.  It is written for clarity (numpy +
Python), not speed.

Syntax/semantics derived from the reference encoder:
  - NAL/SPS/PPS/SH: src_base/xeve_eco.c:45-290
  - CTU tree + CU syntax: src_base/xeve_enc.c:35-101 (xeve_eco_tree),
    src_base/xeve_eco.c:1431-1654 (xeve_eco_unit)
  - coefficient run-length decode: src_base/xeve_eco.c:707-771
  - intra reconstruction: src_base/xeve_ipred.c, xeve_itdq.c, xeve_recon.c
  - deblocking: src_base/xeve_df.c (vertical edges pass then horizontal)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    MIN_CU_LOG2, MIN_CU_SIZE, MPM_TBL, SCAN, SLICE_I, SLICE_P,
    NUT_IDR, NUT_NONIDR, NUT_SPS, NUT_PPS, NUT_SEI, NUT_APS,
    IPD_CNT_B, chroma_qp_dynamic,
)
from ..hls import SPS, PPS, SliceHeader, split_nals
from ..io.bits import BitReader
from ..entropy.sbac import SbacDecoder, SbacCtx
from ..ops import reference_kernels as rk
from ..ops import mc_np
from ..ops import motion_np
from ..ops import intra_main_np as im

# rank -> ipm inverse of MPM table
MPM_INV = np.zeros_like(MPM_TBL)
for _l in range(6):
    for _u in range(6):
        for _ipm in range(5):
            MPM_INV[_l, _u, MPM_TBL[_l, _u, _ipm]] = _ipm


class DecodeError(Exception):
    """Raised when the bitstream is malformed/truncated."""


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    poc: int = 0
    slice_type: int = SLICE_I
    qp: int = 32
    crop_w: int = 0     # displayed size per SPS cropping (0 = full)
    crop_h: int = 0

    def display(self):
        """(y, u, v) cropped to the signalled display size."""
        if not self.crop_w:
            return self.y, self.u, self.v
        return (self.y[:self.crop_h, :self.crop_w],
                self.u[:self.crop_h // 2, :self.crop_w // 2],
                self.v[:self.crop_h // 2, :self.crop_w // 2])


class BaselineIntraDecoder:
    """Decodes Baseline-profile streams (I and low-delay P slices)."""

    def __init__(self, trace=None):
        # optional syntax trace sink (file-like); mirrors the reference's
        # ENC_DEC_TRACE format so streams can be diffed element-by-element
        self.trace = trace
        self.trace_counter = 0
        self.sps: SPS | None = None
        self.pps: PPS | None = None
        self.frames: list[DecodedFrame] = []
        self.dpb: list[dict] = []      # ref pics: poc desc order maintained
        self.poc = 0
        self.last_intra_poc = -(10 ** 9)
        self.pad_l = 64 + 16           # PIC_PAD_SIZE_L
        self.saw_refi1 = False         # any CU decoded with refi > 0

    # -- top level ----------------------------------------------------------
    def decode(self, stream: bytes) -> list[DecodedFrame]:
        try:
            return self._decode_stream(stream)
        except DecodeError:
            raise
        except (IndexError, AssertionError, ValueError) as e:
            raise DecodeError(f"malformed or truncated bitstream: {e}") from e

    def _decode_stream(self, stream: bytes) -> list[DecodedFrame]:
        for hdr, payload, _full in split_nals(stream):
            if hdr.nal_unit_type == NUT_SPS:
                self.sps = SPS.parse(BitReader(payload))
                self._setup_dims()
            elif hdr.nal_unit_type == NUT_PPS:
                self.pps = PPS.parse(BitReader(payload),
                                     main=self.sps.profile_idc == 1)
            elif hdr.nal_unit_type in (NUT_IDR, NUT_NONIDR):
                self._decode_slice(payload, hdr.nal_unit_type,
                                   hdr.nuh_temporal_id)
            elif hdr.nal_unit_type == NUT_SEI:
                self._check_sei(payload)
            elif hdr.nal_unit_type == NUT_APS:
                self._parse_aps(payload)
            else:
                pass
        return self.frames

    def _parse_aps(self, payload: bytes):
        """APS NAL (xevem_eco_aps_gen inverse, xevem_eco.c:235): type 0 =
        ALF (not yet supported), type 1 = DRA descriptor."""
        br = BitReader(payload)
        aps_id = br.read(5)
        aps_type = br.read(3)
        if aps_type == 1:
            from ..ops.dra_np import SigParamDRA
            sig = SigParamDRA.parse(br, self.sps.bit_depth_luma_minus8 + 8)
            if not hasattr(self, "dra_aps"):
                self.dra_aps = {}
            self.dra_aps[aps_id] = sig
            self._dra_maps = None        # invalidate LUT cache

    def _check_sei(self, payload: bytes):
        """Verify picture-signature SEI (payload type 0x10): per-plane MD5
        of the last decoded picture (xeve_eco.c:292-322 semantics)."""
        import hashlib
        if len(payload) < 2 or payload[0] != 0x10 or not self.frames:
            return
        digests = payload[2:2 + 48]
        if len(digests) < 48:
            return
        f = self.frames[-1]
        for i, plane in enumerate((f.y, f.u, f.v)):
            want = digests[i * 16:(i + 1) * 16]
            got = hashlib.md5(plane.astype("<u2").tobytes()).digest()
            if want != got:
                raise DecodeError(
                    f"picture-signature SEI mismatch on plane {i} (poc {f.poc})")
        self.signatures_checked = getattr(self, "signatures_checked", 0) + 1

    def _setup_dims(self):
        s = self.sps
        self.w = s.pic_width_in_luma_samples
        self.h = s.pic_height_in_luma_samples
        self.bd = s.bit_depth_luma_minus8 + 8
        self.max_cuwh = s.max_cuwh  # 64 unless Main btt raises it
        self.log2_max_cuwh = self.max_cuwh.bit_length() - 1
        self.w_lcu = (self.w + self.max_cuwh - 1) // self.max_cuwh
        self.h_lcu = (self.h + self.max_cuwh - 1) // self.max_cuwh
        self.w_scu = (self.w + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        self.h_scu = (self.h + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        # BTT split-allow limits from the SPS geometry fields, mirroring
        # the encoder's split_check derivation (xevem_mode.c:2575-2582,
        # xevem_util.c:3163-3167): per aspect class, (log2max, log2min)
        # of the LONG side
        if s.sps_btt_flag:
            lg_ctu = self.log2_max_cuwh
            b11_min = 2 + s.log2_min_cb_size_minus2
            self.min_cuwh = 1 << b11_min
            self.split_check = {
                "b11": (lg_ctu, b11_min),
                "b12": (lg_ctu, b11_min + 1),
                "b14": (lg_ctu - s.log2_diff_ctu_max_14_cb_size,
                        b11_min + 2),
                "tt": (lg_ctu - s.log2_diff_ctu_max_tt_cb_size,
                       s.log2_diff_min_cb_min_tt_cb_size_minus2
                       + b11_min + 2),
            }
        else:
            self.min_cuwh = 4
            self.split_check = None

    # -- slice decode -------------------------------------------------------
    def _derive_poc(self, nut: int, tid: int):
        """xeve_poc_derivation (xeve_util.c:250-281) from decode order +
        temporal id; LD (sub_gop 1) degenerates to poc += 1."""
        if nut == NUT_IDR:
            self.poc = 0
            self.prev_poc_val = 0
            self.prev_doc_offset = 0
            return
        sub_gop = 1 << self.sps.log2_sub_gop_length
        if sub_gop <= 1:
            self.poc += 1
            return
        if tid == 0:
            self.poc = self.prev_poc_val + sub_gop
            self.prev_doc_offset = 0
            self.prev_poc_val = self.poc
            return
        doc_offset = (self.prev_doc_offset + 1) % sub_gop
        if doc_offset == 0:
            self.prev_poc_val += sub_gop
            expected_tid = 0
        else:
            expected_tid = 1 + int(np.log2(doc_offset))
        while tid != expected_tid:
            doc_offset = (doc_offset + 1) % sub_gop
            if doc_offset == 0:
                expected_tid = 0
            else:
                expected_tid = 1 + int(np.log2(doc_offset))
        poc_offset = int(sub_gop * ((2.0 * doc_offset + 1) / (1 << tid) - 2))
        self.poc = self.prev_poc_val + poc_offset
        self.prev_doc_offset = doc_offset

    def _decode_slice(self, payload: bytes, nut: int, tid: int = 0):
        br = BitReader(payload)
        sh = SliceHeader.parse(br, nut, self.sps, self.pps)
        # I, P and B (low-delay / random-access) slices supported
        assert br.is_byte_aligned()
        self.tid = tid
        if self.sps.tool_pocs and nut != NUT_IDR:
            # explicit POC signalling (sh.poc_lsb) with MSB wrap derivation
            # (spec 8.3.1 analog; xeve writes poc & (max_lsb-1))
            max_lsb = 1 << (self.sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            prev = getattr(self, "prev_poc_lsb_val", 0)
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            lsb = sh.poc_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            self.poc = msb + lsb
            if tid == 0:
                self.prev_poc_lsb_val = self.poc
        else:
            self._derive_poc(nut, tid)
            if self.sps.tool_pocs:
                self.prev_poc_lsb_val = 0
        if nut == NUT_IDR:
            self.dpb.clear()
        if sh.slice_type == SLICE_I:
            self.last_intra_poc = self.poc
        if self.sps.tool_rpl and sh.slice_type != SLICE_I and self.poc != 0:
            # RPL reference marking (xevem_picman.c:632): DPB refs in
            # neither of the slice's lists become unreferenced
            keep = set()
            for rpl in (sh.rpl_l0, sh.rpl_l1):
                if rpl is not None:
                    for d in rpl.ref_pics:
                        keep.add(self.poc - d)
            for pic in self.dpb:
                if pic.get("ref", True) and pic["poc"] not in keep:
                    pic["ref"] = False
        # reference lists (xeve_picman_refp_init, layer 0)
        self.refp = []
        self.refp1 = []
        max_refs = self.sps.max_num_ref_pics or 21
        if self.sps.tool_rpl and sh.slice_type != SLICE_I:
            # explicit RPL-based construction (xevem_picman.c:578):
            # refp[i] = DPB pic at poc - ref_pics[i], active-count entries
            by_poc = {p["poc"]: p for p in self.dpb if p.get("ref", True)}
            n0, n1 = sh.num_ref_idx_active
            rp0 = sh.rpl_l0.ref_pics if sh.rpl_l0 is not None else []
            rp1 = sh.rpl_l1.ref_pics if sh.rpl_l1 is not None else []
            self.refp = [by_poc[self.poc - d] for d in rp0[:n0]]
            if sh.slice_type != SLICE_P:
                self.refp1 = [by_poc[self.poc - d] for d in rp1[:n1]]
        elif sh.slice_type != SLICE_I:
            marked = [p for p in self.dpb if p.get("ref", True)]
            usable = [p for p in marked
                      if not (self.poc >= self.last_intra_poc and
                              p["poc"] < self.last_intra_poc)]
            usable.sort(key=lambda p: -p["poc"])
            past = [p for p in usable if p["poc"] < self.poc]      # poc desc
            future = sorted([p for p in usable if p["poc"] > self.poc],
                            key=lambda p: p["poc"])                # poc asc

            tid = self.tid

            def build(first, second, constrain_first=True):
                out = []
                next_lid = max(tid - 1, 0)
                for p in first:
                    if len(out) >= max_refs:
                        break
                    if not constrain_first or p["tid"] <= next_lid:
                        out.append(p)
                        next_lid = max(p["tid"] - 1, 0)
                next_lid = max(tid - 1, 0)
                for p in second:
                    if len(out) >= max_refs:
                        break
                    if p["tid"] <= next_lid:
                        out.append(p)
                        next_lid = max(p["tid"] - 1, 0)
                return out

            if sh.slice_type == SLICE_P:
                # layer-0 P: plain closest-past, no tid constraint
                self.refp = build(past, [], constrain_first=(tid > 0))
            else:
                self.refp = build(past, future)
                self.refp1 = build(future, past)
        sbac = SbacDecoder(payload, br.byte_pos)
        if self.trace is not None and getattr(self, "trace_bins", False):
            sbac.trace_hook = self._tr
        ctx = SbacCtx(sh.slice_type, sh.qp, self.sps.tool_cm_init)

        w, h, bd = self.w, self.h, self.bd
        mid = 1 << (bd - 1)
        # reconstruction planes (pre-deblock)
        self.rec_y = np.full((h, w), mid, dtype=np.int32)
        self.rec_u = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        self.rec_v = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        # SCU maps
        self.map_cod = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_logw = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.map_logh = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        self.map_if = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_skip = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_ipm = np.full((self.h_scu, self.w_scu), -1, dtype=np.int32)
        self.map_qp = np.full((self.h_scu, self.w_scu), sh.qp, dtype=np.int32)
        self.map_cbf_l = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_mv = np.zeros((self.h_scu, self.w_scu, 2, 2), dtype=np.int32)
        self.map_refi = np.full((self.h_scu, self.w_scu, 2), -1, dtype=np.int32)
        self.leaf_cus: list[tuple[int, int, int, int]] = []  # z-order (x,y,w,h)

        self.sh = sh
        self.qp_prev_eco = sh.qp
        self.dqp_is_coded = False
        qp_u = int(np.clip(sh.qp + sh.qp_u_offset, -6 * (self.sps.bit_depth_chroma_minus8), 57))
        qp_v = int(np.clip(sh.qp + sh.qp_v_offset, -6 * (self.sps.bit_depth_chroma_minus8), 57))
        iqt = self.sps.tool_iqt
        self.qp_u = chroma_qp_dynamic(qp_u, iqt) + 6 * self.sps.bit_depth_chroma_minus8
        self.qp_v = chroma_qp_dynamic(qp_v, iqt) + 6 * self.sps.bit_depth_chroma_minus8
        self.qp_y = sh.qp + 6 * self.sps.bit_depth_luma_minus8

        lg = self.log2_max_cuwh
        tiles = self._tile_grid()
        self.map_tidx = np.zeros((self.h_scu, self.w_scu), dtype=np.uint8)
        for tid, (tx, ty, tw, th) in enumerate(tiles):
            self.map_tidx[ty << (lg - 2):(ty + th) << (lg - 2),
                          tx << (lg - 2):(tx + tw) << (lg - 2)] = tid
        # per-tile substream starts from entry_point_offset_minus1
        starts = [br.byte_pos]
        for off_m1 in sh.entry_point_offsets:
            starts.append(starts[-1] + off_m1 + 1)
        for tid, (tx, ty, tw, th) in enumerate(tiles):
            if tid > 0:
                sbac = SbacDecoder(payload, starts[tid])
                if self.trace is not None and getattr(self, "trace_bins",
                                                      False):
                    sbac.trace_hook = self._tr
                ctx = SbacCtx(sh.slice_type, sh.qp, self.sps.tool_cm_init)
            # per-tile CABAC/dqp state; cross-tile neighbours are
            # unavailable (map_tidx gating in the reference,
            # xeve_util.c:736) — expressed here by a fresh coded map
            self.qp_prev_eco = sh.qp
            self.dqp_is_coded = False
            if len(tiles) > 1:
                self.map_cod = np.zeros((self.h_scu, self.w_scu), dtype=bool)
            for lcu_y in range(ty, ty + th):
                for lcu_x in range(tx, tx + tw):
                    self._decode_tree(sbac, ctx, lcu_x << lg, lcu_y << lg,
                                      self.max_cuwh, self.max_cuwh)
            tile_end = sbac.decode_bin_trm()
            assert tile_end == 1

        if sh.deblocking_filter_on:
            self._deblock()

        s = self.sps
        cw = ch = 0
        if s.picture_cropping_flag:
            cw = self.w - 2 * (s.picture_crop_left_offset + s.picture_crop_right_offset)
            ch = self.h - 2 * (s.picture_crop_top_offset + s.picture_crop_bottom_offset)
        out_y, out_u, out_v = self.rec_y, self.rec_u, self.rec_v
        if self.sps.tool_dra and self.pps.pic_dra_enabled_flag:
            # backward DRA on the OUTPUT picture only — the DPB stays in
            # the mapped domain (CFG_GET_RECON path, xevem.c:1036)
            from ..ops.dra_np import build_dra_maps, apply_dra
            if getattr(self, "_dra_maps", None) is None:
                self._dra_maps = build_dra_maps(
                    self.dra_aps[self.pps.pic_dra_aps_id], self.bd,
                    want_fwd=False)
            out_y, out_u, out_v = apply_dra(out_y, out_u, out_v,
                                            self._dra_maps, backward=True)
        self.frames.append(DecodedFrame(
            out_y.copy(), out_u.copy(), out_v.copy(),
            poc=self.poc, slice_type=sh.slice_type, qp=sh.qp,
            crop_w=cw, crop_h=ch))

        # DPB update (pic_marking + sliding window; xeve_picman.c:57-97).
        # Marking runs when a temporal-id-0 picture arrives: all higher-tid
        # refs are dropped, then the window is capped at 5 refs (coding
        # order).  self.dpb keeps coding order.
        if self.tid == 0:
            self.dpb = [p for p in self.dpb if p["tid"] == 0]
            while len([p for p in self.dpb if p.get("ref", True)]) >= 5:
                self.dpb.pop(0)
        pic = {
            "poc": self.poc,
            "tid": self.tid,
            "list0_poc": self.refp[0]["poc"] if self.refp else self.poc,
            "y_pad": mc_np.pad_picture(self.rec_y, self.pad_l),
            "u_pad": mc_np.pad_picture(self.rec_u, self.pad_l // 2),
            "v_pad": mc_np.pad_picture(self.rec_v, self.pad_l // 2),
            "map_mv": self.map_mv.copy(),
        }
        self.dpb.append(pic)

    def _tr(self, text: str):
        if self.trace is not None:
            self.trace.write(f"{self.trace_counter} \t{text}\n")
            self.trace_counter += 1

    def _tr_raw(self, text: str):
        if self.trace is not None:
            self.trace.write(text + "\n")

    def _tile_grid(self):
        """Uniform tile grid in CTU units: [(x_lcu, y_lcu, w_ctb, h_ctb)]
        raster order (xevem_set_tile_info, xevem_util.c:3460)."""
        p = self.pps
        if p.single_tile_in_pic_flag:
            return [(0, 0, self.w_lcu, self.h_lcu)]
        assert p.uniform_tile_spacing_flag, "explicit tile sizes TBD"
        cols = p.num_tile_columns_minus1 + 1
        rows = p.num_tile_rows_minus1 + 1
        col_w = [((i + 1) * self.w_lcu) // cols - (i * self.w_lcu) // cols
                 for i in range(cols)]
        row_h = [((j + 1) * self.h_lcu) // rows - (j * self.h_lcu) // rows
                 for j in range(rows)]
        tiles = []
        y = 0
        for j in range(rows):
            x = 0
            for i in range(cols):
                tiles.append((x, y, col_w[i], row_h[j]))
                x += col_w[i]
            y += row_h[j]
        return tiles

    # -- CTU tree -----------------------------------------------------------
# -- BTT/TT split tree (Main profile, sps_btt_flag) ---------------------

    # xevem_tbl_split_flag_ctx (xevem_tbl.c:43); NA/NB/NC sentinels keep
    # the reference values for unreachable shapes
    _SPLIT_FLAG_CTX = [
        [255, 4, 4, 14, 15, 15],
        [4, 4, 3, 3, 2, 2],
        [4, 3, 3, 2, 2, 1],
        [14, 3, 2, 2, 1, 1],
        [15, 2, 2, 1, 1, 0],
        [15, 2, 1, 1, 0, 0],
    ]

    def _allow_ratio(self, long_side, ratio):
        """ALLOW_SPLIT_RATIO (xevem_util.h:41): the ratio selects the
        aspect class (0 -> 1:1, 1 -> 1:2, 2 -> 1:4); larger disallowed."""
        if ratio > 2:
            return False
        mx, mn = self.split_check[("b11", "b12", "b14")[ratio]]
        return mn <= long_side <= mx

    def _allow_tri(self, long_side):
        mx, mn = self.split_check["tt"]
        return mn <= long_side <= mx

    def _check_split_main(self, lgw, lgh, boundary, boundary_r, x, y):
        """xeve_check_split_mode (xevem_util.c:42) with sps_btt_flag:
        returns allow[split_mode] over the SPLIT enum (no quad)."""
        allow = [False] * 6
        allow[0] = True                 # NO_SPLIT (implicit in the syntax)
        cu_max = 1 << (self.log2_max_cuwh - 1)
        from_boundary_b = (y >= self.h - self.h % cu_max) and \
            not (x >= self.w - self.w % cu_max)
        if lgw == lgh:
            allow[1] = self._allow_ratio(lgw, 1)            # BI_VER
            allow[2] = self._allow_ratio(lgw, 1)            # BI_HOR
            allow[3] = self._allow_tri(lgw) and self._allow_ratio(lgw, 2)
            allow[4] = self._allow_tri(lgh) and self._allow_ratio(lgh, 2)
        elif lgw > lgh:
            allow[2] = self._allow_ratio(lgw, lgw - lgh + 1)
            long_side = max(lgw - 1, lgh)
            ratio = abs((lgw - 1) - lgh)
            allow[1] = self._allow_ratio(long_side, ratio)
            if from_boundary_b and ratio in (3, 4):
                allow[1] = True
            allow[3] = self._allow_tri(lgw)
            allow[4] = False
        else:
            long_side = max(lgw, lgh - 1)
            ratio = abs(lgw - (lgh - 1))
            allow[2] = self._allow_ratio(long_side, ratio)
            allow[1] = self._allow_ratio(lgh, lgh - lgw + 1)
            allow[3] = False
            allow[4] = self._allow_tri(lgh)
        if boundary:
            allow[0] = allow[3] = allow[4] = False
            if boundary_r:
                allow[2] = not allow[1]
            else:
                if allow[2]:
                    allow[1] = False
                else:
                    allow[1] = True
        return allow

    def _split_flag_ctx(self, x, y, cuw, cuh):
        """btt_split_flag context from up/left/right neighbour leaf sizes
        (xevem_eco.c:780-816)."""
        if not self.sps.tool_cm_init:
            return 0
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        scuw = cuw >> MIN_CU_LOG2
        scup = (y_scu, x_scu)
        smaller = 0
        # up
        if y_scu > 0 and (self.map_tidx[y_scu, x_scu]
                          == self.map_tidx[y_scu - 1, x_scu]):
            if (1 << int(self.map_logw[y_scu - 1, x_scu])) < cuw:
                smaller += 1
        # left
        if x_scu > 0 and self.map_cod[y_scu, x_scu - 1] and \
                (self.map_tidx[y_scu, x_scu]
                 == self.map_tidx[y_scu, x_scu - 1]):
            if (1 << int(self.map_logh[y_scu, x_scu - 1])) < cuh:
                smaller += 1
        # right
        if x_scu + scuw < self.w_scu and \
                self.map_cod[y_scu, x_scu + scuw] and \
                (self.map_tidx[y_scu, x_scu]
                 == self.map_tidx[y_scu, x_scu + scuw]):
            if (1 << int(self.map_logh[y_scu, x_scu + scuw])) < cuh:
                smaller += 1
        lgw, lgh = cuw.bit_length() - 1, cuh.bit_length() - 1
        return min(smaller, 2) + 3 * self._SPLIT_FLAG_CTX[lgw - 2][lgh - 2]

    def _decode_split_mode(self, sbac, ctx, x0, y0, cuw, cuh):
        """Parse split_mode at an in-bounds node (xevem_eco_split_mode
        mirrored on the decode side)."""
        if cuw < 8 and cuh < 8:
            return 0
        lgw, lgh = cuw.bit_length() - 1, cuh.bit_length() - 1
        allow = self._check_split_main(lgw, lgh, 0, 0, x0, y0)
        if sum(allow[1:]) == 0:
            return 0
        cf = self._split_flag_ctx(x0, y0, cuw, cuh)
        if not sbac.decode_bin(ctx.btt_split_flag, cf):
            return 0
        HBT, VBT = allow[2], allow[1]
        HTT, VTT = allow[4], allow[3]
        total = HBT + VBT + HTT + VTT
        ctx_dir = (lgw - lgh + 2) if self.sps.tool_cm_init else 0
        if total == 4:
            split_dir = sbac.decode_bin(ctx.btt_split_dir, ctx_dir)
            split_typ = sbac.decode_bin(ctx.btt_split_type, 0)
        elif total == 3:
            split_dir = sbac.decode_bin(ctx.btt_split_dir, ctx_dir)
            if not HBT or not HTT:
                if split_dir:
                    split_typ = sbac.decode_bin(ctx.btt_split_type, 0)
                else:
                    split_typ = 0 if HBT else 1
            else:
                if not split_dir:
                    split_typ = sbac.decode_bin(ctx.btt_split_type, 0)
                else:
                    split_typ = 0 if VBT else 1
        elif total == 2:
            if (HBT and HTT) or (VBT and VTT):
                split_dir = 0 if HBT else 1
                split_typ = sbac.decode_bin(ctx.btt_split_type, 0)
            else:
                split_dir = sbac.decode_bin(ctx.btt_split_dir, ctx_dir)
                if not HTT and not VTT:
                    split_typ = 0
                elif HBT and VTT:
                    split_typ = split_dir
                else:   # VBT and HTT
                    split_typ = 1 - split_dir
        else:
            split_dir = 1 if (VBT or VTT) else 0
            split_typ = 1 if (HTT or VTT) else 0
        if split_typ:
            return 3 if split_dir else 4        # TRI_VER / TRI_HOR
        return 1 if split_dir else 2            # BI_VER / BI_HOR

    @staticmethod
    def _split_parts(split_mode, x0, y0, cuw, cuh):
        """Sub-part geometry (xeve_split_get_part_structure_main)."""
        if split_mode == 1:      # BI_VER
            half = cuw >> 1
            return [(x0, y0, half, cuh), (x0 + half, y0, half, cuh)]
        if split_mode == 2:      # BI_HOR
            half = cuh >> 1
            return [(x0, y0, cuw, half), (x0, y0 + half, cuw, half)]
        if split_mode == 3:      # TRI_VER: 1/4, 1/2, 1/4
            q = cuw >> 2
            return [(x0, y0, q, cuh), (x0 + q, y0, cuw >> 1, cuh),
                    (x0 + q + (cuw >> 1), y0, q, cuh)]
        if split_mode == 4:      # TRI_HOR
            q = cuh >> 2
            return [(x0, y0, cuw, q), (x0, y0 + q, cuw, cuh >> 1),
                    (x0, y0 + q + (cuh >> 1), cuw, q)]
        raise DecodeError(f"bad split mode {split_mode}")

    def _decode_suco_flag(self, sbac, ctx, cuw, cuh, split_mode, boundary):
        """xevem_eco_suco_flag: read the signalled suco flag (caller has
        established _suco_allowed)."""
        if self.sps.tool_cm_init:
            c = max(cuw, cuh).bit_length() - 1 - 2
            c = c * 2 if cuw == cuh else c * 2 + 1
        else:
            c = 0
        flag = sbac.decode_bin(ctx.suco_flag, c)
        self._tr(f"suco flag {flag} ")
        return flag

    def _suco_allowed(self, cuw, cuh, split_mode, boundary):
        """xeve_check_suco_cond: whether suco_flag is signalled here."""
        s = self.sps
        if not s.sps_suco_flag:
            return False
        suco_log2_max = min(self.log2_max_cuwh
                            - s.log2_diff_ctu_size_max_suco_cb_size, 6)
        suco_log2_min = max(suco_log2_max
                            - s.log2_diff_max_suco_min_suco_cb_size,
                            max(4, self.min_cuwh.bit_length() - 1))
        if min(cuw, cuh) < (1 << suco_log2_min) or \
                max(cuw, cuh) > (1 << suco_log2_max):
            return False
        if boundary or split_mode in (0, 2, 4):
            return False
        if split_mode != 5 and cuw <= cuh:
            return False
        return True

    def _decode_tree_main(self, sbac: SbacDecoder, ctx: SbacCtx, x0, y0,
                          cuw, cuh, cud=0, dqp_code=0, parent_suco=0):
        """Main-profile coding tree with BTT splits (xevem_eco_tree
        mirrored; SUCO reverses the traversal order of vertical parts;
        non-signalled nodes inherit the parent's suco flag,
        xevem_mode.c:1815)."""
        in_bounds = (x0 + cuw <= self.w) and (y0 + cuh <= self.h)
        if in_bounds:
            split = self._decode_split_mode(sbac, ctx, x0, y0, cuw, cuh)
        else:
            lgw, lgh = cuw.bit_length() - 1, cuh.bit_length() - 1
            boundary_r = (x0 + cuw > self.w) and not (y0 + cuh > self.h)
            allow = self._check_split_main(lgw, lgh, 1, boundary_r, x0, y0)
            split = 1 if allow[1] else 2
        self._tr(f"x pos {x0} y pos {y0} width {cuw} height {cuh} "
                 f"depth {cud} split mode {split} ")
        if self.pps.cu_qp_delta_enabled_flag and self.sps.dquant_flag:
            lw, lh = cuw.bit_length() - 1, cuh.bit_length() - 1
            area = self.pps.cu_qp_delta_area
            if split == 0 and lw + lh >= area and dqp_code != 2:
                dqp_code = 2 if (lw == 7 or lh == 7) else 1
                self.dqp_is_coded = False
            elif ((lw + lh == area + 1 and split in (3, 4))
                  or (lw + lh == area and dqp_code != 2)) and split != 0:
                dqp_code = 2
                self.dqp_is_coded = False
        if split:
            vertical = split in (1, 3)
            if self._suco_allowed(cuw, cuh, split, 0 if in_bounds else 1):
                suco = self._decode_suco_flag(sbac, ctx, cuw, cuh, split,
                                              0 if in_bounds else 1)
            else:
                # unsignalled VERTICAL splits inherit the parent's suco
                # order (the encoder evaluates only suco == parent_suco,
                # xevem_mode.c:1740,1815); HOR splits always use direct
                # order (num_suco == 1) but still pass parent_suco on to
                # their children (xevem_mode.c:1964)
                suco = parent_suco if vertical else 0
            child_suco = suco if vertical else parent_suco
            parts = self._split_parts(split, x0, y0, cuw, cuh)
            if suco:
                parts = parts[::-1]
            for (xp, yp, wp, hp) in parts:
                if xp < self.w and yp < self.h:
                    self._decode_tree_main(sbac, ctx, xp, yp, wp, hp,
                                           cud + (2 if split in (3, 4)
                                                  else 1), dqp_code,
                                           child_suco)
        else:
            if not in_bounds:
                raise DecodeError("leaf CU crossing the picture boundary")
            self._decode_cu(sbac, ctx, x0, y0, cuw, cuh, dqp_code)

    def _decode_tree(self, sbac: SbacDecoder, ctx: SbacCtx, x0, y0, cuw, cuh,
                     cud=0, dqp_code=0):
        if self.sps.sps_btt_flag:
            self._decode_tree_main(sbac, ctx, x0, y0, cuw, cuh, cud,
                                   dqp_code)
            return
        in_bounds = (x0 + cuw <= self.w) and (y0 + cuh <= self.h)
        if cuw < 8 and cuh < 8:
            split = 0
        else:
            # Baseline (no BTT): split flag coded at every node >= 8,
            # including boundary nodes (xeve_enc.c:56-58, xeve_eco.c:1377)
            split = sbac.decode_bin(ctx.split_cu_flag, 0)
            self._tr(f"x pos {x0} y pos {y0} width {cuw} height {cuh} "
                     f"depth {cud} split mode {5 if split else 0} ")
        # quantization-group state machine (xevem.c:73-90): a CU whose
        # area reaches cu_qp_delta_area starts its own group (code 1);
        # a split node exactly at the area starts a shared group (code 2)
        # whose first coefficient-bearing CU codes the single dqp
        if (self.pps.cu_qp_delta_enabled_flag and self.sps.dquant_flag):
            lw, lh = cuw.bit_length() - 1, cuh.bit_length() - 1
            area = self.pps.cu_qp_delta_area
            if split == 0 and lw + lh >= area and dqp_code != 2:
                dqp_code = 2 if (lw == 7 or lh == 7) else 1
                self.dqp_is_coded = False
            elif split != 0 and lw + lh == area and dqp_code != 2:
                dqp_code = 2
                self.dqp_is_coded = False
        if split:
            half = cuw >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                xp, yp = x0 + dx, y0 + dy
                if xp < self.w and yp < self.h:
                    self._decode_tree(sbac, ctx, xp, yp, half, half, cud + 2,
                                      dqp_code)
        else:
            assert in_bounds, "leaf CU crossing the picture boundary"
            self._decode_cu(sbac, ctx, x0, y0, cuw, cuh, dqp_code)

    # -- CU decode ----------------------------------------------------------
    def _get_mpm_inv(self, x_scu, y_scu):
        ipm_l = 0
        ipm_u = 0
        if x_scu > 0 and self.map_if[y_scu, x_scu - 1] and self.map_cod[y_scu, x_scu - 1]:
            ipm_l = int(self.map_ipm[y_scu, x_scu - 1]) + 1
        if y_scu > 0 and self.map_if[y_scu - 1, x_scu] and self.map_cod[y_scu - 1, x_scu]:
            ipm_u = int(self.map_ipm[y_scu - 1, x_scu]) + 1
        return MPM_INV[ipm_l, ipm_u]

    def _decode_subtb_coefs(self, sbac, ctx, cuw, cuh, mode_intra, dqp_code):
        """Interleaved per-sub-TB parse for CUs above the 64 max transform
        size (xevem_eco.c:1355-1470): cbf triple -> dqp -> coefficients for
        each of the loop_w x loop_h 64-max subs in raster order.  Returns
        (cbf_y, cbf_u, cbf_v, qp, coef_y, coef_u, coef_v) with full-CU
        coefficient arrays (zero-filled where a sub has no cbf)."""
        sub_w, sub_h = min(cuw, 64), min(cuh, 64)
        loop_w, loop_h = cuw // sub_w, cuh // sub_h
        coef_y = np.zeros((cuh, cuw), dtype=np.int32)
        coef_u = np.zeros((cuh >> 1, cuw >> 1), dtype=np.int32)
        coef_v = np.zeros((cuh >> 1, cuw >> 1), dtype=np.int32)
        any_y = any_u = any_v = 0
        cbf_all = 1
        qp = self.qp_prev_eco
        for sj in range(loop_h):
            for si in range(loop_w):
                if mode_intra:
                    cbf_u = sbac.decode_bin(ctx.cbf_cb, 0)
                    self._tr(f"cbf U {cbf_u} ")
                    cbf_v = sbac.decode_bin(ctx.cbf_cr, 0)
                    self._tr(f"cbf V {cbf_v} ")
                    cbf_y = sbac.decode_bin(ctx.cbf_luma, 0)
                    self._tr(f"cbf Y {cbf_y} ")
                else:
                    if sj == 0 and si == 0:
                        cbf_all = sbac.decode_bin(ctx.cbf_all, 0)
                        self._tr(f"all_cbf {cbf_all} ")
                        if cbf_all == 0:
                            return 0, 0, 0, qp, coef_y, coef_u, coef_v
                    cbf_u = sbac.decode_bin(ctx.cbf_cb, 0)
                    self._tr(f"cbf U {cbf_u} ")
                    cbf_v = sbac.decode_bin(ctx.cbf_cr, 0)
                    self._tr(f"cbf V {cbf_v} ")
                    cbf_y = sbac.decode_bin(ctx.cbf_luma, 0)
                    self._tr(f"cbf Y {cbf_y} ")
                # dqp (per sub, xevem_eco.c:1386-1395)
                if self.pps.cu_qp_delta_enabled_flag:
                    cbf_for_dqp = bool(cbf_y or cbf_u or cbf_v)
                    if ((((not self.sps.dquant_flag) or
                          (dqp_code == 1 and not self.dqp_is_coded))
                         and cbf_for_dqp)
                            or (dqp_code == 2 and not self.dqp_is_coded)):
                        abs_dqp = sbac.read_unary_sym(ctx.delta_qp, 0, 1)
                        dqp = 0
                        if abs_dqp > 0:
                            dqp = -abs_dqp if sbac.decode_bin_ep() else abs_dqp
                        self._tr(f"dqp {dqp} ")
                        qp = self.qp_prev_eco + dqp
                        self.qp_prev_eco = qp
                        self.dqp_is_coded = True
                yo, xo = sj * sub_h, si * sub_w
                if cbf_y:
                    coef_y[yo:yo + sub_h, xo:xo + sub_w] = \
                        self._decode_coef_block(sbac, ctx, sub_w, sub_h, 0)
                    any_y = 1
                if cbf_u:
                    coef_u[yo >> 1:(yo + sub_h) >> 1,
                           xo >> 1:(xo + sub_w) >> 1] = \
                        self._decode_coef_block(sbac, ctx, sub_w >> 1,
                                                sub_h >> 1, 1)
                    any_u = 1
                if cbf_v:
                    coef_v[yo >> 1:(yo + sub_h) >> 1,
                           xo >> 1:(xo + sub_w) >> 1] = \
                        self._decode_coef_block(sbac, ctx, sub_w >> 1,
                                                sub_h >> 1, 1)
                    any_v = 1
        return any_y, any_u, any_v, qp, coef_y, coef_u, coef_v

    def _decode_coef_block(self, sbac: SbacDecoder, ctx: SbacCtx, w, h, ch_type):
        """Coefficient decode: ADCC (Main) or run-length (Baseline)."""
        if self.sps.tool_adcc:
            from ..entropy import adcc
            return adcc.decode_block(sbac, ctx, w, h, ch_type)
        return self._decode_coef_block_rl(sbac, ctx, w, h, ch_type)

    def _decode_coef_block_rl(self, sbac: SbacDecoder, ctx: SbacCtx, w, h,
                              ch_type):
        """xeve_eco_run_length_cc inverse."""
        coef = np.zeros(w * h, dtype=np.int32)
        scan = SCAN[(w, h)]
        num_coeff = w * h
        scan_pos = 0
        cm = ctx.cm_init
        prev_level = 6
        ctx_last = 0 if ch_type == 0 else 1
        while scan_pos < num_coeff:
            if cm:   # level-adaptive ctx group (xeve_eco.c:730)
                t0 = (min(prev_level - 1, 5) << 1) + (0 if ch_type == 0 else 12)
            else:
                t0 = 0 if ch_type == 0 else 2
            run = sbac.read_unary_sym(ctx.run, t0, 2)
            scan_pos += run
            level = sbac.read_unary_sym(ctx.level, t0, 2) + 1
            prev_level = level
            sign = sbac.decode_bin_ep()
            coef[scan[scan_pos]] = -level if sign else level
            if scan_pos == num_coeff - 1:
                break
            scan_pos += 1
            last = sbac.decode_bin(ctx.last, ctx_last)
            if last:
                break
        if self.trace is not None:
            self._tr_raw("coef luma " + "".join(f"{v} " for v in coef))
        return coef.reshape(h, w)

    def _mvp_list(self, x_scu, y_scu, scuw, scuh, lidx):
        avail = motion_np.get_avail_inter(x_scu, y_scu, self.w_scu, self.h_scu,
                                          scuw, scuh, self.map_cod, self.map_if)
        refs = self.refp if lidx == 0 else self.refp1
        ref0_map = refs[0]["map_mv"] if refs else None
        return motion_np.get_motion(x_scu, y_scu, scuw, lidx, avail,
                                    self.map_mv, ref0_map, self.w_scu)

    def _mv_dir(self, x_scu, y_scu):
        """Temporal direct MVs (xeve_get_mv_dir, xeve_util.c:620-650):
        scale the co-located L0 MV of the first L1 reference; the colocated
        SCU is the CU's bottom-right SCU (xeve_pinter.c:1545)."""
        ref1 = self.refp1[0]
        mvc = ref1["map_mv"][y_scu, x_scu, 0]
        dpoc_co = ref1["poc"] - ref1["list0_poc"]
        dpoc_l0 = self.poc - self.refp[0]["poc"]
        dpoc_l1 = ref1["poc"] - self.poc
        if dpoc_co == 0:
            return (0, 0), (0, 0)

        def sdiv(a, b):   # C truncation toward zero
            q = abs(a) // abs(b)
            return -q if (a < 0) != (b < 0) else q
        mv0 = (sdiv(dpoc_l0 * int(mvc[0]), dpoc_co),
               sdiv(dpoc_l0 * int(mvc[1]), dpoc_co))
        mv1 = (sdiv(-dpoc_l1 * int(mvc[0]), dpoc_co),
               sdiv(-dpoc_l1 * int(mvc[1]), dpoc_co))
        return mv0, mv1

    def _ctx_flags(self, x_scu, y_scu, scuw, scuh):
        """Neighbour-derived context indices for skip_flag / pred_mode
        (xeve_get_ctx_some_flags, xeve_util.c:1181).  Zero unless
        sps_cm_init_flag."""
        if not self.sps.tool_cm_init:
            return 0, 0
        pos = []
        if y_scu > 0:
            pos.append((y_scu - 1, x_scu))
        if x_scu > 0:
            pos.append((y_scu + scuh - 1, x_scu - 1))
        if x_scu + scuw < self.w_scu:
            pos.append((y_scu + scuh - 1, x_scu + scuw))
        sf = ifl = avail = 0
        for (yy, xx) in pos:
            if self.map_cod[yy, xx]:
                avail += 1
                sf += int(self.map_skip[yy, xx])
                ifl += int(self.map_if[yy, xx])
        if avail == 0:
            return 0, 0
        return min(sf, 1), min(ifl, 2)   # NUM_CTX_SKIP_FLAG-1, PRED_MODE-1

    def _decode_cu(self, sbac: SbacDecoder, ctx: SbacCtx, x, y, cuw, cuh,
                   dqp_code=0):
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        scuw, scuh = cuw >> MIN_CU_LOG2, cuh >> MIN_CU_LOG2
        slice_type = self.sh.slice_type
        self._tr(f"poc: {self.poc} x pos {x} y pos {y} "
                 f"width {cuw} height {cuh} ")

        skip = 0
        mode_intra = True
        refi = [-1, -1]
        mv = [(0, 0), (0, 0)]
        is_b = slice_type == 0  # SLICE_B
        ctx_skip, ctx_pred = self._ctx_flags(x_scu, y_scu, scuw, scuh)
        if slice_type != SLICE_I:
            skip = sbac.decode_bin(ctx.skip_flag, ctx_skip)
            self._tr(f"skip flag {skip} ctx {ctx_skip} ")
            if skip:
                mode_intra = False
                if self.sps.tool_mmvd:
                    if sbac.decode_bin(ctx.mmvd_flag, 0):
                        raise DecodeError("MMVD-coded CU (mmvd_flag=1): "
                                          "reconstruction not implemented")
                idx0 = sbac.read_truncate_unary_sym(ctx.mvp_idx, 0, 3, 4)
                self._tr(f"mvp idx {idx0} ")
                mvp0 = self._mvp_list(x_scu, y_scu, scuw, scuh, 0)
                refi[0] = 0
                mv[0] = (int(mvp0[idx0][0]), int(mvp0[idx0][1]))
                if is_b:
                    idx1 = sbac.read_truncate_unary_sym(ctx.mvp_idx, 0, 3, 4)
                    self._tr(f"mvp idx {idx1} ")
                    mvp1 = self._mvp_list(x_scu, y_scu, scuw, scuh, 1)
                    refi[1] = 0
                    mv[1] = (int(mvp1[idx1][0]), int(mvp1[idx1][1]))
            else:
                pred_intra = sbac.decode_bin(ctx.pred_mode, ctx_pred)
                self._tr(f"pred mode {0 if pred_intra else 1} ")
                mode_intra = bool(pred_intra)
                if not mode_intra:
                    mvr_idx = 0
                    if self.sps.tool_amvr:
                        # xevem_eco_mvr_idx: truncated unary, 4 models
                        # (always 0 in admvp=0 streams — the baseline
                        # analyzer searches quarter-pel only)
                        mvr_idx = sbac.read_truncate_unary_sym(
                            ctx.mvr_idx, 0, 5, 5)
                    direct = 0
                    if is_b:
                        direct = sbac.decode_bin(ctx.direct_mode_flag, 0)
                        self._tr(f"direct_mode_flag {direct} ")
                    if direct and self.sps.tool_mmvd:
                        if sbac.decode_bin(ctx.mmvd_flag, 0):
                            raise DecodeError("MMVD-coded CU: "
                                              "reconstruction not "
                                              "implemented")
                    if direct:
                        mv0d, mv1d = self._mv_dir(x_scu + scuw - 1,
                                                  y_scu + scuh - 1)
                        refi = [0, 0]
                        mv = [mv0d, mv1d]
                    else:
                        pred_dir = 0  # 0=L0, 1=L1, 2=BI
                        if is_b:
                            # xeve_eco_inter_pred_idc (bi applicable, admvp=0)
                            if sbac.decode_bin(ctx.inter_dir, 0) == 0:
                                pred_dir = 2
                            else:
                                pred_dir = 1 if sbac.decode_bin(ctx.inter_dir, 1) else 0
                            self._tr(f"inter dir {pred_dir} ")
                        for lidx in (0, 1):
                            use = (lidx == 0 and pred_dir in (0, 2)) or \
                                  (lidx == 1 and pred_dir in (1, 2))
                            if not use:
                                continue
                            refs = self.refp if lidx == 0 else self.refp1
                            r = 0
                            if len(refs) > 1:
                                r = self._decode_refi(sbac, ctx, len(refs))
                            idx = sbac.read_truncate_unary_sym(ctx.mvp_idx, 0, 3, 4)
                            self._tr(f"mvp idx {idx} ")
                            mvd = self._decode_mvd(sbac, ctx)
                            self._tr(f"mvd x {mvd[0]} mvd y {mvd[1]} ")
                            mvp = self._mvp_list(x_scu, y_scu, scuw, scuh, lidx)
                            refi[lidx] = r
                            mv[lidx] = (
                                int(mvp[idx][0] + (mvd[0] << mvr_idx)),
                                int(mvp[idx][1] + (mvd[1] << mvr_idx)))

        ipm = 0
        ipm_c = 0
        if mode_intra and self.sps.tool_eipd:
            # EIPD luma direction (xevem_eco_intra_dir, xevem_eco.c:1541)
            mpm, ext, pims = im.get_mpm_main(
                x_scu, y_scu, scuw, self.map_cod, self.map_if,
                self.map_ipm, self.w_scu)
            if sbac.decode_bin(ctx.intra_luma_pred_mpm_flag, 0):
                ipm = mpm[sbac.decode_bin(ctx.intra_luma_pred_mpm_idx, 0)]
            elif sbac.decode_bin_ep():
                fl = sbac.decode_bins_ep(3)
                ipm = ext[fl]
            else:
                # truncated binary over the 23 remaining ranks
                val, b = 16, (im.IPD_CNT - 10) - 16
                t = sbac.decode_bins_ep(4)
                if t < val - b:
                    rank = t
                else:
                    rank = ((t << 1) | sbac.decode_bin_ep()) - (val - b)
                ipm = pims[rank + 10]
            self._tr(f"ipm Y {ipm} ")
            # chroma direction (xevem_eco_intra_dir_c, xevem_eco.c:1598)
            if sbac.decode_bin(ctx.intra_chroma_pred_mode, 0):
                ipm_c = im.IPD_DM_C
            else:
                # unary EP capped at IPD_CHROMA_CNT-1 bins (xevem_eco.c:45)
                remain = 0
                while (remain < im.IPD_CHROMA_CNT - 1 and
                       sbac.decode_bin_ep()):
                    remain += 1
                ipm_l_conv, chk = im.conv_luma_to_chroma(ipm)
                ipm_c = remain + 1
                if chk and ipm_c >= ipm_l_conv:
                    ipm_c += 1
            self._tr(f"ipm UV {ipm_c} ")
        elif mode_intra:
            rank = sbac.read_unary_sym(ctx.intra_dir, 0, 2)
            ipm = int(self._get_mpm_inv(x_scu, y_scu)[rank])
            self._tr(f"ipm Y {ipm} ")

        # CUs above the max transform size 64 code loop_w x loop_h sub-TBs,
        # each with its own cbf triple + dqp + coefficients interleaved
        # (xevem_eco.c:1327-1366); handled by a dedicated parse
        big_tb = cuw > 64 or cuh > 64
        if big_tb and not skip:
            (cbf_y, cbf_u, cbf_v, qp, coef_y_big, coef_u_big,
             coef_v_big) = self._decode_subtb_coefs(sbac, ctx, cuw, cuh,
                                                    mode_intra, dqp_code)
            cbf_all = 1 if (cbf_y or cbf_u or cbf_v) else 0
        elif big_tb:
            cbf_all = 0
            cbf_y = cbf_u = cbf_v = 0
            qp = self.qp_prev_eco
        if not big_tb:
            cbf_all = 1
        if big_tb:
            pass
        elif skip:
            cbf_y = cbf_u = cbf_v = 0
        elif mode_intra:
            # cbf (intra branch of xeve_eco_cbf, xeve_eco.c:866-891)
            cbf_u = sbac.decode_bin(ctx.cbf_cb, 0)
            self._tr(f"cbf U {cbf_u} ")
            cbf_v = sbac.decode_bin(ctx.cbf_cr, 0)
            self._tr(f"cbf V {cbf_v} ")
            cbf_y = sbac.decode_bin(ctx.cbf_luma, 0)
            self._tr(f"cbf Y {cbf_y} ")
        else:
            # inter branch: cbf_all then per-component (xeve_eco.c:813-864)
            cbf_all = sbac.decode_bin(ctx.cbf_all, 0)
            self._tr(f"all_cbf {cbf_all} ")
            if cbf_all == 0:
                cbf_y = cbf_u = cbf_v = 0
            else:
                cbf_u = sbac.decode_bin(ctx.cbf_cb, 0)
                self._tr(f"cbf U {cbf_u} ")
                cbf_v = sbac.decode_bin(ctx.cbf_cr, 0)
                self._tr(f"cbf V {cbf_v} ")
                if cbf_u + cbf_v != 0:
                    cbf_y = sbac.decode_bin(ctx.cbf_luma, 0)
                    self._tr(f"cbf Y {cbf_y} ")
                else:
                    cbf_y = 1   # inferred

        # dqp coding condition (xevem_eco.c:1386-1395; baseline xeve_eco.c:995)
        read_dqp = False
        if (not big_tb) and (not skip) and self.pps.cu_qp_delta_enabled_flag:
            inter_all_zero = (not mode_intra) and cbf_all == 0
            if not inter_all_zero:
                cbf_for_dqp = bool(cbf_y or cbf_u or cbf_v)
                if ((((not self.sps.dquant_flag) or
                      (dqp_code == 1 and not self.dqp_is_coded)) and cbf_for_dqp)
                        or (dqp_code == 2 and not self.dqp_is_coded)):
                    read_dqp = True
        if read_dqp:
            abs_dqp = sbac.read_unary_sym(ctx.delta_qp, 0, 1)
            if abs_dqp > 0:
                sign = sbac.decode_bin_ep()
                dqp = -abs_dqp if sign else abs_dqp
            else:
                dqp = 0
            self._tr(f"dqp {dqp} ")
            qp = self.qp_prev_eco + dqp
            self.qp_prev_eco = qp
            self.dqp_is_coded = True
        elif not big_tb:
            qp = self.qp_prev_eco
        qp_y = qp + 6 * self.sps.bit_depth_luma_minus8
        # NOTE: chroma qp follows the slice-level mapping of the luma qp
        qp_u_i = int(np.clip(qp + self.sh.qp_u_offset, -12, 57))
        qp_v_i = int(np.clip(qp + self.sh.qp_v_offset, -12, 57))
        qp_u = (chroma_qp_dynamic(qp_u_i, self.sps.tool_iqt)
                + 6 * self.sps.bit_depth_chroma_minus8)
        qp_v = (chroma_qp_dynamic(qp_v_i, self.sps.tool_iqt)
                + 6 * self.sps.bit_depth_chroma_minus8)

        # ATS signalling (xeve_eco_coefficient, xevem_eco.c:1396-1412)
        ats_intra_cu = ats_mode = ats_inter_info = 0
        lw, lh = cuw.bit_length() - 1, cuh.bit_length() - 1
        if self.sps.tool_ats and not skip:
            if mode_intra and cbf_y and lw <= 5 and lh <= 5:
                ats_intra_cu = sbac.decode_bin_ep()
                self._tr(f"ats intra CU {ats_intra_cu} ")
                if ats_intra_cu:
                    hbit = sbac.decode_bin(ctx.ats_mode, 0)
                    self._tr(f"ats intra tuH {hbit} ")
                    vbit = sbac.decode_bin(ctx.ats_mode, 0)
                    self._tr(f"ats intra tuV {vbit} ")
                    ats_mode = (hbit << 1) | vbit
            elif not mode_intra and cbf_all and cuw <= 64 and cuh <= 64:
                m_v, m_h = cuw >= 8, cuh >= 8
                m_vq, m_hq = cuw >= 16, cuh >= 16
                if m_v or m_h:
                    cm = ctx.cm_init
                    cf = (0 if lw + lh >= 8 else 1) if cm else 0
                    flag = sbac.decode_bin(ctx.ats_cu_inter_flag, cf)
                    self._tr_raw(f"ats_inter_flag {flag} ")
                    if flag:
                        quad = 0
                        if (m_vq or m_hq) and (m_v or m_h):
                            quad = sbac.decode_bin(ctx.ats_cu_inter_quad_flag, 0)
                            self._tr_raw(f"ats_inter_quad {quad} ")
                        if ((quad and m_vq and m_hq) or
                                (not quad and m_v and m_h)):
                            ch = ((0 if lw == lh else (1 if lw < lh else 2))
                                  if cm else 0)
                            hor = sbac.decode_bin(ctx.ats_cu_inter_hor_flag, ch)
                            self._tr_raw(f"ats_inter_hor {hor} ")
                        else:
                            hor = 1 if ((quad and m_hq) or
                                        (not quad and m_h)) else 0
                        pos = sbac.decode_bin(ctx.ats_cu_inter_pos_flag, 0)
                        self._tr_raw(f"ats_inter_pos {pos} ")
                        idx = (4 if hor else 3) if quad else (2 if hor else 1)
                        ats_inter_info = idx | (pos << 4)
        self._cur_ats = (ats_intra_cu, ats_mode, ats_inter_info)

        tu_lw, tu_lh = lw, lh
        if ats_inter_info:
            tu_lw, tu_lh = rk.ats_inter_tu_size(ats_inter_info, lw, lh)
        if big_tb:
            coef_y = coef_y_big if (not skip) and cbf_y else None
            coef_u = coef_u_big if (not skip) and cbf_u else None
            coef_v = coef_v_big if (not skip) and cbf_v else None
        else:
            coef_y = coef_u = coef_v = None
            if cbf_y:
                coef_y = self._decode_coef_block(sbac, ctx, 1 << tu_lw,
                                                 1 << tu_lh, 0)
            if cbf_u:
                coef_u = self._decode_coef_block(sbac, ctx, 1 << (tu_lw - 1),
                                                 1 << (tu_lh - 1), 1)
            if cbf_v:
                coef_v = self._decode_coef_block(sbac, ctx, 1 << (tu_lw - 1),
                                                 1 << (tu_lh - 1), 1)

        # reconstruct
        if mode_intra:
            self._recon_intra_cu(x, y, cuw, cuh, ipm, qp_y, qp_u, qp_v,
                                 coef_y, coef_u, coef_v, ipm_c)
        else:
            self._recon_inter_cu(x, y, cuw, cuh, refi, mv, qp_y, qp_u, qp_v,
                                 coef_y, coef_u, coef_v)

        # HTDF in-loop filter on the luma recon: INTRA CUs only.  The
        # reference also runs xeve_htdf inside the inter RDO
        # (xevem_pinter.c:6090) but that filtering is cost-evaluation
        # local — the final reconstruction keeps inter CUs unfiltered
        # (established against the s96_htdf_{ai,zl,ra} golden recon
        # dumps, 28 frames bit-exact incl. signature SEIs).
        if self.sps.tool_htdf and mode_intra:
            from ..ops import htdf_np
            htdf_np.htdf_cu(self.rec_y, x, y, cuw, cuh, self.sh.qp,
                            mode_intra,
                            self._avail_intra_flags(x_scu, y_scu, scuw, scuh),
                            self.bd)

        # update maps
        ys, xs = y_scu, x_scu
        hs, ws = cuh >> MIN_CU_LOG2, cuw >> MIN_CU_LOG2
        self.map_cod[ys:ys + hs, xs:xs + ws] = True
        self.map_logw[ys:ys + hs, xs:xs + ws] = cuw.bit_length() - 1
        self.map_logh[ys:ys + hs, xs:xs + ws] = cuh.bit_length() - 1
        self.map_if[ys:ys + hs, xs:xs + ws] = mode_intra
        self.map_skip[ys:ys + hs, xs:xs + ws] = bool(skip)
        self.map_ipm[ys:ys + hs, xs:xs + ws] = ipm if mode_intra else 0
        self.map_qp[ys:ys + hs, xs:xs + ws] = qp
        self.map_cbf_l[ys:ys + hs, xs:xs + ws] = bool(cbf_y)
        if not mode_intra:
            for lidx in (0, 1):
                self.map_refi[ys:ys + hs, xs:xs + ws, lidx] = refi[lidx]
                self.map_mv[ys:ys + hs, xs:xs + ws, lidx, 0] = mv[lidx][0]
                self.map_mv[ys:ys + hs, xs:xs + ws, lidx, 1] = mv[lidx][1]
        self.leaf_cus.append((x, y, cuw, cuh))

    def _decode_refi(self, sbac, ctx, num_refp):
        """xeve_eco_refi inverse."""
        if sbac.decode_bin(ctx.refi, 0) == 0:
            return 0
        self.saw_refi1 = True
        if num_refp == 2:
            return 1
        for i in range(2, num_refp):
            b = sbac.decode_bin(ctx.refi, 1) if i == 2 else sbac.decode_bin_ep()
            if b == 0:
                return i - 1
        return num_refp - 1

    def _decode_mvd(self, sbac, ctx):
        """xeve_eco_mvd inverse (xeve_eco.c:1205-1279)."""
        out = []
        for _ in range(2):
            # exp-golomb-ish: first two bins context coded, rest EP
            bins = []
            # read code of form: len_i zeros? encoder writes code MSB->LSB of
            # (1<<len_i)|info with length 2*len_i+1, first 2 bins ctx coded
            # decode: count leading zeros until a 1
            n_lead = 0
            while True:
                b = sbac.decode_bin(ctx.mvd, 0) if n_lead < 2 else sbac.decode_bin_ep()
                if b == 1:
                    break
                n_lead += 1
            info = 0
            for k in range(n_lead):
                pos = n_lead + 1 + k
                b = sbac.decode_bin(ctx.mvd, 0) if pos < 2 else sbac.decode_bin_ep()
                info = (info << 1) | b
            val = (1 << n_lead) + info - 1
            if val:
                sign = sbac.decode_bin_ep()
                val = -val if sign else val
            out.append(val)
        return out

    def _avail_intra_flags(self, x_scu, y_scu, scuw, scuh) -> dict:
        """xeve_get_avail_intra (xeve_util.c:719) as a flag dict.  The
        coded-map gating confines le/ri/diagonals to the current tile (the
        map is reset per tile); `up` crosses CTU rows unconditionally in a
        single tile but must stop at a tile boundary (map_tidx gate,
        xeve_util.c:736)."""
        cod = self.map_cod
        w_scu, h_scu = self.w_scu, self.h_scu
        up = y_scu > 0
        if up and getattr(self, "map_tidx", None) is not None and \
                not self.pps.single_tile_in_pic_flag:
            up = (self.map_tidx[y_scu, x_scu] ==
                  self.map_tidx[y_scu - 1, x_scu])
        le = x_scu > 0 and cod[y_scu, x_scu - 1]
        ri = x_scu + scuw < w_scu and cod[y_scu, x_scu + scuw]
        diag = y_scu + scuh + scuw - 1 < h_scu
        return {
            "le": le,
            "ri": ri,
            "up": bool(up),
            "up_le": x_scu > 0 and y_scu > 0 and cod[y_scu - 1, x_scu - 1],
            "up_ri": (y_scu > 0 and x_scu + scuw < w_scu and
                      cod[y_scu - 1, x_scu + scuw]),
            "lo_le": bool(le and diag and
                          cod[y_scu + scuw + scuh - 1, x_scu - 1]),
            "lo_ri": bool(ri and diag and
                          cod[y_scu + scuw + scuh - 1, x_scu + scuw]),
        }

    def _itdq(self, coef, qp):
        """Dequant + inverse transform, IQT-aware (xevem_itdq.c:551,694)."""
        bd = self.bd
        if self.sps.tool_iqt:
            return rk.inverse_dct2_iqt(rk.dequant(coef, qp, bd, iqt=1), bd)
        return rk.inverse_dct2(rk.dequant(coef, qp, bd), bd)

    @staticmethod
    def _place_sub_tb(sub, w, h, info):
        """Zero-extend an ATS-inter sub-TB residual to CU size at the
        signalled position (xeve_recon_w_ats, xevem_recon.c:41)."""
        idx = info & 0xF
        pos = (info >> 4) & 0xF
        out = np.zeros((h, w), dtype=np.int32)
        sh, sw = sub.shape
        if idx in (2, 4):   # horizontal split: sub occupies top or bottom
            y0 = 0 if pos == 0 else h - sh
            out[y0:y0 + sh, :] = sub
        else:
            x0 = 0 if pos == 0 else w - sw
            out[:, x0:x0 + sw] = sub
        return out

    def _resi_big(self, coef, qp, chroma):
        """Per-sub-TB inverse transform for CUs above the 64 max transform
        size (each 64-max sub transforms independently)."""
        h, w = coef.shape
        sub = 32 if chroma else 64
        sub_w, sub_h = min(w, sub), min(h, sub)
        out = np.empty((h, w), dtype=np.int32)
        for yo in range(0, h, sub_h):
            for xo in range(0, w, sub_w):
                out[yo:yo + sub_h, xo:xo + sub_w] = self._itdq(
                    coef[yo:yo + sub_h, xo:xo + sub_w], qp)
        return out

    def _resi_luma(self, coef, qp, cuw, cuh):
        ats_intra_cu, ats_mode, inter_info = self._cur_ats
        bd = self.bd
        if cuw > 64 or cuh > 64:
            return self._resi_big(coef, qp, chroma=False)
        if ats_intra_cu:
            return rk.inverse_ats(
                rk.dequant(coef, qp, bd, iqt=self.sps.tool_iqt), ats_mode, bd)
        if inter_info:
            lw, lh = cuw.bit_length() - 1, cuh.bit_length() - 1
            use, m = rk.ats_inter_trs(inter_info, lw, lh)
            d = rk.dequant(coef, qp, bd, iqt=self.sps.tool_iqt)
            if use:
                sub = rk.inverse_ats(d, m, bd)
            elif self.sps.tool_iqt:
                sub = rk.inverse_dct2_iqt(d, bd)
            else:
                sub = rk.inverse_dct2(d, bd)
            return self._place_sub_tb(sub, cuw, cuh, inter_info)
        return self._itdq(coef, qp)

    def _resi_chroma(self, coef, qp, wc, hc):
        inter_info = self._cur_ats[2]
        if wc > 32 or hc > 32:
            return self._resi_big(coef, qp, chroma=True)
        if inter_info:
            return self._place_sub_tb(self._itdq(coef, qp), wc, hc,
                                      inter_info)
        return self._itdq(coef, qp)

    def _recon_inter_cu(self, x, y, cuw, cuh, refi, mv, qp_y, qp_u, qp_v,
                        coef_y, coef_u, coef_v):
        bd = self.bd
        preds = []
        clipped = []
        for lidx in (0, 1):
            if refi[lidx] < 0:
                continue
            refs = self.refp if lidx == 0 else self.refp1
            ref = refs[refi[lidx]]
            clipped.append((ref["poc"],
                            mc_np.mv_clip(x, y, self.w, self.h, cuw, cuh, mv[lidx])))
            preds.append(mc_np.mc_cu(
                x, y, cuw, cuh, mv[lidx], ref["y_pad"], ref["u_pad"],
                ref["v_pad"], self.pad_l, self.pad_l // 2, self.w, self.h, bd))
        if len(preds) == 2 and clipped[0] == clipped[1]:
            preds.pop()   # identical motion check (xeve_mc.c:546-551)
        if len(preds) == 2:
            pred_y = (preds[0][0] + preds[1][0] + 1) >> 1
            pred_u = (preds[0][1] + preds[1][1] + 1) >> 1
            pred_v = (preds[0][2] + preds[1][2] + 1) >> 1
        else:
            pred_y, pred_u, pred_v = preds[0]
        resi = None
        if coef_y is not None:
            resi = self._resi_luma(coef_y, qp_y, cuw, cuh)
        self.rec_y[y:y + cuh, x:x + cuw] = rk.recon_block(pred_y, resi, bd)
        xc, yc, wc, hc = x >> 1, y >> 1, cuw >> 1, cuh >> 1
        for plane, pred, coef, qpc in ((self.rec_u, pred_u, coef_u, qp_u),
                                       (self.rec_v, pred_v, coef_v, qp_v)):
            resi = None
            if coef is not None:
                resi = self._resi_chroma(coef, qpc, wc, hc)
            plane[yc:yc + hc, xc:xc + wc] = rk.recon_block(pred, resi, bd)

    # -- intra reconstruction ----------------------------------------------
    def _avail_rows(self, x_scu, y_scu, n_units, step_scu):
        """Availability per unit along the up row, reference semantics
        (xeve_ipred.c:73-83): y_scu>0, x within picture, neighbor COD."""
        out = np.zeros(n_units, dtype=bool)
        if y_scu > 0:
            for i in range(n_units):
                xi = x_scu + i * step_scu
                if xi < self.w_scu and self.map_cod[y_scu - 1, xi]:
                    out[i] = True
        return out

    def _avail_cols(self, x_scu, y_scu, n_units, step_scu):
        out = np.zeros(n_units, dtype=bool)
        if x_scu > 0:
            for i in range(n_units):
                yi = y_scu + i * step_scu
                if yi < self.h_scu and self.map_cod[yi, x_scu - 1]:
                    out[i] = True
        return out

    def gather_nb(self, plane, x, y, w, h, x_scu, y_scu, unit, step_scu):
        n_up_units = (w + h) // unit
        n_le_units = (h + w) // unit
        up_avail = self._avail_rows(x_scu, y_scu, n_up_units, step_scu)
        le_avail = self._avail_cols(x_scu, y_scu, n_le_units, step_scu)
        ul_avail = (x_scu > 0 and y_scu > 0 and
                    self.map_cod[y_scu - 1, x_scu - 1])
        mid = 1 << (self.bd - 1)
        up = np.full(w + h, mid, dtype=np.int32)
        left = np.full(h + w, mid, dtype=np.int32)
        H, W = plane.shape
        for i in range(n_up_units):
            if up_avail[i]:
                xs = x + i * unit
                seg = plane[y - 1, xs:min(xs + unit, W)]
                up[i * unit:i * unit + len(seg)] = seg
        for i in range(n_le_units):
            if le_avail[i]:
                ysg = y + i * unit
                seg = plane[ysg:min(ysg + unit, H), x - 1]
                left[i * unit:i * unit + len(seg)] = seg
        up_left = int(plane[y - 1, x - 1]) if ul_avail else mid
        return up, left, up_left

    def _recon_intra_cu(self, x, y, cuw, cuh, ipm, qp_y, qp_u, qp_v,
                        coef_y, coef_u, coef_v, ipm_c=0):
        bd = self.bd
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        eipd = bool(self.sps.tool_eipd)
        # luma
        if eipd:
            nb = im.get_nbr_main(self.rec_y, x, y, cuw, cuh, x_scu, y_scu,
                                 self.map_cod, self.w_scu, self.h_scu,
                                 MIN_CU_SIZE, bd)
            pred = im.ipred_main(ipm, nb, cuw, cuh, bd)
        else:
            up, left, ul = self.gather_nb(self.rec_y, x, y, cuw, cuh,
                                          x_scu, y_scu, MIN_CU_SIZE, 1)
            pred = rk.ipred(ipm, up, left, ul, cuw, cuh)
        resi = None
        if coef_y is not None:
            resi = self._resi_luma(coef_y, qp_y, cuw, cuh)
        self.rec_y[y:y + cuh, x:x + cuw] = rk.recon_block(pred, resi, bd)
        # chroma
        xc, yc = x >> 1, y >> 1
        wc, hc = cuw >> 1, cuh >> 1
        for plane, coef, qp_c in ((self.rec_u, coef_u, qp_u),
                                  (self.rec_v, coef_v, qp_v)):
            if eipd:
                nb = im.get_nbr_main(plane, xc, yc, wc, hc, x_scu, y_scu,
                                     self.map_cod, self.w_scu, self.h_scu,
                                     MIN_CU_SIZE >> 1, bd)
                pred = im.ipred_uv_main(ipm_c, ipm, nb, wc, hc, bd)
            else:
                up, left, ul = self.gather_nb(plane, xc, yc, wc, hc,
                                              x_scu, y_scu,
                                              MIN_CU_SIZE >> 1, 1)
                pred = rk.ipred(ipm, up, left, ul, wc, hc)
            resi = None
            if coef is not None:
                resi = self._resi_chroma(coef, qp_c, wc, hc)
            plane[yc:yc + hc, xc:xc + wc] = rk.recon_block(pred, resi, bd)

    # -- deblocking ---------------------------------------------------------
    def _deblock_cus(self):
        """Deblock work list: leaf CUs above the max transform size split
        into 64-max quadrants so their internal TU edges filter like CU
        edges (xevem_deblock_unit, xevem_df.c:1079/1148)."""
        out = []
        for (x, y, w, h) in self.leaf_cus:
            if w <= 64 and h <= 64:
                out.append((x, y, w, h))
                continue
            for yo in range(0, h, min(h, 64)):
                for xo in range(0, w, min(w, 64)):
                    out.append((x + xo, y + yo, min(w, 64), min(h, 64)))
        return out

    def _deblock(self):
        tidx = None
        if not self.pps.single_tile_in_pic_flag and \
                not self.pps.loop_filter_across_tiles_enabled_flag:
            tidx = self.map_tidx
        if self.sps.tool_addb:
            from ..ops.addb_np import deblock_frame_addb
            ref_pocs = ([p["poc"] for p in self.refp],
                        [p["poc"] for p in self.refp1])
            deblock_frame_addb(self.rec_y, self.rec_u, self.rec_v,
                               self._deblock_cus(), self.map_if,
                               self.map_cbf_l,
                               self.map_qp, self.map_refi, self.map_mv,
                               ref_pocs,
                               self.sh.qp_u_offset, self.sh.qp_v_offset,
                               self.bd, self.sps.bit_depth_chroma_minus8,
                               alpha_off=self.sh.sh_deblock_alpha_offset,
                               beta_off=self.sh.sh_deblock_beta_offset,
                               main_qp_table=self.sps.tool_iqt,
                               map_tidx=tidx,
                               log2_ctu=self.log2_max_cuwh)
            return
        from ..ops.deblock_np import deblock_frame
        deblock_frame(self.rec_y, self.rec_u, self.rec_v,
                      self._deblock_cus(),
                      self.map_if, self.map_cbf_l, self.map_qp,
                      self.sh.qp_u_offset, self.sh.qp_v_offset,
                      self.bd, self.sps.bit_depth_chroma_minus8,
                      map_refi=self.map_refi, map_mv=self.map_mv,
                      main_qp_table=self.sps.tool_iqt, map_tidx=tidx)
