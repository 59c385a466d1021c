"""High-level syntax: NAL unit framing, SPS/PPS/SH write + parse.

Bitstream layout per reference encoder output (src_base/xeve_eco.c:35-290):
every NAL unit is prefixed with a 4-byte big-endian length (payload length
excluding the 4 length bytes), followed by a 2-byte NAL header.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .io.bits import BitWriter, BitReader
from .constants import (NUT_IDR, NUT_NONIDR, NUT_SPS, NUT_PPS, NUT_SEI,
                        SLICE_I, SLICE_P, SLICE_B)


# ---------------------------------------------------------------------------
# NAL
# ---------------------------------------------------------------------------

@dataclass
class NalHeader:
    nal_unit_type: int = NUT_NONIDR
    nuh_temporal_id: int = 0

    def write(self, bw: BitWriter):
        bw.write1(0)                              # forbidden_zero_bit
        bw.write(self.nal_unit_type + 1, 6)       # nal_unit_type_plus1
        bw.write(self.nuh_temporal_id, 3)
        bw.write(0, 5)                            # nuh_reserved_zero_5bits
        bw.write1(0)                              # nuh_extension_flag

    @classmethod
    def parse(cls, br: BitReader) -> "NalHeader":
        br.read1()
        nut = br.read(6) - 1
        tid = br.read(3)
        br.read(5)
        br.read1()
        return cls(nut, tid)


def wrap_nal(payload: bytes) -> bytes:
    return len(payload).to_bytes(4, "big") + payload


def split_nals(stream: bytes):
    """Yield (nal_unit_type, temporal_id, payload_bytes_after_header,
    full_payload) for each length-prefixed NAL in the stream."""
    pos = 0
    while pos + 4 <= len(stream):
        size = int.from_bytes(stream[pos:pos + 4], "big")
        payload = stream[pos + 4:pos + 4 + size]
        br = BitReader(payload)
        hdr = NalHeader.parse(br)
        yield hdr, payload[2:], payload
        pos += 4 + size


# ---------------------------------------------------------------------------
# Reference picture list entry (xeve_eco_rlp, xevem_eco.c:276)
# ---------------------------------------------------------------------------

@dataclass
class RPL:
    ref_pics: list = field(default_factory=list)   # signed delta POCs (absolute refs)
    ref_pic_active_num: int = 0

    def write(self, bw: BitWriter):
        bw.write_ue(len(self.ref_pics))
        prev = 0
        for i, rp in enumerate(self.ref_pics):
            delta = abs(rp - prev)
            bw.write_ue(delta)
            if delta != 0:
                bw.write1(1 if prev > rp else 0)
            prev = rp

    @classmethod
    def parse(cls, br: BitReader) -> "RPL":
        r = cls()
        n = br.read_ue()
        prev = 0
        for i in range(n):
            delta = br.read_ue()
            if delta != 0:
                sign = br.read1()
                prev = prev - delta if sign else prev + delta
            r.ref_pics.append(prev)
        return r


# ---------------------------------------------------------------------------
# SPS  (baseline: xeve_eco_sps, xeve_eco.c:140; main: xevem_eco_sps,
# xevem_eco.c:328 — conditional tool syntax)
# ---------------------------------------------------------------------------

@dataclass
class SPS:
    sps_seq_parameter_set_id: int = 0
    profile_idc: int = 0
    level_idc: int = 120
    toolset_idc_h: int = 0
    toolset_idc_l: int = 0
    chroma_format_idc: int = 1
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    bit_depth_luma_minus8: int = 2
    bit_depth_chroma_minus8: int = 2
    sps_btt_flag: int = 0
    sps_suco_flag: int = 0
    tool_admvp: int = 0
    tool_eipd: int = 0
    tool_cm_init: int = 0
    tool_iqt: int = 0
    tool_addb: int = 0
    tool_alf: int = 0
    tool_htdf: int = 0
    tool_rpl: int = 0
    tool_pocs: int = 0
    dquant_flag: int = 0
    tool_dra: int = 0
    # main-profile btt/suco geometry (xevem_eco_sps conditional fields)
    log2_ctu_size_minus5: int = 1
    log2_min_cb_size_minus2: int = 0
    log2_diff_ctu_max_14_cb_size: int = 0
    log2_diff_ctu_max_tt_cb_size: int = 0
    log2_diff_min_cb_min_tt_cb_size_minus2: int = 0
    log2_diff_ctu_size_max_suco_cb_size: int = 0
    log2_diff_max_suco_min_suco_cb_size: int = 0
    # main-profile sub-tools
    tool_affine: int = 0
    tool_amvr: int = 0
    tool_dmvr: int = 0
    tool_mmvd: int = 0
    tool_hmvp: int = 0
    ibc_flag: int = 0
    ibc_log_max_size: int = 2
    tool_adcc: int = 0
    tool_ats: int = 0
    # POC / RPL
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    sps_max_dec_pic_buffering_minus1: int = 0
    long_term_ref_pics_flag: int = 0
    rpl1_same_as_rpl0_flag: int = 0
    rpls_l0: list = field(default_factory=list)
    rpls_l1: list = field(default_factory=list)
    log2_sub_gop_length: int = 0
    log2_ref_pic_gap_length: int = 0
    max_num_ref_pics: int = 0
    picture_cropping_flag: int = 0
    picture_crop_left_offset: int = 0
    picture_crop_right_offset: int = 0
    picture_crop_top_offset: int = 0
    picture_crop_bottom_offset: int = 0
    chroma_qp_table_present_flag: int = 0
    vui_parameters_present_flag: int = 0

    def write(self, bw: BitWriter):
        main = self.profile_idc == 1
        bw.write_ue(self.sps_seq_parameter_set_id)
        bw.write(self.profile_idc, 8)
        bw.write(self.level_idc, 8)
        bw.write(self.toolset_idc_h, 32)
        bw.write(self.toolset_idc_l, 32)
        bw.write_ue(self.chroma_format_idc)
        bw.write_ue(self.pic_width_in_luma_samples)
        bw.write_ue(self.pic_height_in_luma_samples)
        bw.write_ue(self.bit_depth_luma_minus8)
        bw.write_ue(self.bit_depth_chroma_minus8)
        if not main:
            for f in (self.sps_btt_flag, self.sps_suco_flag, self.tool_admvp,
                      self.tool_eipd, self.tool_cm_init, self.tool_iqt,
                      self.tool_addb, self.tool_alf, self.tool_htdf,
                      self.tool_rpl, self.tool_pocs, self.dquant_flag,
                      self.tool_dra):
                bw.write1(f)
        else:
            bw.write1(self.sps_btt_flag)
            if self.sps_btt_flag:
                bw.write_ue(self.log2_ctu_size_minus5)
                bw.write_ue(self.log2_min_cb_size_minus2)
                bw.write_ue(self.log2_diff_ctu_max_14_cb_size)
                bw.write_ue(self.log2_diff_ctu_max_tt_cb_size)
                bw.write_ue(self.log2_diff_min_cb_min_tt_cb_size_minus2)
            bw.write1(self.sps_suco_flag)
            if self.sps_suco_flag:
                bw.write_ue(self.log2_diff_ctu_size_max_suco_cb_size)
                bw.write_ue(self.log2_diff_max_suco_min_suco_cb_size)
            bw.write1(self.tool_admvp)
            if self.tool_admvp:
                bw.write1(self.tool_affine)
                bw.write1(self.tool_amvr)
                bw.write1(self.tool_dmvr)
                bw.write1(self.tool_mmvd)
                bw.write1(self.tool_hmvp)
            bw.write1(self.tool_eipd)
            if self.tool_eipd:
                bw.write1(self.ibc_flag)
                if self.ibc_flag:
                    bw.write_ue(self.ibc_log_max_size - 2)
            bw.write1(self.tool_cm_init)
            if self.tool_cm_init:
                bw.write1(self.tool_adcc)
            bw.write1(self.tool_iqt)
            if self.tool_iqt:
                bw.write1(self.tool_ats)
            bw.write1(self.tool_addb)
            bw.write1(self.tool_alf)
            bw.write1(self.tool_htdf)
            bw.write1(self.tool_rpl)
            bw.write1(self.tool_pocs)
            bw.write1(self.dquant_flag)
            bw.write1(self.tool_dra)
            if self.tool_pocs:
                bw.write_ue(self.log2_max_pic_order_cnt_lsb_minus4)
        if not main or not self.tool_rpl or not self.tool_pocs:
            bw.write_ue(self.log2_sub_gop_length)
            if self.log2_sub_gop_length == 0:
                bw.write_ue(self.log2_ref_pic_gap_length)
        if not main or not self.tool_rpl:
            bw.write_ue(self.max_num_ref_pics)
        elif main and self.tool_rpl:
            bw.write_ue(self.sps_max_dec_pic_buffering_minus1)
            bw.write1(self.long_term_ref_pics_flag)
            bw.write1(self.rpl1_same_as_rpl0_flag)
            bw.write_ue(len(self.rpls_l0))
            for r in self.rpls_l0:
                r.write(bw)
            if not self.rpl1_same_as_rpl0_flag:
                bw.write_ue(len(self.rpls_l1))
                for r in self.rpls_l1:
                    r.write(bw)
        bw.write1(self.picture_cropping_flag)
        if self.picture_cropping_flag:
            bw.write_ue(self.picture_crop_left_offset)
            bw.write_ue(self.picture_crop_right_offset)
            bw.write_ue(self.picture_crop_top_offset)
            bw.write_ue(self.picture_crop_bottom_offset)
        if self.chroma_format_idc != 0:
            bw.write1(self.chroma_qp_table_present_flag)
            assert self.chroma_qp_table_present_flag == 0, "explicit table TBD"
        bw.write1(self.vui_parameters_present_flag)
        assert self.vui_parameters_present_flag == 0
        bw.byte_align()

    @classmethod
    def parse(cls, br: BitReader) -> "SPS":
        s = cls()
        s.sps_seq_parameter_set_id = br.read_ue()
        s.profile_idc = br.read(8)
        s.level_idc = br.read(8)
        s.toolset_idc_h = br.read(32)
        s.toolset_idc_l = br.read(32)
        s.chroma_format_idc = br.read_ue()
        s.pic_width_in_luma_samples = br.read_ue()
        s.pic_height_in_luma_samples = br.read_ue()
        s.bit_depth_luma_minus8 = br.read_ue()
        s.bit_depth_chroma_minus8 = br.read_ue()
        main = s.profile_idc == 1
        if not main:
            (s.sps_btt_flag, s.sps_suco_flag, s.tool_admvp, s.tool_eipd,
             s.tool_cm_init, s.tool_iqt, s.tool_addb, s.tool_alf, s.tool_htdf,
             s.tool_rpl, s.tool_pocs, s.dquant_flag, s.tool_dra) = \
                (br.read1() for _ in range(13))
        else:
            s.sps_btt_flag = br.read1()
            if s.sps_btt_flag:
                s.log2_ctu_size_minus5 = br.read_ue()
                s.log2_min_cb_size_minus2 = br.read_ue()
                s.log2_diff_ctu_max_14_cb_size = br.read_ue()
                s.log2_diff_ctu_max_tt_cb_size = br.read_ue()
                s.log2_diff_min_cb_min_tt_cb_size_minus2 = br.read_ue()
            s.sps_suco_flag = br.read1()
            if s.sps_suco_flag:
                s.log2_diff_ctu_size_max_suco_cb_size = br.read_ue()
                s.log2_diff_max_suco_min_suco_cb_size = br.read_ue()
            s.tool_admvp = br.read1()
            if s.tool_admvp:
                s.tool_affine = br.read1()
                s.tool_amvr = br.read1()
                s.tool_dmvr = br.read1()
                s.tool_mmvd = br.read1()
                s.tool_hmvp = br.read1()
            s.tool_eipd = br.read1()
            if s.tool_eipd:
                s.ibc_flag = br.read1()
                if s.ibc_flag:
                    s.ibc_log_max_size = br.read_ue() + 2
            s.tool_cm_init = br.read1()
            if s.tool_cm_init:
                s.tool_adcc = br.read1()
            s.tool_iqt = br.read1()
            if s.tool_iqt:
                s.tool_ats = br.read1()
            s.tool_addb = br.read1()
            s.tool_alf = br.read1()
            s.tool_htdf = br.read1()
            s.tool_rpl = br.read1()
            s.tool_pocs = br.read1()
            s.dquant_flag = br.read1()
            s.tool_dra = br.read1()
            if s.tool_pocs:
                s.log2_max_pic_order_cnt_lsb_minus4 = br.read_ue()
        if not main or not s.tool_rpl or not s.tool_pocs:
            s.log2_sub_gop_length = br.read_ue()
            if s.log2_sub_gop_length == 0:
                s.log2_ref_pic_gap_length = br.read_ue()
        if not main or not s.tool_rpl:
            s.max_num_ref_pics = br.read_ue()
        else:
            s.sps_max_dec_pic_buffering_minus1 = br.read_ue()
            s.long_term_ref_pics_flag = br.read1()
            s.rpl1_same_as_rpl0_flag = br.read1()
            n0 = br.read_ue()
            s.rpls_l0 = [RPL.parse(br) for _ in range(n0)]
            if not s.rpl1_same_as_rpl0_flag:
                n1 = br.read_ue()
                s.rpls_l1 = [RPL.parse(br) for _ in range(n1)]
            else:
                s.rpls_l1 = list(s.rpls_l0)
        s.picture_cropping_flag = br.read1()
        if s.picture_cropping_flag:
            s.picture_crop_left_offset = br.read_ue()
            s.picture_crop_right_offset = br.read_ue()
            s.picture_crop_top_offset = br.read_ue()
            s.picture_crop_bottom_offset = br.read_ue()
        if s.chroma_format_idc != 0:
            s.chroma_qp_table_present_flag = br.read1()
            assert s.chroma_qp_table_present_flag == 0, "explicit chroma QP table unsupported"
        s.vui_parameters_present_flag = br.read1()
        assert s.vui_parameters_present_flag == 0
        br.byte_align()
        return s

    # derived geometry (xevem_util.c:3578-3593)
    @property
    def max_cuwh(self) -> int:
        if self.profile_idc == 1 and self.sps_btt_flag:
            return 1 << (self.log2_ctu_size_minus5 + 5)
        return 64


# ---------------------------------------------------------------------------
# PPS  (xeve_eco_pps, xeve_eco.c:215)
# ---------------------------------------------------------------------------

@dataclass
class PPS:
    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    num_ref_idx_default_active_minus1: tuple = (0, 0)
    additional_lt_poc_lsb_len: int = 0
    rpl1_idx_present_flag: int = 0
    single_tile_in_pic_flag: int = 1
    # multi-tile geometry (main profile, xevem_eco_pps conditional fields)
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    uniform_tile_spacing_flag: int = 1
    tile_column_width_minus1: list = field(default_factory=list)
    tile_row_height_minus1: list = field(default_factory=list)
    loop_filter_across_tiles_enabled_flag: int = 0
    tile_offset_lens_minus1: int = 31
    tile_id_len_minus1: int = 0
    explicit_tile_id_flag: int = 0
    pic_dra_enabled_flag: int = 0
    pic_dra_aps_id: int = 0
    arbitrary_slice_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    cu_qp_delta_enabled_flag: int = 0
    cu_qp_delta_area: int = 6

    APS_ID_BITS = 5   # APS_MAX_NUM_IN_BITS

    def write(self, bw: BitWriter, main: bool = False):
        bw.write_ue(self.pps_pic_parameter_set_id)
        bw.write_ue(self.pps_seq_parameter_set_id)
        bw.write_ue(self.num_ref_idx_default_active_minus1[0])
        bw.write_ue(self.num_ref_idx_default_active_minus1[1])
        bw.write_ue(self.additional_lt_poc_lsb_len)
        bw.write1(self.rpl1_idx_present_flag)
        bw.write1(self.single_tile_in_pic_flag)
        if main and not self.single_tile_in_pic_flag:
            bw.write_ue(self.num_tile_columns_minus1)
            bw.write_ue(self.num_tile_rows_minus1)
            bw.write1(self.uniform_tile_spacing_flag)
            if not self.uniform_tile_spacing_flag:
                for wv in self.tile_column_width_minus1[:self.num_tile_columns_minus1]:
                    bw.write_ue(wv)
                for hv in self.tile_row_height_minus1[:self.num_tile_rows_minus1]:
                    bw.write_ue(hv)
            bw.write1(self.loop_filter_across_tiles_enabled_flag)
            bw.write_ue(self.tile_offset_lens_minus1)
        bw.write_ue(self.tile_id_len_minus1)
        bw.write1(self.explicit_tile_id_flag)
        assert self.explicit_tile_id_flag == 0, "explicit tile ids TBD"
        bw.write1(self.pic_dra_enabled_flag)
        if main and self.pic_dra_enabled_flag:
            bw.write(self.pic_dra_aps_id, self.APS_ID_BITS)
        bw.write1(self.arbitrary_slice_present_flag)
        bw.write1(self.constrained_intra_pred_flag)
        bw.write1(self.cu_qp_delta_enabled_flag)
        if self.cu_qp_delta_enabled_flag:
            bw.write_ue(self.cu_qp_delta_area - 6)
        bw.byte_align()

    @classmethod
    def parse(cls, br: BitReader, main: bool = False) -> "PPS":
        p = cls()
        p.pps_pic_parameter_set_id = br.read_ue()
        p.pps_seq_parameter_set_id = br.read_ue()
        p.num_ref_idx_default_active_minus1 = (br.read_ue(), br.read_ue())
        p.additional_lt_poc_lsb_len = br.read_ue()
        p.rpl1_idx_present_flag = br.read1()
        p.single_tile_in_pic_flag = br.read1()
        if main and not p.single_tile_in_pic_flag:
            p.num_tile_columns_minus1 = br.read_ue()
            p.num_tile_rows_minus1 = br.read_ue()
            p.uniform_tile_spacing_flag = br.read1()
            if not p.uniform_tile_spacing_flag:
                p.tile_column_width_minus1 = [br.read_ue() for _ in range(p.num_tile_columns_minus1)]
                p.tile_row_height_minus1 = [br.read_ue() for _ in range(p.num_tile_rows_minus1)]
            p.loop_filter_across_tiles_enabled_flag = br.read1()
            p.tile_offset_lens_minus1 = br.read_ue()
        p.tile_id_len_minus1 = br.read_ue()
        p.explicit_tile_id_flag = br.read1()
        assert p.explicit_tile_id_flag == 0, "explicit tile ids unsupported"
        p.pic_dra_enabled_flag = br.read1()
        if main and p.pic_dra_enabled_flag:
            p.pic_dra_aps_id = br.read(cls.APS_ID_BITS)
        p.arbitrary_slice_present_flag = br.read1()
        p.constrained_intra_pred_flag = br.read1()
        p.cu_qp_delta_enabled_flag = br.read1()
        if p.cu_qp_delta_enabled_flag:
            p.cu_qp_delta_area = br.read_ue() + 6
        br.byte_align()
        return p


# ---------------------------------------------------------------------------
# Slice header  (baseline: xeve_eco_sh, xeve_eco.c:248;
#                main: xevem_eco_sh, xevem_eco.c:499)
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    slice_pic_parameter_set_id: int = 0
    slice_type: int = SLICE_I
    no_output_of_prior_pics_flag: int = 0
    num_ref_idx_active_override_flag: int = 0
    num_ref_idx_active: tuple = (1, 1)
    deblocking_filter_on: int = 1
    qp: int = 32
    qp_u_offset: int = 0
    qp_v_offset: int = 0
    # main-profile fields
    single_tile_in_slice_flag: int = 1
    first_tile_id: int = 0
    arbitrary_slice_flag: int = 0
    last_tile_id: int = 0
    num_remaining_tiles_in_slice_minus1: int = 0
    delta_tile_id_minus1: list = field(default_factory=list)
    mmvd_group_enable_flag: int = 0
    alf_on: int = 0
    aps_id_y: int = 0
    aps_id_ch: int = 0
    alf_sh_param: object = None
    alf_chroma_idc: int = 0
    poc_lsb: int = 0
    ref_pic_list_sps_flag: tuple = (0, 0)
    rpl_l0_idx: int = 0
    rpl_l1_idx: int = 0
    rpl_l0: object = None
    rpl_l1: object = None
    temporal_mvp_asigned_flag: int = 0
    collocated_from_list_idx: int = 1      # defaults per xevem semantics
    collocated_mvp_source_list_idx: int = 0
    collocated_from_ref_idx: int = 0
    sh_deblock_alpha_offset: int = 0
    sh_deblock_beta_offset: int = 0
    entry_point_offsets: list = field(default_factory=list)

    APS_ID_BITS = 5

    def write(self, bw: BitWriter, nut: int, sps: "SPS" = None, pps: "PPS" = None):
        main = sps is not None and sps.profile_idc == 1
        bw.write_ue(self.slice_pic_parameter_set_id)
        if main and pps is not None and not pps.single_tile_in_pic_flag:
            bw.write1(self.single_tile_in_slice_flag)
            bw.write(self.first_tile_id, pps.tile_id_len_minus1 + 1)
            if not self.single_tile_in_slice_flag:
                if pps.arbitrary_slice_present_flag:
                    bw.write1(self.arbitrary_slice_flag)
                if not self.arbitrary_slice_flag:
                    bw.write(self.last_tile_id, pps.tile_id_len_minus1 + 1)
                else:
                    bw.write_ue(self.num_remaining_tiles_in_slice_minus1)
                    for d in self.delta_tile_id_minus1:
                        bw.write_ue(d)
        bw.write_ue(self.slice_type)
        if nut == NUT_IDR:
            bw.write1(self.no_output_of_prior_pics_flag)
        if main:
            if sps.tool_mmvd and self.slice_type in (SLICE_P, SLICE_B):
                bw.write1(self.mmvd_group_enable_flag)
            if sps.tool_alf:
                bw.write1(self.alf_on)
                assert not self.alf_on, "ALF slice params TBD"
            if nut != NUT_IDR:
                if sps.tool_pocs:
                    bw.write(self.poc_lsb,
                             sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
                if sps.tool_rpl:
                    if len(sps.rpls_l0) > 0:
                        bw.write1(self.ref_pic_list_sps_flag[0])
                    if self.ref_pic_list_sps_flag[0]:
                        if len(sps.rpls_l0) > 1:
                            bw.write_ue(self.rpl_l0_idx)
                    else:
                        self.rpl_l0.write(bw)
                    # flag[1]/idx[1] are inferred when not presented
                    # (xevem_eco.c:608-617)
                    if len(sps.rpls_l1) > 0 and pps.rpl1_idx_present_flag:
                        bw.write1(self.ref_pic_list_sps_flag[1])
                    if self.ref_pic_list_sps_flag[1]:
                        if len(sps.rpls_l1) > 1 and pps.rpl1_idx_present_flag:
                            bw.write_ue(self.rpl_l1_idx)
                    else:
                        self.rpl_l1.write(bw)
        if self.slice_type != SLICE_I:
            bw.write1(self.num_ref_idx_active_override_flag)
            if self.num_ref_idx_active_override_flag:
                bw.write_ue(self.num_ref_idx_active[0] - 1)
                if self.slice_type == SLICE_B:
                    bw.write_ue(self.num_ref_idx_active[1] - 1)
            if main and sps.tool_admvp:
                bw.write1(self.temporal_mvp_asigned_flag)
                if self.temporal_mvp_asigned_flag:
                    if self.slice_type == SLICE_B:
                        bw.write1(self.collocated_from_list_idx)
                        bw.write1(self.collocated_mvp_source_list_idx)
                    bw.write1(self.collocated_from_ref_idx)
        bw.write1(self.deblocking_filter_on)
        if main and self.deblocking_filter_on and sps.tool_addb:
            bw.write_se(self.sh_deblock_alpha_offset)
            bw.write_se(self.sh_deblock_beta_offset)
        bw.write(self.qp, 6)
        bw.write_se(self.qp_u_offset)
        bw.write_se(self.qp_v_offset)
        if main and not self.single_tile_in_slice_flag:
            for off in self.entry_point_offsets:
                bw.write(off, pps.tile_offset_lens_minus1 + 1)
        bw.byte_align()

    @classmethod
    def parse(cls, br: BitReader, nut: int, sps: "SPS" = None,
              pps: "PPS" = None) -> "SliceHeader":
        sh = cls()
        main = sps is not None and sps.profile_idc == 1
        sh.slice_pic_parameter_set_id = br.read_ue()
        if main and pps is not None and not pps.single_tile_in_pic_flag:
            sh.single_tile_in_slice_flag = br.read1()
            sh.first_tile_id = br.read(pps.tile_id_len_minus1 + 1)
            if not sh.single_tile_in_slice_flag:
                if pps.arbitrary_slice_present_flag:
                    sh.arbitrary_slice_flag = br.read1()
                if not sh.arbitrary_slice_flag:
                    sh.last_tile_id = br.read(pps.tile_id_len_minus1 + 1)
                else:
                    sh.num_remaining_tiles_in_slice_minus1 = br.read_ue()
                    sh.delta_tile_id_minus1 = [
                        br.read_ue()
                        for _ in range(sh.num_remaining_tiles_in_slice_minus1 + 1)]
        sh.slice_type = br.read_ue()
        if nut == NUT_IDR:
            sh.no_output_of_prior_pics_flag = br.read1()
        if main:
            if sps.tool_mmvd and sh.slice_type in (SLICE_P, SLICE_B):
                sh.mmvd_group_enable_flag = br.read1()
            if sps.tool_alf:
                sh.alf_on = br.read1()
                assert not sh.alf_on, "ALF slice params unsupported yet"
            if nut != NUT_IDR:
                if sps.tool_pocs:
                    sh.poc_lsb = br.read(
                        sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
                if sps.tool_rpl:
                    f0 = br.read1() if len(sps.rpls_l0) > 0 else 0
                    if f0:
                        sh.rpl_l0_idx = br.read_ue() if len(sps.rpls_l0) > 1 else 0
                        sh.rpl_l0 = sps.rpls_l0[sh.rpl_l0_idx]
                    else:
                        sh.rpl_l0 = RPL.parse(br)
                    # flag[1]/idx[1] are inferred from list 0 when the PPS
                    # does not present them (xevem_eco.c:608-617 inverse)
                    if len(sps.rpls_l1) > 0 and pps.rpl1_idx_present_flag:
                        f1 = br.read1()
                    else:
                        f1 = f0
                    if f1:
                        if (len(sps.rpls_l1) > 1 and
                                pps.rpl1_idx_present_flag):
                            sh.rpl_l1_idx = br.read_ue()
                        else:
                            sh.rpl_l1_idx = sh.rpl_l0_idx
                        sh.rpl_l1 = sps.rpls_l1[sh.rpl_l1_idx]
                    else:
                        sh.rpl_l1 = RPL.parse(br)
                    sh.ref_pic_list_sps_flag = (f0, f1)
        if sh.slice_type != SLICE_I:
            sh.num_ref_idx_active_override_flag = br.read1()
            if sh.num_ref_idx_active_override_flag:
                n0 = br.read_ue() + 1
                n1 = 1
                if sh.slice_type == SLICE_B:
                    n1 = br.read_ue() + 1
                sh.num_ref_idx_active = (n0, n1)
            elif main and sps.tool_rpl:
                sh.num_ref_idx_active = (
                    pps.num_ref_idx_default_active_minus1[0] + 1,
                    pps.num_ref_idx_default_active_minus1[1] + 1)
            if main and sps.tool_admvp:
                sh.temporal_mvp_asigned_flag = br.read1()
                if sh.temporal_mvp_asigned_flag:
                    if sh.slice_type == SLICE_B:
                        sh.collocated_from_list_idx = br.read1()
                        sh.collocated_mvp_source_list_idx = br.read1()
                    sh.collocated_from_ref_idx = br.read1()
        sh.deblocking_filter_on = br.read1()
        if main and sh.deblocking_filter_on and sps.tool_addb:
            sh.sh_deblock_alpha_offset = br.read_se()
            sh.sh_deblock_beta_offset = br.read_se()
        sh.qp = br.read(6)
        sh.qp_u_offset = br.read_se()
        sh.qp_v_offset = br.read_se()
        if main and not sh.single_tile_in_slice_flag:
            ntiles = (sh.num_remaining_tiles_in_slice_minus1 + 2
                      if sh.arbitrary_slice_flag else None)
            if ntiles is None:
                # uniform range first..last tile id
                ntiles = sh.last_tile_id - sh.first_tile_id + 1  # row-major span
            sh.entry_point_offsets = [
                br.read(pps.tile_offset_lens_minus1 + 1)
                for _ in range(ntiles - 1)]
        br.byte_align()
        return sh
