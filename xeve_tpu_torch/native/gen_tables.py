"""Generate tables.h for the native library from xeve_tpu_torch.constants
(single source of truth, itself verified against the spec in tests).

The port's copy of xeve_tpu/native/gen_tables.py, reading the port's own
copies of the tables.  native/build.py never runs it: tables.h is
committed.  python -m xeve_tpu_torch.native.gen_tables [out_path]"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
from xeve_tpu_torch.constants import (TM, SCAN, QUANT_SCALE,
                                      DQUANT_SCALE_B, DF_ST, MPM_TBL,
                                      QP_CHROMA_ADJUST,
                                      QP_CHROMA_ADJUST_MAIN,
                                      DQUANT_SCALE_MAIN)

# XtCtx field layout for cm_init initialization — MUST mirror the C struct
# declaration order in xt_core.c (field name in entropy/ctx_init.CTX_INIT,
# context count).
CTX_LAYOUT = [
    ("split_cu_flag", 1),
    ("intra_dir", 2),
    ("cbf_luma", 1), ("cbf_cb", 1), ("cbf_cr", 1), ("cbf_all", 1),
    ("run", 24), ("last", 2), ("level", 24),
    ("dqp", 1),
    ("skip_flag", 2), ("direct_mode_flag", 1), ("inter_dir", 2),
    ("pred_mode", 3), ("refi", 2), ("mvp_idx", 3), ("mvd", 1),
    ("intra_luma_pred_mpm_flag", 1), ("intra_luma_pred_mpm_idx", 1),
    ("intra_chroma_pred_mode", 1),
    ("sig_coeff_flag", 47), ("coeff_abs_level_greaterAB_flag", 18),
    ("last_sig_coeff_x_prefix", 21), ("last_sig_coeff_y_prefix", 21),
    ("ats_mode", 1), ("ats_cu_inter_flag", 2),
    ("ats_cu_inter_quad_flag", 1), ("ats_cu_inter_hor_flag", 3),
    ("ats_cu_inter_pos_flag", 1),
    ("btt_split_flag", 15), ("btt_split_dir", 5), ("btt_split_type", 1),
]


def carr(name, arr, ctype="int16_t"):
    flat = np.asarray(arr).reshape(-1)
    vals = ",".join(str(int(v)) for v in flat)
    return f"static const {ctype} {name}[{len(flat)}] = {{{vals}}};\n"


def main(out_path):
    from xeve_tpu_torch.entropy.ctx_init import CTX_INIT
    from xeve_tpu_torch.ops.intra_main_np import (TBL_ADI, TBL_DXDY,
                                                  INTRA_MODE_LIST)
    from xeve_tpu_torch.entropy.adcc import (GROUP_IDX, MIN_IN_GROUP,
                                             GO_RICE_RANGE, GO_RICE_PARA)
    with open(out_path, "w") as f:
        f.write("/* auto-generated by gen_tables.py - do not edit */\n")
        f.write("#pragma once\n#include <stdint.h>\n\n")
        for n in (2, 4, 8, 16, 32, 64):
            f.write(carr(f"XT_TM{n}", TM[n], "int8_t"))
        f.write("static const int8_t* XT_TM[7] = {0, XT_TM2, XT_TM4, XT_TM8,"
                " XT_TM16, XT_TM32, XT_TM64};\n\n")
        for n in (2, 4, 8, 16, 32, 64):
            f.write(carr(f"XT_SCAN{n}", SCAN[(n, n)], "uint16_t"))
        f.write("static const uint16_t* XT_SCAN[7] = {0, XT_SCAN2, XT_SCAN4,"
                " XT_SCAN8, XT_SCAN16, XT_SCAN32, XT_SCAN64};\n\n")
        # rectangular scans for ADCC chroma/ATS TBs (w != h)
        for (w, h) in [(k, k >> 1) for k in (4, 8, 16, 32, 64)] + \
                      [(k >> 1, k) for k in (4, 8, 16, 32, 64)]:
            if (w, h) in SCAN:
                f.write(carr(f"XT_SCAN_{w}x{h}", SCAN[(w, h)], "uint16_t"))
        f.write(carr("XT_QUANT_SCALE", QUANT_SCALE[0], "int32_t"))
        f.write(carr("XT_QUANT_SCALE_IQT", QUANT_SCALE[1], "int32_t"))
        f.write(carr("XT_DQ_SCALE", DQUANT_SCALE_B, "int32_t"))
        f.write(carr("XT_DQ_SCALE_MAIN", DQUANT_SCALE_MAIN, "int32_t"))
        f.write(carr("XT_DF_ST", DF_ST, "uint8_t"))
        f.write(carr("XT_MPM", MPM_TBL, "uint8_t"))
        f.write(carr("XT_QP_CHROMA", QP_CHROMA_ADJUST, "int32_t"))
        f.write(carr("XT_QP_CHROMA_MAIN", QP_CHROMA_ADJUST_MAIN, "int32_t"))
        # Main-profile intra tables
        f.write(carr("XT_ADI", TBL_ADI, "int16_t"))
        f.write(carr("XT_DXDY", TBL_DXDY, "int32_t"))
        f.write(carr("XT_MODE_LIST", INTRA_MODE_LIST, "uint8_t"))
        # ATS transform matrices (DST-7 / DCT-8, constants_ats.py)
        from xeve_tpu_torch.constants_ats import TR_DST7, TR_DCT8
        for n in (4, 8, 16, 32):
            f.write(carr(f"XT_DST7_{n}", TR_DST7[n], "int16_t"))
            f.write(carr(f"XT_DCT8_{n}", TR_DCT8[n], "int16_t"))
        f.write("static const int16_t* XT_DST7[6] = {0, 0, XT_DST7_4,"
                " XT_DST7_8, XT_DST7_16, XT_DST7_32};\n")
        f.write("static const int16_t* XT_DCT8[6] = {0, 0, XT_DCT8_4,"
                " XT_DCT8_8, XT_DCT8_16, XT_DCT8_32};\n\n")
        # ADCC tables
        f.write(carr("XT_GROUP_IDX", GROUP_IDX, "uint8_t"))
        f.write(carr("XT_MIN_IN_GROUP", MIN_IN_GROUP, "uint8_t"))
        f.write(carr("XT_GO_RICE_RANGE", GO_RICE_RANGE, "uint8_t"))
        f.write(carr("XT_GO_RICE_PARA", GO_RICE_PARA, "uint8_t"))
        # cm_init context init values, laid out in XtCtx field order
        # (row 0: I-slice, row 1: P/B — matches entropy/sbac.ctx_array_init)
        rows = [[], []]
        for name, cnt in CTX_LAYOUT:
            tbl = CTX_INIT[name]
            assert len(tbl[0]) == cnt, (name, len(tbl[0]), cnt)
            rows[0].extend(tbl[0])
            rows[1].extend(tbl[1])
        f.write(f"#define XT_CTX_N {len(rows[0])}\n")
        f.write(carr("XT_CTX_INIT_I", rows[0], "int16_t"))
        f.write(carr("XT_CTX_INIT_PB", rows[1], "int16_t"))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables.h"))
