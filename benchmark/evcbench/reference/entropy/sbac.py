"""EVC SBAC binary arithmetic coder - Python reference implementation.

Encoder semantics follow the reference encoder exactly
(src_base/xeve_eco.c:397-672): 14-bit range, 512-state linear probability
contexts (state = LPS probability in 1/512 units, state <= 256 after
adaptation), byte-carry pipeline with 0xFF stacking and trailing-zero
suppression.  The decoder is the mathematical inverse, validated by
round-trip tests and by decoding reference-encoder bitstreams.

A fast C implementation lives in xeve_tpu/native; this module is the oracle.
"""
from __future__ import annotations

PROB_INIT = 512  # (256 << 1) | 0 : state 256, MPS 0


def ctx_array(n: int) -> list[int]:
    return [PROB_INIT] * n


def ctx_init_model(init_value: int, qp: int) -> int:
    """QP-adaptive context init (sps_cm_init_flag==1), the slope/offset
    decode of xeve_eco_sbac_ctx_initialize (xevem_util.c:2755)."""
    qp = min(max(qp, 0), 51)
    slope = (init_value & 14) << 4
    if init_value & 1:
        slope = -slope
    offset = ((init_value >> 4) & 62) << 7
    if (init_value >> 4) & 1:
        offset = -offset
    offset += 4096
    state = min(max((slope * qp + offset) >> 4, 1), 511)
    if state > 256:
        return ((512 - state) << 1) | 0
    return (state << 1) | 1


def ctx_array_init(name: str, n: int, slice_type, slice_qp) -> list[int]:
    from .ctx_init import CTX_INIT
    row = CTX_INIT[name][1 if slice_type in (0, 1) else 0]  # row1: P/B
    assert len(row) == n, f"{name}: table {len(row)} != {n}"
    return [ctx_init_model(v, slice_qp) for v in row]


class SbacCtx:
    """Context model set for the Baseline syntax (one instance per tile)."""

    __slots__ = (
        "skip_flag", "direct_mode_flag", "inter_dir", "intra_dir", "pred_mode",
        "refi", "mvp_idx", "mvd", "cbf_all", "cbf_luma", "cbf_cb", "cbf_cr",
        "run", "last", "level", "split_cu_flag", "delta_qp",
        "intra_luma_pred_mpm_flag", "intra_luma_pred_mpm_idx",
        "intra_chroma_pred_mode", "cm_init",
        "sig_coeff_flag", "coeff_abs_level_greaterAB_flag",
        "last_sig_coeff_x_prefix", "last_sig_coeff_y_prefix",
        "ats_mode", "ats_cu_inter_flag", "ats_cu_inter_quad_flag",
        "ats_cu_inter_hor_flag", "ats_cu_inter_pos_flag",
        "btt_split_flag", "btt_split_dir", "btt_split_type",
        "suco_flag", "mode_cons", "mvr_idx", "mmvd_flag",
    )

    # field -> (init-table name, context count)
    _SPEC = {
        "intra_luma_pred_mpm_flag": ("intra_luma_pred_mpm_flag", 1),
        "intra_luma_pred_mpm_idx": ("intra_luma_pred_mpm_idx", 1),
        "intra_chroma_pred_mode": ("intra_chroma_pred_mode", 1),
        "skip_flag": ("skip_flag", 2),
        "direct_mode_flag": ("direct_mode_flag", 1),
        "inter_dir": ("inter_dir", 2),
        "intra_dir": ("intra_dir", 2),
        "pred_mode": ("pred_mode", 3),
        "refi": ("refi", 2),
        "mvp_idx": ("mvp_idx", 3),
        "mvd": ("mvd", 1),
        "cbf_all": ("cbf_all", 1),
        "cbf_luma": ("cbf_luma", 1),
        "cbf_cb": ("cbf_cb", 1),
        "cbf_cr": ("cbf_cr", 1),
        "run": ("run", 24),
        "last": ("last", 2),
        "level": ("level", 24),
        "split_cu_flag": ("split_cu_flag", 1),
        "delta_qp": ("dqp", 1),
        # ADCC (sig map + gtA/gtB + last position)
        "sig_coeff_flag": ("sig_coeff_flag", 47),
        "coeff_abs_level_greaterAB_flag":
            ("coeff_abs_level_greaterAB_flag", 18),
        "last_sig_coeff_x_prefix": ("last_sig_coeff_x_prefix", 21),
        "last_sig_coeff_y_prefix": ("last_sig_coeff_y_prefix", 21),
        # ATS
        "ats_mode": ("ats_mode", 1),
        "ats_cu_inter_flag": ("ats_cu_inter_flag", 2),
        "ats_cu_inter_quad_flag": ("ats_cu_inter_quad_flag", 1),
        "ats_cu_inter_hor_flag": ("ats_cu_inter_hor_flag", 3),
        "ats_cu_inter_pos_flag": ("ats_cu_inter_pos_flag", 1),
        # Main BTT/SUCO tree syntax (xevem_eco.c:673,1787)
        "btt_split_flag": ("btt_split_flag", 15),
        "btt_split_dir": ("btt_split_dir", 5),
        "btt_split_type": ("btt_split_type", 1),
        "suco_flag": ("suco_flag", 14),
        "mode_cons": ("mode_cons", 3),
        # Main inter tool syntax (parse support; xevem_eco.c:1692,1878)
        "mvr_idx": ("mvr_idx", 4),
        "mmvd_flag": ("mmvd_flag", 1),
    }

    def __init__(self, slice_type=None, slice_qp=0, cm_init=0):
        for field, (tbl, n) in self._SPEC.items():
            if cm_init:
                setattr(self, field,
                        ctx_array_init(tbl, n, slice_type, slice_qp))
            else:
                setattr(self, field, ctx_array(n))
        self.cm_init = cm_init


def model_update(model: int, bin_is_mps: bool) -> int:
    state = model >> 1
    mps = model & 1
    if bin_is_mps:
        state = state - ((state + 16) >> 5)
    else:
        state = state + ((512 - state + 16) >> 5)
        if state > 256:
            mps = 1 - mps
            state = 512 - state
    return (state << 1) | mps


class SbacEncoder:
    """Bit-exact EVC SBAC encoder writing into a byte buffer."""

    def __init__(self):
        self.reset()
        self.out = bytearray()

    def reset(self):
        self.range = 16384
        self.code = 0
        self.code_bits = 11
        self.pending_byte = 0
        self.is_pending_byte = False
        self.stacked_ff = 0
        self.stacked_zero = 0
        self.bin_counter = 0

    # -- byte pipeline ------------------------------------------------------
    def _put_byte(self, b: int):
        if self.is_pending_byte:
            if self.pending_byte == 0:
                self.stacked_zero += 1
            else:
                self.out.extend(b"\x00" * self.stacked_zero)
                self.stacked_zero = 0
                self.out.append(self.pending_byte)
        self.pending_byte = b
        self.is_pending_byte = True

    def _carry_propagate(self):
        out_bits = self.code >> 17
        self.code &= (1 << 17) - 1
        if out_bits < 0xFF:
            while self.stacked_ff:
                self._put_byte(0xFF)
                self.stacked_ff -= 1
            self._put_byte(out_bits)
        elif out_bits > 0xFF:
            self.pending_byte += 1
            while self.stacked_ff:
                self._put_byte(0x00)
                self.stacked_ff -= 1
            self._put_byte(out_bits & 0xFF)
        else:
            self.stacked_ff += 1

    # -- bin coding ---------------------------------------------------------
    def encode_bin(self, bin_val: int, models: list[int], idx: int):
        self.bin_counter += 1
        model = models[idx]
        state = model >> 1
        mps = model & 1
        lps = (state * self.range) >> 9
        if lps < 437:
            lps = 437
        self.range -= lps
        if bin_val != mps:
            if self.range >= lps:
                self.code += self.range
                self.range = lps
            models[idx] = model_update(model, False)
        else:
            models[idx] = model_update(model, True)
        while self.range < 8192:
            self.range <<= 1
            self.code <<= 1
            self.code_bits -= 1
            if self.code_bits == 0:
                self._carry_propagate()
                self.code_bits = 8

    def encode_bin_ep(self, bin_val: int):
        self.bin_counter += 1
        self.range >>= 1
        if bin_val:
            self.code += self.range
        self.range <<= 1
        self.code <<= 1
        self.code_bits -= 1
        if self.code_bits == 0:
            self._carry_propagate()
            self.code_bits = 8

    def encode_bins_ep(self, value: int, n: int):
        for b in range(n - 1, -1, -1):
            self.encode_bin_ep((value >> b) & 1)

    def encode_bin_trm(self, bin_val: int):
        self.bin_counter += 1
        self.range -= 1
        if bin_val:
            self.code += self.range
            self.range = 1
        while self.range < 8192:
            self.range <<= 1
            self.code <<= 1
            self.code_bits -= 1
            if self.code_bits == 0:
                self._carry_propagate()
                self.code_bits = 8

    # -- composite symbols --------------------------------------------------
    def write_unary_sym(self, sym: int, models: list[int], base: int, num_ctx: int):
        ctx_idx = 0
        self.encode_bin(1 if sym else 0, models, base)
        if sym == 0:
            return
        while sym:
            sym -= 1
            if ctx_idx < num_ctx - 1:
                ctx_idx += 1
            self.encode_bin(1 if sym else 0, models, base + ctx_idx)

    def write_truncate_unary_sym(self, sym: int, models: list[int], base: int,
                                 num_ctx: int, max_num: int):
        if max_num > 1:
            for ctx_idx in range(max_num - 1):
                symbol = 0 if ctx_idx == sym else 1
                self.encode_bin(symbol, models,
                                base + min(ctx_idx, max_num - 1, num_ctx - 1))
                if symbol == 0:
                    break

    # -- termination --------------------------------------------------------
    def finish(self) -> bytes:
        """xeve_sbac_finish (xeve_eco.c:622): returns the terminated byte
        string (to be appended to the raw bitstream, byte-aligned)."""
        tmp = (self.code + self.range - 1) & (0xFFFFFFFF << 14)
        if tmp < self.code:
            tmp += 8192
        self.code = (tmp << self.code_bits) & 0xFFFFFFFF
        self._carry_propagate()
        self.code = (self.code << 8) & 0xFFFFFFFF
        self._carry_propagate()
        # flush pipeline
        self.out.extend(b"\x00" * self.stacked_zero)
        self.stacked_zero = 0
        if self.pending_byte != 0:
            self.out.append(self.pending_byte)
        else:
            if self.code_bits < 4:
                # reference pads (4 - code_bits) zero bits then aligns; all
                # padding is zero so the byte contribution is a single 0x00
                # only when bits were actually pending.  Here the pending
                # byte is zero and is dropped entirely; padding bits would
                # start a new zero byte which the reference also drops (it
                # writes into the bit-writer, all-zero => trailing zeros of
                # the NAL are significant!).  We emit the zero byte to match
                # the bit-writer's deinit flush.
                self.out.append(0)
        data = bytes(self.out)
        self.out = bytearray()
        return data


class SbacDecoder:
    """Inverse of SbacEncoder. `data` is the terminated SBAC byte string."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte_pos = pos
        self.bit_pos = 0
        self.range = 16384
        self.value = 0
        self.trace_hook = None   # optional per-bin trace (TRACE_BIN parity)
        for _ in range(14):
            self.value = (self.value << 1) | self._read_bit()

    def _read_bit(self) -> int:
        if self.byte_pos < len(self.data):
            b = self.data[self.byte_pos]
            bit = (b >> (7 - self.bit_pos)) & 1
        else:
            bit = 0
        self.bit_pos += 1
        if self.bit_pos == 8:
            self.bit_pos = 0
            self.byte_pos += 1
        return bit

    def decode_bin(self, models: list[int], idx: int) -> int:
        model = models[idx]
        state = model >> 1
        mps = model & 1
        lps = (state * self.range) >> 9
        if lps < 437:
            lps = 437
        self.range -= lps
        if self.trace_hook is not None:
            self.trace_hook(f"model {model} range {self.range} lps {lps} ")
        if self.value >= self.range:
            bin_val = 1 - mps
            self.value -= self.range
            self.range = lps
            models[idx] = model_update(model, False)
        else:
            bin_val = mps
            models[idx] = model_update(model, True)
        while self.range < 8192:
            self.range <<= 1
            self.value = (self.value << 1) | self._read_bit()
        return bin_val

    def decode_bin_ep(self) -> int:
        self.range >>= 1
        if self.value >= self.range:
            bin_val = 1
            self.value -= self.range
        else:
            bin_val = 0
        self.range <<= 1
        self.value = (self.value << 1) | self._read_bit()
        return bin_val

    def decode_bins_ep(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 1
        if self.value >= self.range:
            bin_val = 1
            self.range = 1
        else:
            bin_val = 0
        while self.range < 8192:
            self.range <<= 1
            self.value = (self.value << 1) | self._read_bit()
        return bin_val

    def read_unary_sym(self, models: list[int], base: int, num_ctx: int) -> int:
        sym = self.decode_bin(models, base)
        if sym == 0:
            return 0
        val = 0
        ctx_idx = 0
        while True:
            val += 1
            if ctx_idx < num_ctx - 1:
                ctx_idx += 1
            if self.decode_bin(models, base + ctx_idx) == 0:
                break
        return val

    def read_truncate_unary_sym(self, models: list[int], base: int,
                                num_ctx: int, max_num: int) -> int:
        if max_num <= 1:
            return 0
        for ctx_idx in range(max_num - 1):
            bin_val = self.decode_bin(models, base + min(ctx_idx, max_num - 1, num_ctx - 1))
            if bin_val == 0:
                return ctx_idx
        return max_num - 1
