"""DRA — Dynamic Range Adjustment (Main profile, APS-signalled).

Exact integer port of the reference's DRA control path
(`/root/reference/src_main/xevem_dra.c`):

  - APS payload syntax (xevem_eco.c:2135 eco_dra_aps_param) — parse+write
  - signalled-params -> inverse mapping construction
    (xeve_dra_ready: construct_dra_ready :772, chroma shift compensation
    :276 with the log/exp tables from xevem_tbl.c:727, LUT builders
    :289/:300)
  - forward LUTs from the *decoded* params (build_fwd_dra_lut_from_dec
    :629 via the fixed-point QUANT_PARAM_DRA helpers :39-170), so the
    encoder maps its input with exactly the tables a decoder derives
  - sample application (apply_dra_luma/chroma_plane :871/:901): the
    forward map is applied to encoder INPUT pictures (fn_pic_flt,
    xeve_enc.c:656) and the backward map to OUTPUT pictures only — the
    DPB stays in the mapped domain
  - encoder-side parameter derivation from the config scale map
    (xeve_init_dra :684 + update_dra :815 + quantize/set_signalled)

Scope note: 4:2:0 only, like the rest of the framework.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import chroma_qp_dynamic

DRA_SCALE_NUMFBITS = 9
DRA_INVSCALE_NUMFBITS = 9
DRA_OFFSET_NUMFBITS = 7
DRA_LUT_MAXSIZE = 1024
NUM_MULT_BITS = DRA_SCALE_NUMFBITS + DRA_INVSCALE_NUMFBITS

# xevem_tbl.c:727 — log approximation at 1<<9 accuracy
CHROMA_QP_OFFSET_TBL = [
    0, 1, 1, 1, 1, 1, 2, 2, 3, 4, 4, 6, 7, 9, 11, 14, 18, 23, 29, 36, 45,
    57, 72, 91, 114, 144, 181, 228, 287, 362, 456, 575, 724, 912, 1149,
    1448, 1825, 2299, 2896, 3649, 4598, 5793, 7298, 9195, 11585, 14596,
    18390, 23170, 29193, 36781, 46341, 58386, 73562, 92682, 116772]
# xevem_tbl.c:735 — exp approximation at 1<<9 accuracy
EXP_NOM_V2 = [
    128, 144, 161, 181, 203, 228, 256, 287, 322, 362, 406, 456, 512, 574,
    645, 724, 812, 912, 1024, 1149, 1290, 1448, 1625, 1825, 2048]


@dataclass
class SigParamDRA:
    """The APS payload (SIG_PARAM_DRA)."""
    dra_descriptor1: int = 4
    dra_descriptor2: int = DRA_SCALE_NUMFBITS
    num_ranges: int = 0
    equal_ranges_flag: int = 0
    delta_val: int = 0
    in_ranges: list = field(default_factory=list)     # num_ranges+1 points
    dra_scale_value: list = field(default_factory=list)
    dra_cb_scale_value: int = 0
    dra_cr_scale_value: int = 0
    dra_table_idx: int = 0

    def write(self, bw, bit_depth: int):
        """xevem_eco_dra_aps_param (xevem_eco.c:2135)."""
        bw.write(self.dra_descriptor1, 4)
        bw.write(self.dra_descriptor2, 4)
        bw.write_ue(self.num_ranges - 1)
        bw.write1(self.equal_ranges_flag)
        bw.write(self.in_ranges[0], bit_depth)
        if self.equal_ranges_flag:
            bw.write(self.delta_val, bit_depth)
        else:
            for i in range(1, self.num_ranges + 1):
                bw.write(self.in_ranges[i] - self.in_ranges[i - 1],
                         bit_depth)
        nbits = self.dra_descriptor1 + self.dra_descriptor2
        for i in range(self.num_ranges):
            bw.write(self.dra_scale_value[i], nbits)
        bw.write(self.dra_cb_scale_value, nbits)
        bw.write(self.dra_cr_scale_value, nbits)
        bw.write_ue(self.dra_table_idx)

    @classmethod
    def parse(cls, br, bit_depth: int) -> "SigParamDRA":
        s = cls()
        s.dra_descriptor1 = br.read(4)
        s.dra_descriptor2 = br.read(4)
        s.num_ranges = br.read_ue() + 1
        s.equal_ranges_flag = br.read1()
        in0 = br.read(bit_depth)
        if s.equal_ranges_flag:
            s.delta_val = br.read(bit_depth)
            # in_ranges from the equal spacing (decoder reconstruction:
            # deltaVal = floor((1024 - in0)/num + 0.5) + signalled delta)
            # the written delta_val is (implied spacing - actual spacing)
            step = int(math.floor((1024 - in0) / s.num_ranges + 0.5)) \
                - s.delta_val
            s.in_ranges = [in0 + i * step for i in range(s.num_ranges + 1)]
        else:
            s.in_ranges = [in0]
            for _ in range(s.num_ranges):
                s.in_ranges.append(s.in_ranges[-1] + br.read(bit_depth))
        nbits = s.dra_descriptor1 + s.dra_descriptor2
        s.dra_scale_value = [br.read(nbits) for _ in range(s.num_ranges)]
        s.dra_cb_scale_value = br.read(nbits)
        s.dra_cr_scale_value = br.read(nbits)
        s.dra_table_idx = br.read_ue()
        return s


# ---------------------------------------------------------------------------
# fixed-point QUANT_PARAM_DRA helpers (xevem_dra.c:39-170)
# ---------------------------------------------------------------------------


class _Q:
    __slots__ = ("value", "frac", "tot")

    def __init__(self, value=0, frac=0, tot=1):
        self.value, self.frac, self.tot = value, frac, tot


def _q_i(value: int, int_bits: int) -> _Q:
    temp = int(math.floor(value + 0.5))
    q = _Q(temp, 0, 1)
    if temp != 0:
        est = math.ceil(math.log(abs(temp)) / math.log(2.0))
        q.tot = min(int(est), int_bits)
    return q


def _q_d(value: float, frac_bits: int, int_bits: int) -> _Q:
    temp = int(math.floor(value * (1 << frac_bits) + 0.5))
    q = _Q(temp, frac_bits, 1)
    if temp == 0:
        q.frac = 0
        q.tot = 1
    else:
        est = math.ceil(math.log(abs(temp)) / math.log(2.0))
        q.tot = min(int(est), int_bits + frac_bits)
    return q


def _lshift(q: _Q, v: int):
    q.value <<= v
    q.frac += v
    q.tot += v


def _rshift(q: _Q, v: int):
    q.value = (q.value + (1 << (v - 1))) >> v
    q.frac -= v


def _plus(a: _Q, b: _Q) -> _Q:
    ta, tb = _Q(a.value, a.frac, a.tot), _Q(b.value, b.frac, b.tot)
    out = _Q()
    if ta.frac != tb.frac:
        f = max(ta.frac, tb.frac)
        _lshift(ta, f - ta.frac)
        _lshift(tb, f - tb.frac)
        out.frac = f
    else:
        out.frac = b.frac
    out.value = ta.value + tb.value
    out.tot = max(ta.tot, b.tot) + 1
    return out


def _minus(a: _Q, b: _Q) -> _Q:
    ta, tb = _Q(a.value, a.frac, a.tot), _Q(b.value, b.frac, b.tot)
    out = _Q()
    if ta.frac != tb.frac:
        f = max(ta.frac, tb.frac)
        _lshift(ta, f - a.frac)
        _lshift(tb, f - tb.frac)
        out.frac = f
    else:
        out.frac = b.frac
    out.value = ta.value - tb.value
    out.tot = max(ta.tot, b.tot) + 1
    return out


def _mult(a: _Q, b: _Q) -> _Q:
    out = _Q(a.value * b.value)
    if out.value == 0:
        out.tot, out.frac = 1, 0
    else:
        out.tot = a.tot + b.tot
        out.frac = a.frac + b.frac
    return out


def _divide(a: _Q, b: _Q) -> _Q:
    # C integer division truncates toward zero
    num = a.value + (b.value // 2 if b.value >= 0 else -((-b.value) // 2))
    v = abs(num) // abs(b.value)
    if (num < 0) != (b.value < 0) and v != 0:
        v = -v
    out = _Q(int(v))
    if out.value == 0:
        out.tot, out.frac = 1, 0
    else:
        out.tot = a.tot - b.tot
        out.frac = a.frac - b.frac
    return out


def _set_frac(q: _Q, nbits: int):
    if q.frac < nbits:
        _lshift(q, nbits - q.frac)
    elif q.frac > nbits:
        _rshift(q, q.frac - nbits)
    if q.value == 0:
        q.tot = 0
    else:
        q.tot = int(math.ceil(math.log(abs(q.value)) / math.log(2.0)))


def _get_val(q: _Q) -> float:
    return float(q.value) / (1 << q.frac)


# ---------------------------------------------------------------------------
# mapping construction (decode side: xeve_dra_ready)
# ---------------------------------------------------------------------------


def _range_idx(sample, ranges, num):
    for i in range(num):
        if sample < ranges[i + 1]:
            return min(i, num - 1)
    return num - 1


def _scaled_chroma_qp(comp_id, qp, bit_depth, iqt=1):
    qp_bd_off = 6 * (bit_depth - 8)
    v = max(-qp_bd_off, min(57, qp))
    return chroma_qp_dynamic(v, iqt)


def _correct_local_chroma_scale(sig, scale_luma, ch_id, bit_depth):
    """xeve_correct_local_chroma_scale (xevem_dra.c:194)."""
    scale_offset = 1 << DRA_SCALE_NUMFBITS
    table0_shift = 25 >> 1
    if sig.dra_table_idx == 58:
        return sig.dra_cb_scale_value if ch_id == 1 \
            else sig.dra_cr_scale_value
    cscale = sig.dra_cb_scale_value if ch_id == 1 else sig.dra_cr_scale_value
    scale_dra_int = cscale * scale_luma
    local_shift1 = sig.dra_table_idx - _scaled_chroma_qp(
        ch_id, sig.dra_table_idx, bit_depth)
    scale_dra_int9 = (scale_dra_int + (1 << 8)) >> 9
    idx = _range_idx(scale_dra_int9, CHROMA_QP_OFFSET_TBL,
                     len(CHROMA_QP_OFFSET_TBL) - 1)
    interp_num = scale_dra_int9 - CHROMA_QP_OFFSET_TBL[idx]
    interp_den = CHROMA_QP_OFFSET_TBL[idx + 1] - CHROMA_QP_OFFSET_TBL[idx]
    qp_dra_int = 2 * idx - 60
    if interp_num == 0:
        qp_dra_int -= 1
        qp_dra_frac = 0
    else:
        qp_dra_frac = scale_offset * (interp_num << 1) // interp_den
        qp_dra_int += qp_dra_frac // scale_offset
        qp_dra_frac = scale_offset - (qp_dra_frac % scale_offset)
    local_qp = sig.dra_table_idx - qp_dra_int
    lo = -(6 * (bit_depth - 8))
    qp0 = _scaled_chroma_qp(ch_id, max(lo, min(57, local_qp)), bit_depth)
    qp1 = _scaled_chroma_qp(ch_id, max(lo, min(57, local_qp + 1)), bit_depth)
    qp_ch_dec = (qp1 - qp0) * qp_dra_frac
    qp_dra_frac_adj = qp_ch_dec % (1 << 9)
    qp_dra_int_adj = qp_ch_dec >> 9
    qp_dra_frac_adj = qp_dra_frac - qp_dra_frac_adj
    local_shift2 = local_qp - qp0 - qp_dra_int_adj
    shift = local_shift2 - local_shift1
    if qp_dra_frac_adj < 0:
        shift -= 1
        qp_dra_frac_adj += 1 << 9
    clipped = max(-12, min(12, shift))
    scale_shift = EXP_NOM_V2[clipped + table0_shift]
    if shift >= 0:
        frac = EXP_NOM_V2[max(-12, min(12, shift + 1)) + table0_shift] \
            - scale_shift
    else:
        frac = scale_shift \
            - EXP_NOM_V2[max(-12, min(12, shift - 1)) + table0_shift]
    out_scale = scale_shift + (
        (frac * qp_dra_frac_adj + (1 << (DRA_SCALE_NUMFBITS - 1)))
        >> DRA_SCALE_NUMFBITS)
    return (scale_dra_int * out_scale + (1 << 17)) >> 18


@dataclass
class DraMaps:
    luma_inv_lut: np.ndarray = None       # backward luma
    chroma_inv_lut: np.ndarray = None     # (2, 1024) backward chroma
    luma_fwd_lut: np.ndarray = None       # forward luma
    chroma_fwd_lut: np.ndarray = None     # (2, 1024) forward chroma


def build_dra_maps(sig: SigParamDRA, bit_depth: int = 10,
                   want_fwd: bool = True) -> DraMaps:
    """xeve_dra_ready + build_fwd_dra_lut_from_dec, from signalled
    params only (what a decoder can derive)."""
    nr = sig.num_ranges
    frac2 = sig.dra_descriptor2
    in_ranges = list(sig.in_ranges)
    scales = list(sig.dra_scale_value)
    deltas = [in_ranges[i + 1] - in_ranges[i] for i in range(nr)]

    # construct_dra_ready (xevem_dra.c:772)
    out_s32 = [0] * (nr + 1)
    for i in range(1, nr + 1):
        out_s32[i] = out_s32[i - 1] + deltas[i - 1] * scales[i - 1]
    inv_scales = [0] * nr
    inv_offsets = [0] * nr
    for i in range(nr):
        nomin = 1 << NUM_MULT_BITS
        inv2 = (nomin + (scales[i] >> 1)) // scales[i]
        diff2 = out_s32[i + 1] * inv2
        inv_offsets[i] = ((in_ranges[i + 1] << NUM_MULT_BITS) - diff2
                          + (1 << (frac2 - 1))) >> frac2
        inv_scales[i] = inv2
    out_ranges = [(v + (1 << (frac2 - 1))) >> frac2 for v in out_s32]

    # chroma shift compensation (:276)
    ch_scales = [[0] * nr, [0] * nr]
    ch_inv = [[0] * nr, [0] * nr]
    for i in range(nr):
        for ch in range(2):
            cs = _correct_local_chroma_scale(sig, scales[i], ch + 1,
                                             bit_depth)
            ch_scales[ch][i] = cs
            ch_inv[ch][i] = ((1 << 18) + (cs >> 1)) // cs

    maps = DraMaps()
    # luma inverse LUT (:289)
    lut = np.empty(DRA_LUT_MAXSIZE, np.int32)
    for i in range(DRA_LUT_MAXSIZE):
        ri = _range_idx(i, out_ranges, nr)
        v = i * inv_scales[ri]
        v = (inv_offsets[ri] + v + (1 << 8)) >> 9
        lut[i] = max(0, min(DRA_LUT_MAXSIZE - 1, v))
    maps.luma_inv_lut = lut

    # chroma inverse LUT (:300)
    cinv = np.ones((2, DRA_LUT_MAXSIZE), np.int64)
    for ch in range(2):
        mr2 = [0] * (nr + 2)
        mscale = [0] * (nr + 1)
        moffset = [0] * (nr + 1)
        mr2[0] = out_ranges[0]
        moffset[0] = ch_inv[ch][0]
        for i in range(1, nr + 1):
            mr2[i] = (out_ranges[i - 1] + out_ranges[i]) // 2
        for i in range(1, nr):
            delta_range = mr2[i + 1] - mr2[i]
            moffset[i] = ch_inv[ch][i - 1]
            delta_scale = ch_inv[ch][i] - moffset[i]
            num = (delta_scale << bit_depth) + (delta_range >> 1)
            # C integer division truncates toward zero
            mscale[i] = (abs(num) // delta_range) * (1 if num >= 0 else -1)
        mscale[nr] = 0
        moffset[nr] = ch_inv[ch][nr - 1]
        for i in range(DRA_LUT_MAXSIZE):
            ri = _range_idx(i, mr2, nr + 1)
            run_i = i - mr2[ri]
            run_s = (mscale[ri] * run_i + (1 << (bit_depth - 1))) \
                >> bit_depth
            cinv[ch][i] = moffset[ri] + run_s
    maps.chroma_inv_lut = cinv

    if not want_fwd:
        return maps

    # forward (encode-direction) LUTs from the decoded params (:586/:629)
    dra_scales_f = [s / float(1 << frac2) for s in scales]
    outq = [_q_i(0, 1)]
    for i in range(1, nr + 1):
        t1 = _q_d(dra_scales_f[i - 1], DRA_SCALE_NUMFBITS, 10)
        t2 = _q_i(deltas[i - 1], bit_depth + 1)
        outq.append(_plus(outq[i - 1], _mult(t1, t2)))
    dra_offsets = []
    for i in range(nr):
        t1 = _q_d(1, NUM_MULT_BITS, 11)
        t2 = _q_d(dra_scales_f[i], DRA_SCALE_NUMFBITS, 10)
        accum = _divide(t1, t2)
        t3 = _mult(outq[i + 1], accum)
        t1 = _q_d(in_ranges[i + 1], 0, bit_depth)
        off = _minus(t1, t3)
        _set_frac(off, DRA_OFFSET_NUMFBITS)
        dra_offsets.append(off)
    offs_f = [_get_val(o) for o in dra_offsets]

    flut = np.empty(DRA_LUT_MAXSIZE, np.int32)
    mx = DRA_LUT_MAXSIZE - 1
    for i in range(nr):
        x, y = in_ranges[i], in_ranges[i + 1]
        for j in range(x, y):
            t1 = _q_i(j, bit_depth)
            t2 = _q_d(offs_f[i], DRA_OFFSET_NUMFBITS, 15)
            t3 = _q_d(dra_scales_f[i], DRA_SCALE_NUMFBITS, 10)
            v = _mult(_minus(t1, t2), t3)
            _set_frac(v, 0)
            flut[j] = min(int(_get_val(v)), mx)
    for j in range(in_ranges[nr], DRA_LUT_MAXSIZE):
        t1 = _q_i(j, bit_depth)
        t2 = _q_d(offs_f[nr - 1], DRA_OFFSET_NUMFBITS, 15)
        t3 = _q_d(dra_scales_f[nr - 1], DRA_SCALE_NUMFBITS, 10)
        v = _mult(_minus(t1, t2), t3)
        _set_frac(v, 0)
        flut[j] = min(int(_get_val(v)), mx)
    # below the first change point the reference leaves the forward LUT
    # at 0 (memset in build_fwd_dra_lut_from_dec) — mirror that
    flut[:in_ranges[0]] = 0
    maps.luma_fwd_lut = flut

    cfwd = np.ones((2, DRA_LUT_MAXSIZE), np.int64)
    for ch in range(2):
        for i in range(DRA_LUT_MAXSIZE):
            v1 = 1 << NUM_MULT_BITS
            v3 = int(cinv[ch][flut[i]])
            cfwd[ch][i] = (v1 + v3 // 2) // v3
    maps.chroma_fwd_lut = cfwd
    return maps


# ---------------------------------------------------------------------------
# sample application (xevem_dra.c:871/:901)
# ---------------------------------------------------------------------------


def apply_dra(y, u, v, maps: DraMaps, backward: bool):
    """Returns mapped (y, u, v).  Luma through the LUT; chroma scaled
    around 512 by the luma-indexed (co-sited, <<1) chroma scale."""
    y = np.asarray(y)
    u = np.asarray(u)
    v = np.asarray(v)
    ylut = maps.luma_inv_lut if backward else maps.luma_fwd_lut
    clut = maps.chroma_inv_lut if backward else maps.chroma_fwd_lut
    yc = np.clip(y, 0, DRA_LUT_MAXSIZE - 1).astype(np.int64)
    # NOTE: chroma uses the PRE-map luma as its scale index
    ref = yc[::2, ::2]
    out_y = ylut[yc].astype(y.dtype)
    rnd = 1 << (DRA_INVSCALE_NUMFBITS - 1)
    out_c = []
    for ch, plane in enumerate((u, v)):
        sv = plane.astype(np.int64) - 512
        scale = clut[ch][ref]
        mag = (np.abs(sv) * scale + rnd) >> DRA_INVSCALE_NUMFBITS
        out = 512 + np.where(sv < 0, -mag, mag)
        out_c.append(out.astype(plane.dtype))
    return out_y, out_c[0], out_c[1]


# ---------------------------------------------------------------------------
# encoder-side parameter derivation (xeve_init_dra + update_dra)
# ---------------------------------------------------------------------------


def derive_sig_params(qp: int, qp_cb_offset: int = 0, qp_cr_offset: int = 0,
                      num_ranges: int = 8,
                      in_points=None, scales=None,
                      hist_norm: float = 1.0,
                      chroma_qp_scale: float = 1.0,
                      chroma_qp_offset: float = 0.0,
                      cb_qp_scale: float = 1.0, cr_qp_scale: float = 1.0,
                      bit_depth: int = 10) -> SigParamDRA:
    """The reference's config->signalled-params pipeline (parse_dra_param
    xevem_util.c:2985 + analyze_input_pic/update_dra xevem_dra.c:815)."""
    if in_points is None:
        in_points = [64 + i * (940 - 64) // num_ranges
                     for i in range(num_ranges)]
    if scales is None:
        scales = [1.0] * num_ranges
    desc1, desc2 = 4, DRA_SCALE_NUMFBITS

    def qp2scale(cq):
        return math.exp((cq / 6.0) * math.log(2.0))

    def chroma_scale(qps, dra_qp_off):
        cq = chroma_qp_scale * qp + chroma_qp_offset
        cq *= qps
        icq = int(cq + (-0.5 if cq < 0 else 0.5))
        icq = max(-12, min(12, min(0, icq) + dra_qp_off)) - dra_qp_off
        return 1.0 / qp2scale(icq)

    min_bin = 1.0 / (1 << desc2)

    def clamp_cscale(s):
        sign = -1 if s < 0 else 1
        if sign * s < min_bin:
            s = sign * min_bin
        if sign * s > 4 - min_bin:
            s = sign * (4 - min_bin)
        s = max(0, min(1 << desc1, s))
        return int(s * (1 << desc2) + 0.5)

    cb_scale = clamp_cscale(chroma_scale(cb_qp_scale, qp_cb_offset))
    cr_scale = clamp_cscale(chroma_scale(cr_qp_scale, qp_cr_offset))

    in_r = list(in_points) + [1024]
    sc = [float(s) for s in scales]
    deltas = [in_r[i + 1] - in_r[i] for i in range(num_ranges)]
    out_r = [0.0] * (num_ranges + 1)
    for i in range(1, num_ranges + 1):
        out_r[i] = int(out_r[i - 1] + sc[i - 1] * deltas[i - 1] + 0.5)

    # construct_dra (fixed-pt) — normalize to unity net scale
    scale_norm = (out_r[num_ranges] - out_r[0]) / (in_r[num_ranges] - in_r[0])
    sc = [s / scale_norm for s in sc]

    # zoom_in_range (global_offset 64, global_end 940)
    g_off, g_end = 64, 940
    lum_renorm = DRA_LUT_MAXSIZE / float(
        DRA_LUT_MAXSIZE - (g_off + DRA_LUT_MAXSIZE - g_end))
    lum_renorm = min(lum_renorm, 1.7)
    deltas = [in_r[i + 1] - in_r[i] for i in range(num_ranges)]
    deltas = [int(d / lum_renorm + 0.5) for d in deltas]
    in_r[0] = g_off
    sc[0] *= lum_renorm
    for i in range(1, num_ranges):
        in_r[i] = in_r[i - 1] + deltas[i - 1]
        sc[i] *= lum_renorm
    in_r[num_ranges] = in_r[num_ranges - 1] + deltas[num_ranges - 1]

    # normalize_histogram
    scale_norm = int(100.0 * hist_norm + 0.5) / 100.0
    sc = [s / scale_norm for s in sc]

    # quantize
    sc_s32 = []
    for s in sc:
        s = max(0, min(1 << desc1, s))
        sc_s32.append(int(s * (1 << desc2) + 0.5))

    sig = SigParamDRA(
        dra_descriptor1=desc1, dra_descriptor2=desc2,
        num_ranges=num_ranges, in_ranges=in_r,
        dra_scale_value=sc_s32,
        dra_cb_scale_value=cb_scale >> (DRA_SCALE_NUMFBITS - desc2),
        dra_cr_scale_value=cr_scale >> (DRA_SCALE_NUMFBITS - desc2),
        dra_table_idx=qp)
    # equal_ranges check (xeve_check_equal_range_flag)
    equal = all(in_r[i + 1] - in_r[i] == in_r[1] - in_r[0]
                for i in range(1, num_ranges))
    if equal:
        sig.equal_ranges_flag = 1
        dv = int(math.floor((1024 - in_r[0]) / num_ranges + 0.5))
        sig.delta_val = dv - (in_r[1] - in_r[0])
    return sig
