"""Frame-level rate control: ABR (CBR-style) and CRF.

Model family follows the reference (src_base/xeve_rc.c): quantizer factor
qf = 0.85 * 2^((qp-21)/8.4) (qp_to_qf, xeve_rc.c:97), frame complexity
raised to pow 0.4, ABR qf = k * cpx^0.4 / target_bpf with k adapted from
real bits, CRF qf = cpx^0.4 / ratefactor, plus VBV buffer clipping
(get_vbv_qfactor, xeve_rc.c:351).

TPU-native redesign: instead of the reference's separate half-resolution
forecast pass (xeve_fcst.c), frame complexity comes from the batched
analysis stage itself (the 16x16-level SATD-like costs it already
computes), so rate control adds no extra device work.
"""
from __future__ import annotations

import numpy as np

from ..constants import SLICE_I, SLICE_P, SLICE_B

POW_CPLX = 0.4
INTRA_RATE_RATIO = 3.0   # I frames get ~3x the per-frame budget


def qp_to_qf(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 21.0) / 8.4)


def qf_to_qp(qf: float) -> float:
    return 21.0 + 4.2 * np.log(qf / 0.85) * 2.88538


def scene_proxy(y: np.ndarray, prev_y: np.ndarray | None) -> float:
    """Cheap per-frame complexity proxy for the lookahead window and
    scene-cut detection: mean-pooled 8x abs temporal difference (or
    pooled AC energy for the first frame).  ~100x cheaper than
    frame_complexity; used only for RATIOS so the scale is free."""
    a = y[: y.shape[0] // 8 * 8, : y.shape[1] // 8 * 8].astype(np.float32)
    a = a.reshape(a.shape[0] // 8, 8, a.shape[1] // 8, 8).mean(axis=(1, 3))
    if prev_y is None:
        return float(np.abs(a - a.mean()).mean()) + 1.0
    b = prev_y[: prev_y.shape[0] // 8 * 8,
               : prev_y.shape[1] // 8 * 8].astype(np.float32)
    b = b.reshape(b.shape[0] // 8, 8, b.shape[1] // 8, 8).mean(axis=(1, 3))
    return float(np.abs(a - b).mean()) + 1.0


def frame_complexity(y: np.ndarray, prev_y: np.ndarray | None) -> float:
    """Cheap SATD-ish complexity: 8x8 Hadamard-energy of the frame (intra)
    or of the temporal difference (inter)."""
    src = y.astype(np.float32)
    if prev_y is not None:
        src = src - prev_y.astype(np.float32)
        # remove DC per 8x8 block to approximate prediction
    h, w = src.shape
    hb, wb = h // 8, w // 8
    blocks = src[:hb * 8, :wb * 8].reshape(hb, 8, wb, 8)
    dc = blocks.mean(axis=(1, 3), keepdims=True)
    return float(np.abs(blocks - dc).sum()) + 1.0


class RateControl:
    """rc_type: 'abr' (bitrate target) or 'crf' (quality target)."""

    def __init__(self, rc_type: str, w: int, h: int, fps: float,
                 bitrate_kbps: float = 0.0, crf: int = 32,
                 qp_min: int = 0, qp_max: int = 51,
                 vbv_msec: int = 2000):
        self.rc_type = rc_type
        self.fps = fps
        self.bitrate = bitrate_kbps * 1000.0
        self.crf = crf
        self.qp_min, self.qp_max = qp_min, qp_max
        self.bpf = self.bitrate / fps if fps > 0 else 0.0
        self.target_bits = 0.0          # accumulated budget minus spend
        self.cpx_sum = 0.0
        self.cpx_cnt = 0.0
        self.df_cplx = 0.5
        # adaptive-k state per slice type (I/P/B spend very different
        # bits per complexity; one shared k rings on type transitions)
        self.k_param = {}
        self.k_cnt = {}
        self.last_qp_t = {}
        self.base_cplx = None
        self.vbv_size = self.bitrate * vbv_msec / 1000.0
        self.vbv_fullness = 0.0
        self.frames = 0
        self.spent = 0.0

    # ------------------------------------------------------------------
    def pick_qp(self, slice_type: int, slice_depth: int, cpx: float,
                fcst_ratio: float | None = None) -> int:
        """fcst_ratio: current/window mean complexity ratio (in ^0.4
        domain) over the frames already sitting in the dispatch-ahead
        pipeline (lookahead-lite, xeve_fcst.c / get_vbv_qfactor_fcst
        analog): the per-frame target is allocated proportionally to
        complexity within the visible window instead of flat, so an
        upcoming complexity jump tightens the current frame BEFORE the
        spend lands in the buffer.  Computed by the caller in a single
        proxy domain (the device rc_cost and the host proxy use
        different scales)."""
        if self.base_cplx is None:
            self.base_cplx = max(cpx, 1.0)
        # floor: a perfectly-predicted frame (post-cut static content)
        # otherwise drives cpx -> 0 and the adaptive k explodes
        cpx = max(cpx, 1e-2 * self.base_cplx)
        self.cpx_sum = self.cpx_sum * self.df_cplx + cpx
        self.cpx_cnt = self.cpx_cnt * self.df_cplx + 1.0
        cpx_avg = self.cpx_sum / self.cpx_cnt
        cpx_pow = cpx_avg ** POW_CPLX

        if self.rc_type == "crf":
            rf = self.crf + (1.0 if slice_depth <= 1 else 1.1 * (slice_depth + 2.0))
            ratefactor = (self.base_cplx ** POW_CPLX) / qp_to_qf(rf - 3.0)
            qf = cpx_pow / ratefactor
        else:
            target = self.bpf
            if fcst_ratio is not None:
                # window-proportional allocation (damped sqrt so the
                # open-loop proxy noise does not whip the target around)
                target *= float(np.clip(np.sqrt(fcst_ratio), 0.6, 1.6))
            if slice_type == SLICE_I:
                target *= INTRA_RATE_RATIO
            elif slice_type == SLICE_B and slice_depth > 2:
                target *= 0.5
            self.target_bits += self.bpf
            if not self.k_cnt.get(slice_type):
                # bootstrap: bits ~ cpx^0.4 / qf * k, assume k from first qp
                qf = qp_to_qf(self.last_qp_t.get(slice_type, 34.0))
                self.k_param[slice_type] = qf * target / max(cpx_pow, 1e-6)
            else:
                qf = self.k_param[slice_type] * cpx_pow / max(target, 1.0)
            # budget feedback: cumulative spend vs cumulative budget with
            # sub-linear gain (x264-style overflow compensation) — strong
            # enough to pull the model back when the complexity
            # distribution shifts under it
            if self.bpf > 0 and self.frames > 0:
                ratio = self.spent / max(self.bpf * self.frames, 1.0)
                qf *= float(np.clip(ratio ** 0.7, 0.5, 2.0))
            qf = self._vbv_clip(qf, target)

        qp = float(np.clip(qf_to_qp(qf), self.qp_min, self.qp_max))
        # rate-of-change clamp per slice type (xeve keeps frame qps within
        # a few steps of the previous same-type frame)
        prev = self.last_qp_t.get(slice_type)
        if prev is not None and self.rc_type == "abr":
            qp = float(np.clip(qp, prev - 5.0, prev + 5.0))
        self.last_qp_t[slice_type] = qp
        return int(np.clip(round(qp), self.qp_min, self.qp_max))

    def _vbv_clip(self, qf: float, target: float) -> float:
        if self.vbv_size <= 0:
            return qf
        # pre-clip: if landing this frame's target would push the buffer
        # past 90%, tighten proportionally BEFORE the overshoot
        # (get_vbv_qfactor_fcst analog, xeve_rc.c:598)
        projected = self.vbv_fullness + target - self.bpf
        if projected > 0.9 * self.vbv_size:
            qf *= max(1.0, projected / (0.9 * self.vbv_size))
        if self.vbv_fullness > self.vbv_size:
            qf *= self.vbv_fullness / self.vbv_size
        return qf

    # ------------------------------------------------------------------
    def update(self, slice_type: int, qp: int, bits: int, cpx: float):
        self.frames += 1
        qf = qp_to_qf(qp)
        if self.rc_type == "abr":
            self.target_bits -= bits
            self.spent += bits
            if self.base_cplx:
                cpx = max(cpx, 1e-2 * self.base_cplx)
            k_obs = qf * bits / max(cpx ** POW_CPLX, 1e-6)
            cnt = self.k_cnt.get(slice_type, 0.0)
            w = min(1.0, 3.0 / max(cnt, 1.0))
            if cnt == 0:
                self.k_param[slice_type] = k_obs
            else:
                # clamp each observation: one outlier frame (scene cut,
                # near-zero complexity) must not blow up the model
                k_prev = self.k_param[slice_type]
                k_obs = float(np.clip(k_obs, 0.2 * k_prev, 5.0 * k_prev))
                self.k_param[slice_type] = (1 - w) * k_prev + w * k_obs
            self.k_cnt[slice_type] = cnt + 1
            if self.vbv_size > 0:
                self.vbv_fullness += bits - self.bpf
                self.vbv_fullness = float(np.clip(self.vbv_fullness, 0,
                                                  self.vbv_size * 1.5))
