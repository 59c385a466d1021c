"""Encoders whose analysis runs in PyTorch on an explicit device.

Encoder and GopEncoder are xeve_tpu.api's classes with one of two
analysis engines:

- analysis="device" (the engine bench.py measures): the fused per-frame
  analyzer, enc/device_analyzer.DeviceAnalyzer, behind the base's one
  entry point `_device()` (api.py:391).  The base's device-engine
  orchestration then runs unchanged: AI frame-parallel C passes,
  dispatch-ahead and closed-loop LD-P, the RA sub-GOP pipeline with the
  frame-parallel C pass, flush and prewarm.  `_device().dispatches`
  counts the frames it analysed.
- analysis="jax" (default): the JAX engine's per-frame analysis.  The
  base constructor runs with the numpy engine so that it sets no
  process-wide ME switch (api.py:70-75); every analysis route of the
  "jax" engine is then taken over here: P and B slices through
  `_analyze_inter` (api.py:705); I slices through `encode_frame`
  (api.py:514) and `_encode_ra_frame` (api.py:1557), which hand the base
  an `analysis_pre` computed at the qp the base will use, so the numpy
  fall-through (api.py:557, :1621) is never reached.  `analysis_calls`
  counts the frames this engine analysed.

The closed-loop C pass, HLS, DPB and RA ordering are the base's.
"""
from __future__ import annotations

from xeve_tpu import api as _base
from xeve_tpu.constants import SLICE_I
from xeve_tpu.params import EncoderParams

from .device import resolve_device
from .enc.analysis_inter_torch import analyze_frame_inter_torch
from .enc.analysis_torch import analyze_frame_torch
from .enc.device_analyzer import DeviceAnalyzer


class Encoder(_base.Encoder):
    """EVC Baseline encoder (AI / low-delay P) with torch analysis."""

    def __init__(self, params: EncoderParams, analysis: str = "jax",
                 coder: str = "native", device="cuda"):
        if analysis not in ("jax", "device"):
            raise ValueError(f"unknown analysis engine {analysis!r}")
        self.device = resolve_device(device)
        super().__init__(params,
                         analysis="device" if analysis == "device"
                         else "numpy",
                         coder=coder, me_engine="numpy")
        p = self.p
        if p.tool_eipd:
            raise NotImplementedError("Main-profile EIPD analysis is not "
                                      "ported to torch yet")
        if p.rc_type != "cq":
            raise NotImplementedError(f"rate control {p.rc_type!r} is not "
                                      "ported to torch yet")
        if p.tool_dra:
            raise NotImplementedError("DRA is not ported to torch yet")
        if analysis == "jax":
            self.analysis_engine = "torch"
        self.analysis_calls = 0

    def _device(self):
        if self._dev is None:
            p = self.p
            self._dev = DeviceAnalyzer(
                p.w_aligned, p.h_aligned, p.codec_bit_depth,
                search_range=p.search_range, min_log2=p.min_cu_log2,
                device=self.device)
        return self._dev

    def encode_frames(self, frames, batch: int = 4):
        raise NotImplementedError("batched all-intra analysis is not ported "
                                  "to torch yet; use encode_stream")

    def _analyze_intra(self, y, u, v, qp, **kw):
        qp_y, qp_u, qp_v = self._qp_triplet(qp)
        self.analysis_calls += 1
        return analyze_frame_torch(y, u, v, qp, qp_y, qp_u, qp_v,
                                   self.p.codec_bit_depth, device=self.device,
                                   **kw)

    def encode_frame(self, y, u, v, analysis_pre=None):
        if analysis_pre is None and self.analysis_engine == "torch" and \
                self._slice_type_for(self.pic_cnt) == SLICE_I:
            # the base pads again from the raw planes; RC is off, so its
            # qp is _slice_qp (api.py:532-535)
            analysis_pre = self._analyze_intra(
                *self._pad_input(y, u, v), self._slice_qp(SLICE_I),
                min_log2=self.p.min_cu_log2)
        return super().encode_frame(y, u, v, analysis_pre)

    def _analyze_inter(self, y, u, v, refp, qp, qp_y, qp_u, qp_v, bd,
                       refp1=None, search_range=16):
        self.analysis_calls += 1
        return analyze_frame_inter_torch(y, u, v, refp, qp, qp_y, qp_u, qp_v,
                                         bd, refp1=refp1,
                                         search_range=search_range,
                                         device=self.device)


class GopEncoder(Encoder, _base.GopEncoder):
    """RA GOP16 (bframes >= 15) or streaming I/P, with torch analysis."""

    def _encode_ra_frame(self, poc, tid, disp_idx, is_ref, slice_type,
                         analysis_pre=None, aq_map=None):
        if analysis_pre is None and self.analysis_engine == "torch" and \
                slice_type == SLICE_I:
            # same qp and default min_log2 as the base's "jax" I branch
            # (api.py:1575-1576, :1619)
            qp = self._ra_qp(0) if self.p.bframes >= 15 \
                else self._slice_qp(SLICE_I)
            analysis_pre = self._analyze_intra(*self._gop_in[disp_idx], qp)
        return super()._encode_ra_frame(poc, tid, disp_idx, is_ref,
                                        slice_type, analysis_pre=analysis_pre,
                                        aq_map=aq_map)

    def encode_stream_meshed(self, frames, mesh):
        raise NotImplementedError("the meshed sub-GOP analysis is not ported "
                                  "to torch yet")
