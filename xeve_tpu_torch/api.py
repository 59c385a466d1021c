"""Public encoder API of the PyTorch port: create/push/encode, mirroring the
reference C API surface (inc/xeve.h xeve_create/xeve_push/xeve_encode).

The port's copy of xeve_tpu/api.py, with its analysis in PyTorch on an
explicit device.  Three analysis engines:

- analysis="device" (the engine bench.py measures): the fused per-frame
  analyzer, enc/device_analyzer.DeviceAnalyzer, behind `_device()`.  AI
  runs frame-parallel C passes, LD-P dispatches ahead (or runs closed
  loop), RA pipelines each sub-GOP into the frame-DAG C pass, where
  sub-GOP k+1's frames code while sub-GOP k is still emitted (_FrameDag).
  `_device().dispatches` counts the frames it analysed, `ahead_tasks` the
  RA frames handed to a frame worker while an earlier sub-GOP still had
  frames to emit.
- analysis="jax" (default): the JAX engine's per-frame analysis in torch:
  I slices through enc/analysis_torch (Baseline) or the 33-mode EIPD
  analysis enc/analysis_main_torch (Main), P and B slices through
  enc/analysis_inter_torch, whose integer ME is the CUDA kernel
  csrc/me_full_search.cu on the card.
- analysis="numpy" (the JAX package's default engine): the exact-integer
  host oracles enc/analysis_np, enc/analysis_main_np and
  enc/analysis_inter_np.  It touches no torch device and runs only when a
  caller names it.  `analysis_calls` counts the frames the "jax" or
  "numpy" engine analysed.

Main profile (profile=1, the default toolset EIPD, CM_INIT, ADCC, IQT,
ATS, HTDF, ADDB, and BTT where `btt` is auto-on) runs on every engine:
its I slices take the EIPD analysis (Main AI streams on the "jax" and
"device" engines dispatch `ahead` frames of it), its P and B slices the
engine's inter analysis.

Coding passes: coder="native" (default), the C library native/xt_core.c;
coder="numpy", the numpy oracle (enc/frame_pass.FramePass for Baseline
slices, enc/main_intra_frame.MainIntraFramePass for Main I slices; Main
P and B slices stay on the C pass, as in the JAX package).

Rate control (rc_type "abr" or "crf", enc/rc.RateControl) picks each
frame's qp from the rate model: the device engine's packed `rc_cost` is
the complexity of a dispatched frame, the host `frame_complexity` that
of the others.  The device engine's AI/LD route keeps a lookahead window
of scene proxies that shapes the ABR target and inserts a keyframe at a
hard scene cut (`_force_idr`).  Under RC each frame's qp depends on the
bits of the frame before it, so RA sub-GOPs code serially and all-intra
frames do not code in parallel.

Encoder-side DRA (tool_dra): the forward map applies in `_pad_input`,
once per frame on every route, and the encoder works in the mapped
domain; the public entry points (`encode_frame`, `encode_stream`,
`push_frame`, `flush`) return backward-mapped reconstructions.  The JAX
package does this by replacing those methods on the instance
(`_wrap_dra_api`), and its dispatch-ahead `encode_stream` routes (Main
AI; the device engine's LD-P and serially coded AI) map a frame a second
time when they hand the padded frame back to `encode_frame`
(xeve_tpu/api.py:938 or :987, then :521).  The port has no instance
patching: each public entry point is a thin wrapper over a private
method that takes and returns mapped-domain frames
(`_encode_frame_mapped`, `_encode_stream`, `_push_frame`, `_flush`), and
the dispatch-ahead routes hand the frame they already padded to
`_encode_frame_mapped`, which maps nothing.  Its `encode_stream` streams
therefore equal the JAX package's single-map `encode_frame` loop
(tests/test_torch_dra.py).

Checkpoint/resume: state.save_state/load_state (a copy of the JAX
package's) resume an encode bit-exactly at any frame boundary.  The
checkpoint does not carry the device analyzer's frame ring: a resumed
device-engine encode whose next dispatch needs a frame from before the
cut raises KeyError, as the JAX package's does.

The CLIs are app.py (`python -m xeve_tpu_torch.app`, the twin of
xeve_tpu_app.py with --device) and dec_app.py.

`me_engine` routes the numpy engine's integer ME (and the device
analyzer's host fallback) to the card: "jax" and "pallas" both take
ops/me_cuda.integer_me_np on the encoder's device, the CUDA kernel
csrc/me_full_search.cu there (its plain version on the CPU); None and
"numpy" keep the numpy full search.  The JAX package sets a process
global (analysis_inter_np.ME_ENGINE) that every numpy-engine encoder of
the process then follows; here the setting belongs to the encoder.

`encode_frames` is the JAX package's batched all-intra route: the
analysis of chunk k+1 (enc/analysis_torch.BatchAnalyzer under
analysis="jax", numpy analyze_frame on every other engine) runs on a
producer thread while the C pass codes chunk k.  `encode_stream_meshed`
spreads each RA sub-GOP's B-frame analyses over a list of devices
(parallel/mesh.py); its stream equals encode_stream's.  Both reproduce
the JAX package's routes as they are: encode_frames codes Baseline I
slices at the fixed qp with no RC update and no DPB push, and under DRA
both return mapped-domain reconstructions (ROADMAP §3).
"""
from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from queue import Queue

import numpy as np
import torch

from . import trace
from .constants import (NUT_IDR, NUT_NONIDR, NUT_SPS, NUT_PPS, NUT_SEI,
                        NUT_APS, QP_ADAPT_LD, QP_ADAPT_RA16, SLICE_I, SLICE_P,
                        SLICE_B, chroma_qp_dynamic)
from .device import device_scope, resolve_device
from .enc.analysis_inter_np import analyze_frame_inter
from .enc.analysis_inter_torch import analyze_frame_inter_torch
from .enc.analysis_main_np import analyze_frame_main
from .enc.analysis_main_torch import (analyze_frame_main_torch,
                                      collect_main_torch, dispatch_main_torch)
from .enc.analysis_np import analyze_frame
from .enc.analysis_torch import BatchAnalyzer, analyze_frame_torch
from .enc.device_analyzer import DeviceAnalyzer, _DeviceVec, _Handle
from .enc.frame_native import encode_frame_native
from .enc.frame_pass import FramePass, PAD_L
from .enc.intra_frame_native import encode_intra_frame_native
from .enc.main_intra_frame import MainIntraFramePass
from .enc.rc import POW_CPLX, RateControl, frame_complexity, scene_proxy
from .entropy.sbac import SbacEncoder, SbacCtx
from .hls import SPS, PPS, SliceHeader, NalHeader, wrap_nal
from .io.bits import BitWriter
from .ops import mc_np
from .ops import me_cuda
from .ops import picman_np
from .ops.dra_np import apply_dra, build_dra_maps, derive_sig_params
from .parallel.mesh import meshed_subgop_analysis
from .params import EncoderParams

CABAC_ZERO_PARAM = 32

# RA sub-GOPs scheduled on the frame-DAG C pass and not yet fully emitted:
# the one being emitted and the two after it (at 1080p on 4 frame workers 3
# coded 1.27x the frames a second of 2, and 4 no more than 3; PERF.md §6)
_SUBGOPS_IN_FLIGHT = 3
# the fused analysis takes a reference original only from the newest 24
# originals fed: what the analyzer's ring held before sub-GOPs overlapped,
# and what the JAX package's holds, so the dispatches stay the same
_ANALYSIS_REF_WINDOW = 24


@dataclass
class Stat:
    """Per-AU encode statistics (XEVE_STAT analog, inc/xeve.h:563-585,
    filled like xeve_enc.c:1296-1310)."""
    bytes: int = 0
    nalu_type: int = 0
    slice_type: int = 0
    qp: int = 0
    poc: int = 0
    tid: int = 0
    ref_pocs_l0: list = field(default_factory=list)
    ref_pocs_l1: list = field(default_factory=list)


class Encoder:
    """EVC Baseline and Main encoder (AI / low-delay / RA via
    GopEncoder)."""

    _RING_FRAMES = 24      # the device analyzer's original-frame ring

    def __init__(self, params: EncoderParams, analysis: str = "jax",
                 coder: str = "native", device="cuda", me_engine=None):
        if analysis not in ("jax", "device", "numpy"):
            raise ValueError(f"unknown analysis engine {analysis!r}")
        if coder not in ("native", "numpy"):
            raise ValueError(f"unknown coding pass {coder!r}")
        if me_engine not in (None, "numpy", "jax", "pallas"):
            raise ValueError(f"unknown me_engine {me_engine!r}")
        self.p = params.validate()
        p = self.p
        self.device = resolve_device(device)
        # the numpy inter analysis' integer ME, this encoder's own
        self._integer_me = None if me_engine in (None, "numpy") else \
            functools.partial(me_cuda.integer_me_np, device=self.device)
        if p.btt < 0:
            # auto: BTT on for Main AI with the native coder (stage-2
            # rectangular leaves need the exact-RD trial machinery)
            p.btt = 1 if (p.profile == 1 and p.keyint == 1
                          and coder == "native" and p.exact_rd
                          and p.tile_columns * p.tile_rows == 1
                          and not p.aq_mode) else 0
        self.pic_cnt = 0
        self.sps = self._make_sps()
        self.pps = self._make_pps()
        self.analysis_engine = analysis
        self.coder_engine = coder
        if p.aq_mode and coder != "native":
            raise ValueError("aq_mode (cu_qp_delta coding) requires the "
                             "native coding pass")
        if (coder != "native" and p.ref_pics > 1 and p.keyint != 1
                and not p.tool_eipd):
            raise ValueError("multi-ref (ref_pics>1) requires the native "
                             "coding pass")
        self.analysis_calls = 0
        self.ahead_tasks = 0
        self._batch_analyzer = None
        self._dev = None
        self._code_pool = None     # frame-parallel C-pass workers
        self.dpb = []          # DPB entries (padded recon + mv map + tid)
        self.poc = 0
        self.last_intra_poc = -(10 ** 9)   # list constraint (decoder parity)
        self._poc_state = picman_np.PocState()  # decoder-derivation mirror
        self.last_stat: Stat | None = None      # per-AU stats (XEVE_STAT)
        self._last_rec = None
        self._gop_in = []      # pending display-order frames (RA reordering)
        self._gop_base = 0
        self._first_done = False
        self._prev_orig_y = None
        self._fcst = []           # (disp_idx, scene proxy) lookahead ring
        self._fcst_prev = None    # previous pushed original (proxy base)
        self._force_idr = set()   # scene-cut keyframe inserts (disp idx)
        self._dra_maps = None
        self.rc = None
        if p.rc_type in ("abr", "crf"):
            self.rc = RateControl(p.rc_type, p.w, p.h, p.fps, p.bitrate_kbps,
                                  p.crf, p.qp_min, p.qp_max)

    # ------------------------------------------------------------------
    def _make_sps(self) -> SPS:
        p = self.p
        crop = (p.w != p.w_aligned) or (p.h != p.h_aligned)
        return SPS(
            profile_idc=p.profile,
            level_idc=p.level_idc * 3,
            pic_width_in_luma_samples=p.w_aligned,
            pic_height_in_luma_samples=p.h_aligned,
            picture_cropping_flag=1 if crop else 0,
            picture_crop_right_offset=(p.w_aligned - p.w + 1) >> 1,
            picture_crop_bottom_offset=(p.h_aligned - p.h + 1) >> 1,
            bit_depth_luma_minus8=p.codec_bit_depth - 8,
            bit_depth_chroma_minus8=p.codec_bit_depth - 8,
            chroma_format_idc=1,
            max_num_ref_pics=p.ref_pics,
            log2_sub_gop_length=4 if p.bframes >= 15 else 0,
            log2_ref_pic_gap_length=0,
            # main profile always signals dquant (xevem_util.c:3196); our
            # PPS keeps cu_qp_delta off so the payload stays identical
            dquant_flag=1 if p.profile == 1 else 0,
            tool_eipd=p.tool_eipd,
            tool_cm_init=p.tool_cm_init,
            tool_adcc=p.tool_adcc,
            tool_iqt=p.tool_iqt,
            tool_htdf=p.tool_htdf,
            tool_ats=p.tool_ats,
            tool_addb=p.tool_addb,
            tool_dra=p.tool_dra,
            sps_btt_flag=1 if p.btt else 0,
            # fixed stage-1 geometry (matches the native split_check
            # constants): CTU 64, min cb 4, 1:4 and ternary disabled
            log2_ctu_size_minus5=1,
            log2_min_cb_size_minus2=0,
            log2_diff_ctu_max_14_cb_size=6,
            log2_diff_ctu_max_tt_cb_size=2,
            log2_diff_min_cb_min_tt_cb_size_minus2=1,
        )

    def _make_pps(self) -> PPS:
        p = self.p
        # AQ -> cu_qp_delta signalling (xeve_enc.c:1454); area 6 baseline
        # (observed reference default) / 10 main (xevem.c:1159)
        dqp_kw = {}
        if p.aq_mode:
            dqp_kw = dict(cu_qp_delta_enabled_flag=1,
                          cu_qp_delta_area=10 if p.profile == 1 else 6)
        if p.tool_dra:
            dqp_kw.update(pic_dra_enabled_flag=1, pic_dra_aps_id=0)
        n = p.tile_columns * p.tile_rows
        if n > 1:
            id_len_m1 = 0
            while n > (1 << id_len_m1):      # xevem_util.c:3281
                id_len_m1 += 1
            return PPS(single_tile_in_pic_flag=0,
                       num_tile_columns_minus1=p.tile_columns - 1,
                       num_tile_rows_minus1=p.tile_rows - 1,
                       uniform_tile_spacing_flag=1,
                       loop_filter_across_tiles_enabled_flag=0,
                       tile_offset_lens_minus1=31,
                       tile_id_len_minus1=id_len_m1, **dqp_kw)
        return PPS(**dqp_kw)

    def _n_tiles(self):
        return self.p.tile_columns * self.p.tile_rows

    def _sh_tiles(self, sh, tile_lens):
        """Fill multi-tile slice-header fields (entry points are
        byte-length-minus1 of each non-final substream,
        xeve_enc.c:545-551)."""
        n = self._n_tiles()
        if n > 1:
            sh.single_tile_in_slice_flag = 0
            sh.first_tile_id = 0
            sh.last_tile_id = n - 1
            sh.entry_point_offsets = [l - 1 for l in tile_lens[:n - 1]]

    def _headers(self) -> bytes:
        if self.p.tool_dra:
            self._dra_init()
        out = b""
        bw = BitWriter()
        NalHeader(NUT_SPS, 0).write(bw)
        self.sps.write(bw)
        out += wrap_nal(bw.get_bytes())
        bw = BitWriter()
        NalHeader(NUT_PPS, 0).write(bw)
        self.pps.write(bw, main=self.sps.profile_idc == 1)
        out += wrap_nal(bw.get_bytes())
        if self.p.tool_dra:
            # DRA APS (xevem_eco_aps_gen, xevem_eco.c:235)
            bw = BitWriter()
            NalHeader(NUT_APS, 0).write(bw)
            bw.write(0, 5)                   # aps_id
            bw.write(1, 3)                   # aps_type_id = DRA
            self._dra_sig.write(bw, self.p.codec_bit_depth)
            bw.write1(0)                     # aps_extension_flag
            bw.byte_align()
            out += wrap_nal(bw.get_bytes())
        return out

    def _dra_init(self):
        if self._dra_maps is None:
            p = self.p
            self._dra_sig = derive_sig_params(
                p.qp, p.qp_cb_offset, p.qp_cr_offset,
                num_ranges=p.dra_number_ranges,
                in_points=[int(t) for t in p.dra_range.split()],
                scales=[float(t) for t in p.dra_scale.split()],
                hist_norm=p.dra_hist_norm,
                bit_depth=p.codec_bit_depth)
            self._dra_maps = build_dra_maps(self._dra_sig,
                                            p.codec_bit_depth)

    def _dra_backward(self, rec):
        """Backward-map an output recon tuple (the DPB copy stays in the
        mapped domain, like CFG_GET_RECON, xevem.c:1036)."""
        if not self.p.tool_dra:
            return rec
        y, u, v = rec
        return apply_dra(y, u, v, self._dra_maps, backward=True)

    def _pad_input(self, y, u, v):
        """Edge-replicate to the 8-aligned coded size (SPS crop signals the
        real dimensions).  With DRA the forward map applies here, once per
        input frame — the whole encoder then works in the mapped domain
        (fn_pic_flt, xeve_enc.c:656)."""
        p = self.p
        if p.tool_dra:
            self._dra_init()
            y, u, v = apply_dra(np.asarray(y, np.int32),
                                np.asarray(u, np.int32),
                                np.asarray(v, np.int32),
                                self._dra_maps, backward=False)
        if p.w == p.w_aligned and p.h == p.h_aligned:
            return (np.asarray(y, np.int32), np.asarray(u, np.int32),
                    np.asarray(v, np.int32))
        ey = p.h_aligned - p.h
        ex = p.w_aligned - p.w
        y = np.pad(np.asarray(y, np.int32), ((0, ey), (0, ex)), mode="edge")
        u = np.pad(np.asarray(u, np.int32), ((0, ey // 2 + (ey & 1)), (0, ex // 2 + (ex & 1))), mode="edge")
        v = np.pad(np.asarray(v, np.int32), ((0, ey // 2 + (ey & 1)), (0, ex // 2 + (ex & 1))), mode="edge")
        u = u[:p.h_aligned // 2, :p.w_aligned // 2]
        v = v[:p.h_aligned // 2, :p.w_aligned // 2]
        return y, u, v

    # ------------------------------------------------------------------
    def _slice_type_for(self, pic_cnt: int) -> int:
        p = self.p
        if p.keyint == 1 or pic_cnt == 0 or pic_cnt in self._force_idr:
            return SLICE_I
        if p.keyint > 1 and pic_cnt % p.keyint == 0:
            return SLICE_I
        return SLICE_P

    def _rc_qp(self, slice_type: int, depth: int, y,
               cpx: float | None = None) -> int | None:
        """Frame qp from the rate model (None without RC).  cpx: complexity
        from the fused device analysis (AnalysisResult.rc_cost) when it is
        already available (dispatch-ahead paths); host Hadamard proxy
        otherwise.  The adaptive-k model is scale-invariant so the two
        sources can coexist across slice types."""
        if self.rc is None:
            return None
        if cpx is None:
            cpx = frame_complexity(
                np.asarray(y),
                self._prev_orig_y if slice_type != SLICE_I else None)
        self._rc_cpx = cpx
        # lookahead-lite forecast: complexity proxies of the frames
        # already sitting in the dispatch-ahead pipeline, in one shared
        # proxy domain (ratios only, so the device rc_cost scale of
        # `cpx` does not matter)
        cur = [c for (d, c) in self._fcst if d == self.pic_cnt]
        ahead = [c for (d, c) in self._fcst if d > self.pic_cnt]
        fr = None
        if cur and ahead:
            pows = [max(c, 1.0) ** POW_CPLX for c in [cur[0]] + ahead]
            fr = pows[0] / max(sum(pows) / len(pows), 1e-6)
        return self.rc.pick_qp(slice_type, depth, cpx, fcst_ratio=fr)

    def _rc_update(self, slice_type: int, qp: int, nbytes: int):
        self._last_qp = qp
        if self.rc is not None:
            self.rc.update(slice_type, qp, nbytes * 8, self._rc_cpx)

    def _qp_guess(self, slice_type: int) -> int:
        """QP used for dispatch-ahead analysis.  Exact on the fixed-QP path;
        with rate control the final QP is re-derived at coding time and the
        analysis decisions tolerate the small mismatch."""
        if self.rc is None:
            return self._slice_qp(slice_type)
        return getattr(self, "_last_qp", self.p.qp)

    def _fill_stat(self, nbytes, nut, slice_type, qp, poc, tid,
                   refp=None, refp1=None, rec=None):
        """Per-AU stat record (xeve_enc.c:1296-1310 analog)."""
        self.last_stat = Stat(
            bytes=nbytes, nalu_type=nut, slice_type=slice_type, qp=qp,
            poc=poc, tid=tid,
            ref_pocs_l0=[r["poc"] for r in (refp or [])],
            ref_pocs_l1=[r["poc"] for r in (refp1 or [])])
        self._last_rec = rec

    # ------------------------------------------------------------------
    # runtime config surface (xeve_config analog, xeve.c:148-314)
    def config_set(self, key: str, value):
        if key == "qp":
            self.p.qp = int(value)
        elif key == "use_deblock":
            self.p.use_deblock = bool(value)
        elif key == "use_pic_sign":
            self.p.use_pic_sign = bool(value)
        elif key == "bitrate_kbps":
            self.p.bitrate_kbps = float(value)
            if self.rc is not None:
                self.rc.bitrate = float(value) * 1000.0
                self.rc.bpf = self.rc.bitrate / self.rc.fps
        elif key == "search_range":
            self.p.search_range = int(value)
        else:
            raise KeyError(f"unknown config key {key}")

    def config_get(self, key: str):
        if key == "qp":
            return self.p.qp
        if key == "width":
            return self.p.w
        if key == "height":
            return self.p.h
        if key == "bitrate_kbps":
            return self.p.bitrate_kbps
        if key == "recon":
            return self._last_rec
        if key == "stat":
            return self.last_stat
        if key == "use_deblock":
            return self.p.use_deblock
        if key == "use_pic_sign":
            return self.p.use_pic_sign
        raise KeyError(f"unknown config key {key}")

    def _aq_map(self, y, u, v, extra_mv_fields=None):
        """Per-SCU AQ qp-offset map (None when AQ is off): variance model
        of xeve_fcst.c:271, optionally sharpened by cutree-lite
        propagation along dependent frames' MV fields."""
        if not self.p.aq_mode:
            return None
        from .enc.aq import (aq_block_offsets, offsets_to_scu_map,
                             cutree_propagate)
        off = aq_block_offsets(np.asarray(y), np.asarray(u),
                               np.asarray(v), self.p.codec_bit_depth)
        if extra_mv_fields:
            off = cutree_propagate(off, extra_mv_fields)
        return offsets_to_scu_map(off, self.p.h_aligned, self.p.w_aligned)

    def _device(self):
        if self._dev is None:
            p = self.p
            self._dev = DeviceAnalyzer(
                p.w_aligned, p.h_aligned, p.codec_bit_depth,
                search_range=p.search_range, min_log2=p.min_cu_log2,
                ring_size=self._RING_FRAMES, device=self.device,
                integer_me_fn=self._integer_me)
        return self._dev

    def prewarm(self) -> float:
        """Run every analysis signature this configuration will use once on
        dummy frames before the first real frame: the device engine's
        dispatch signatures (concurrently, each read back), or the "jax"
        engine's intra and inter analyses, which build the ME kernel at
        first use on the card.  Dummy frames are evicted afterwards.
        Returns seconds spent; no-op for the numpy engine."""
        t0 = time.time()
        p = self.p
        if self.analysis_engine == "numpy":
            return 0.0
        qp = p.qp
        qp_y, qp_u, qp_v = self._qp_triplet(qp)
        bd = p.codec_bit_depth
        z = np.zeros((p.h_aligned, p.w_aligned), np.int16)
        zc = np.zeros((p.h_aligned // 2, p.w_aligned // 2), np.int16)
        dev = None
        base = -(1 << 20)
        if self.analysis_engine == "device" and not p.tool_eipd:
            dev = self._device()
            for i in range(3):
                dev.put_frame(base + i, z, zc, zc)
            sigs = [dict()]
            if p.keyint != 1:
                sigs.append(dict(ref_poc=base))
                if p.ref_pics > 1:
                    sigs.append(dict(ref_poc=base, ref0b_poc=base + 1))
            if p.bframes >= 15:
                sigs.append(dict(ref_poc=base, ref1_poc=base + 1))
                if p.ref_pics > 1:
                    sigs.append(dict(ref_poc=base, ref1_poc=base + 1,
                                     ref0b_poc=base + 2,
                                     ref1b_poc=base + 2))

            def warm_dev(sig):
                hd = dev.dispatch(base + 2, qp, qp_y, qp_u, qp_v, **sig)
                np.asarray(hd.vec)      # force completion (readback)

            jobs = [(warm_dev, (s,)) for s in sigs]
        else:
            def warm_intra():
                analyze = analyze_frame_main_torch if p.tool_eipd \
                    else analyze_frame_torch
                analyze(z, zc, zc, qp, qp_y, qp_u, qp_v, bd,
                        min_log2=p.min_cu_log2, device=self.device)

            def warm_inter(with_b):
                zi = np.zeros((p.h_aligned, p.w_aligned), np.int32)
                zci = np.zeros((p.h_aligned // 2, p.w_aligned // 2),
                               np.int32)
                ref = {"y_pad": mc_np.pad_picture(zi, PAD_L),
                       "u_pad": mc_np.pad_picture(zci, PAD_L // 2),
                       "v_pad": mc_np.pad_picture(zci, PAD_L // 2),
                       "poc": base}
                analyze_frame_inter_torch(
                    zi, zci, zci, [ref], qp, qp_y, qp_u, qp_v, bd,
                    search_range=p.search_range,
                    refp1=[dict(ref)] if with_b else None,
                    min_log2=p.min_cu_log2, device=self.device)

            jobs = [(warm_intra, ())]
            if p.keyint != 1:
                jobs.append((warm_inter, (p.bframes >= 15,)))
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(5, len(jobs))) as ex:
            for fu in [ex.submit(fn, *a) for fn, a in jobs]:
                fu.result()
        if dev is not None:
            for i in range(3):
                dev.ring.pop(base + i, None)
                dev.host_ring.pop(base + i, None)
        return time.time() - t0

    def _qp_triplet(self, qp: int):
        """(qp_y, qp_u, qp_v) at codec bit depth (xeve_enc.c:1463 set_sh);
        Main+IQT uses the main chroma QP table (xevem_tbl.c)."""
        p = self.p
        bd = p.codec_bit_depth
        qp_y = qp + 6 * (bd - 8)
        qpu_i = int(np.clip(qp + p.qp_cb_offset, -6 * (bd - 8), 57))
        qpv_i = int(np.clip(qp + p.qp_cr_offset, -6 * (bd - 8), 57))
        qp_u = chroma_qp_dynamic(qpu_i, p.tool_iqt) + 6 * (bd - 8)
        qp_v = chroma_qp_dynamic(qpv_i, p.tool_iqt) + 6 * (bd - 8)
        return qp_y, qp_u, qp_v

    def _slice_qp(self, slice_type: int) -> int:
        """Low-delay hierarchical QP offsets (xeve_set_sh, xeve_enc.c:1496;
        xeve_qp_adapt_param_ld with ref gap 1 -> depth 0 for I, 2 for P)."""
        p = self.p
        if p.keyint == 1:
            return p.qp
        depth = 0 if slice_type == SLICE_I else 2
        off_layer, off_model, scale_model = QP_ADAPT_LD[depth]
        qp = p.qp + off_layer
        dqp = qp * scale_model + off_model + 0.5
        qp += int(np.floor(np.clip(dqp, 0.0, 3.0)))
        return int(np.clip(qp, 0, 51))

    def _analyze_intra(self, y, u, v, qp, **kw):
        """The "jax" or "numpy" engine's intra analysis of one padded
        frame: the 33-mode EIPD analysis for Main, the 5-mode one for
        Baseline."""
        p = self.p
        qp_y, qp_u, qp_v = self._qp_triplet(qp)
        self.analysis_calls += 1
        if self.analysis_engine == "numpy":
            y, u, v = (np.asarray(a, np.int32) for a in (y, u, v))
            if p.tool_eipd:
                return analyze_frame_main(y, u, v, qp, qp_y, qp_u, qp_v,
                                          p.codec_bit_depth,
                                          tool_iqt=p.tool_iqt, **kw)
            return analyze_frame(y, u, v, qp, qp_y, qp_u, qp_v,
                                 p.codec_bit_depth, **kw)
        analyze = analyze_frame_main_torch if p.tool_eipd \
            else analyze_frame_torch
        return analyze(y, u, v, qp, qp_y, qp_u, qp_v, p.codec_bit_depth,
                       device=self.device, **kw)

    def _analyze_inter(self, y, u, v, refp, qp, qp_y, qp_u, qp_v, bd,
                       refp1=None, search_range=16):
        """The "jax" or "numpy" engine's inter analysis of one padded
        frame."""
        self.analysis_calls += 1
        if self.analysis_engine == "numpy":
            return analyze_frame_inter(y, u, v, refp, qp, qp_y, qp_u, qp_v,
                                       bd, refp1=refp1,
                                       search_range=search_range,
                                       integer_me_fn=self._integer_me)
        return analyze_frame_inter_torch(y, u, v, refp, qp, qp_y, qp_u, qp_v,
                                         bd, refp1=refp1,
                                         search_range=search_range,
                                         device=self.device)

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     analysis_pre=None):
        """Encode one frame (I or low-delay P per keyint).  Inputs are 2-D
        arrays at codec bit depth.  Returns (bitstream_bytes,
        (rec_y, rec_u, rec_v)), the recon backward-mapped under DRA.
        analysis_pre: decision maps already computed by the caller."""
        out, rec = self._encode_frame_mapped(*self._pad_input(y, u, v),
                                             analysis_pre)
        return out, self._dra_backward(rec)

    def _encode_frame_mapped(self, y, u, v, analysis_pre=None):
        """encode_frame of a frame that _pad_input has already padded (and
        DRA-mapped); returns the mapped-domain recon."""
        p = self.p
        slice_type = self._slice_type_for(self.pic_cnt)
        if slice_type == SLICE_P:
            return self._encode_frame_p(y, u, v, analysis_pre)
        nut = NUT_IDR if (self.pic_cnt == 0 or (p.closed_gop and p.keyint == 1)) else NUT_NONIDR
        self.last_intra_poc = self.poc   # decoder excludes pre-I refs

        out = b""
        if self.pic_cnt == 0 or (nut == NUT_IDR and self.pic_cnt > 0):
            out += self._headers()

        qp = self._rc_qp(slice_type, 0, y,
                         cpx=getattr(analysis_pre, "rc_cost", None))
        if qp is None:
            qp = self._slice_qp(slice_type)
        bd = p.codec_bit_depth
        qp_y, qp_u, qp_v = self._qp_triplet(qp)

        if p.tool_eipd:
            return self._encode_frame_i_main(y, u, v, nut, out, qp,
                                             analysis_pre)

        if analysis_pre is not None:
            analysis = analysis_pre
        elif self.analysis_engine == "device":
            dev = self._device()
            if not dev.has_frame(self.poc):
                dev.put_frame(self.poc, y, u, v)
            analysis = dev.collect(dev.dispatch(self.poc, qp, qp_y, qp_u,
                                                qp_v))
        else:
            analysis = self._analyze_intra(y, u, v, qp,
                                           min_log2=p.min_cu_log2)

        if self.coder_engine == "numpy":
            slice_payload, bin_count, rec = self._code_i_slice_numpy(
                y, u, v, qp, analysis)
            return self._emit_i_slice(nut, out, qp, slice_payload, bin_count,
                                      y, rec)
        slice_payload, bin_count, rec_y, rec_u, rec_v, _tl = \
            encode_intra_frame_native(p.w_aligned, p.h_aligned, bd, qp,
                                      p.qp_cb_offset, p.qp_cr_offset,
                                      y, u, v, analysis,
                                      use_rdoq=p.rdoq,
                                      use_deblock=p.use_deblock,
                                      aq_map=self._aq_map(y, u, v),
                                      cu_qp_delta_area=self.pps.cu_qp_delta_area,
                                      dquant_flag=self.sps.dquant_flag,
                                      exact_rd=p.exact_rd)
        return self._emit_i_slice(nut, out, qp, slice_payload, bin_count,
                                  y, (rec_y, rec_u, rec_v))

    def _code_i_slice_numpy(self, y, u, v, qp, analysis):
        """The numpy coding-pass oracle of an I slice: FramePass for
        Baseline, MainIntraFramePass for Main.  Returns (payload,
        bin_count, rec)."""
        p = self.p
        bd = p.codec_bit_depth
        sbac = SbacEncoder()
        if p.tool_eipd:
            ctx = SbacCtx(SLICE_I, qp, p.tool_cm_init)
            fp = MainIntraFramePass(p.w_aligned, p.h_aligned, bd, bd - 8, qp,
                                    p.qp_cb_offset, p.qp_cr_offset,
                                    use_rdoq=p.rdoq,
                                    use_deblock=p.use_deblock,
                                    tool_iqt=p.tool_iqt,
                                    tool_htdf=p.tool_htdf,
                                    tool_ats=p.tool_ats,
                                    tool_addb=p.tool_addb)
        else:
            ctx = SbacCtx()
            fp = FramePass(p.w_aligned, p.h_aligned, bd, bd - 8, qp,
                           p.qp_cb_offset, p.qp_cr_offset,
                           use_rdoq=p.rdoq, use_deblock=p.use_deblock)
        rec_y, rec_u, rec_v, _ = fp.encode(y, u, v, analysis, sbac, ctx)
        return sbac.finish(), sbac.bin_counter, (rec_y, rec_u, rec_v)

    def _encode_frame_i_main(self, y, u, v, nut, out, qp, analysis_pre=None):
        """Main-profile I slice: EIPD + CM_INIT + ADCC + IQT (+ ATS, HTDF,
        ADDB, BTT per the parameters) on the native C pass (quad tree,
        CTU 64) or the numpy MainIntraFramePass.  Every engine analyses it
        with its EIPD analysis unless the caller brings decisions
        (analysis_pre)."""
        p = self.p
        bd = p.codec_bit_depth
        if analysis_pre is not None:
            analysis = analysis_pre
        else:
            analysis = self._analyze_intra(y, u, v, qp,
                                           min_log2=p.min_cu_log2)
        if self.coder_engine == "numpy":
            slice_payload, bin_count, rec = self._code_i_slice_numpy(
                y, u, v, qp, analysis)
            return self._emit_i_slice(nut, out, qp, slice_payload, bin_count,
                                      y, rec)
        slice_payload, bin_count, rec_y, rec_u, rec_v, tile_lens = \
            encode_intra_frame_native(p.w_aligned, p.h_aligned, bd, qp,
                                      p.qp_cb_offset, p.qp_cr_offset,
                                      y, u, v, analysis,
                                      use_rdoq=p.rdoq,
                                      use_deblock=p.use_deblock,
                                      main_eipd=1, tool_iqt=p.tool_iqt,
                                      cm_init=p.tool_cm_init,
                                      tile_cols=p.tile_columns,
                                      tile_rows=p.tile_rows,
                                      threads=p.threads,
                                      aq_map=self._aq_map(y, u, v),
                                      cu_qp_delta_area=self.pps.cu_qp_delta_area,
                                      dquant_flag=self.sps.dquant_flag,
                                      tool_ats=p.tool_ats,
                                      tool_htdf=p.tool_htdf,
                                      tool_addb=p.tool_addb,
                                      sps_btt=p.btt, exact_rd=p.exact_rd)
        return self._emit_i_slice(nut, out, qp, slice_payload, bin_count,
                                  y, (rec_y, rec_u, rec_v), tile_lens)

    def _emit_i_slice(self, nut, out, qp, slice_payload, bin_count, y, rec,
                      tile_lens=None):
        """Append a coded I slice to `out` (slice header, entry points when
        tile_lens is given, stuffing, signature SEI), feed its size to the
        rate model and its reconstruction to the DPB.  y: the slice's
        padded original.  Returns (out, rec)."""
        p = self.p
        sh = SliceHeader(slice_type=SLICE_I, qp=qp,
                         qp_u_offset=p.qp_cb_offset,
                         qp_v_offset=p.qp_cr_offset,
                         deblocking_filter_on=1 if p.use_deblock else 0)
        if tile_lens is not None:
            self._sh_tiles(sh, tile_lens)
        bw = BitWriter()
        NalHeader(nut, 0).write(bw)
        sh.write(bw, nut, self.sps, self.pps)
        payload = bw.get_bytes() + slice_payload
        payload += self._cabac_zero_words(bin_count, len(payload))
        out += wrap_nal(payload)
        if p.use_pic_sign:
            out += self._signature_sei(*rec)
        self._rc_update(SLICE_I, qp, len(out))
        self._prev_orig_y = np.asarray(y)
        self._dpb_push(*rec, None)
        self.pic_cnt += 1
        self._fill_stat(len(out), nut, SLICE_I, qp, self.poc - 1, 0, rec=rec)
        return out, rec

    def _dpb_push(self, rec_y, rec_u, rec_v, map_mv, poc=None, tid=0,
                  is_ref=True, is_idr=False, list0_poc=None):
        h_scu = (self.p.h_aligned + 3) >> 2
        w_scu = (self.p.w_aligned + 3) >> 2
        if map_mv is None:
            map_mv = np.zeros((h_scu, w_scu, 2, 2), dtype=np.int32)
        if poc is None:
            poc = self.poc
            self.poc += 1
        pic = {
            "poc": poc,
            "tid": tid,
            "ref": is_ref,
            "list0_poc": list0_poc if list0_poc is not None else poc,
            "y_pad": mc_np.pad_picture(np.asarray(rec_y, np.int32), PAD_L),
            "u_pad": mc_np.pad_picture(np.asarray(rec_u, np.int32), PAD_L // 2),
            "v_pad": mc_np.pad_picture(np.asarray(rec_v, np.int32), PAD_L // 2),
            "map_mv": map_mv,
        }
        picman_np.dpb_mark_and_insert(self.dpb, pic, is_idr)

    def _encode_frame_p(self, y, u, v, analysis_pre=None):
        p = self.p
        bd = p.codec_bit_depth
        qp = self._rc_qp(SLICE_P, 2, y,
                         cpx=getattr(analysis_pre, "rc_cost", None))
        if qp is None:
            qp = self._slice_qp(SLICE_P)
        qp_y, qp_u, qp_v = self._qp_triplet(qp)
        refp, _ = picman_np.build_ref_lists(
            self.dpb, self.poc, 0, SLICE_B, SLICE_P, SLICE_P,
            self.sps.max_num_ref_pics, self.last_intra_poc)
        if analysis_pre is not None:
            an = analysis_pre
        elif self.analysis_engine == "device":
            dev = self._device()
            if not dev.has_frame(self.poc):
                dev.put_frame(self.poc, y, u, v)
            r0b = refp[1]["poc"] if len(refp) > 1 else None
            an = dev.collect(dev.dispatch(self.poc, qp, qp_y, qp_u, qp_v,
                                          ref_poc=refp[0]["poc"],
                                          ref0b_poc=r0b))
        else:
            an = self._analyze_inter(np.asarray(y, np.int32),
                                     np.asarray(u, np.int32),
                                     np.asarray(v, np.int32), refp, qp, qp_y,
                                     qp_u, qp_v, bd,
                                     search_range=p.search_range)
        slice_payload, bin_count, rec_y, rec_u, rec_v, map_mv, tile_lens = \
            self._code_slice(SLICE_P, self.poc, qp, y, u, v, an, refp, None,
                             aq_map=self._aq_map(y, u, v))
        sh = SliceHeader(slice_type=SLICE_P, qp=qp,
                         qp_u_offset=p.qp_cb_offset, qp_v_offset=p.qp_cr_offset,
                         deblocking_filter_on=1 if p.use_deblock else 0)
        self._sh_tiles(sh, tile_lens)
        bw = BitWriter()
        NalHeader(NUT_NONIDR, 0).write(bw)
        sh.write(bw, NUT_NONIDR, self.sps, self.pps)
        payload = bw.get_bytes() + slice_payload
        payload += self._cabac_zero_words(bin_count, len(payload))
        out = wrap_nal(payload)
        if p.use_pic_sign:
            out += self._signature_sei(rec_y, rec_u, rec_v)
        self._rc_update(SLICE_P, qp, len(out))
        self._prev_orig_y = np.asarray(y)
        self._dpb_push(rec_y, rec_u, rec_v, map_mv)
        self.pic_cnt += 1
        self._fill_stat(len(out), NUT_NONIDR, SLICE_P, qp, self.poc - 1, 0,
                        refp=refp, rec=(rec_y, rec_u, rec_v))
        return out, (rec_y, rec_u, rec_v)

    def _code_slice(self, slice_type, poc, qp, y, u, v, an, refp, refp1,
                    aq_map=None):
        """Run the closed-loop slice coding pass (native C fast path or the
        numpy FramePass oracle).  Returns (payload, bin_count, rec_y, rec_u,
        rec_v, map_mv, tile_lens)."""
        p = self.p
        if self.coder_engine == "numpy" and not p.tool_eipd:
            # Main-tool P/B slices run natively only (the numpy FramePass
            # oracle covers the Baseline toolset; __init__ refuses AQ and
            # multi-ref with it)
            sbac = SbacEncoder()
            fp = FramePass(p.w_aligned, p.h_aligned, p.codec_bit_depth,
                           p.codec_bit_depth - 8, qp,
                           p.qp_cb_offset, p.qp_cr_offset,
                           slice_type=slice_type, refp=refp, refp1=refp1,
                           poc=poc, use_rdoq=p.rdoq,
                           use_deblock=p.use_deblock)
            rec_y, rec_u, rec_v, _ = fp.encode(np.asarray(y, np.int32),
                                               np.asarray(u, np.int32),
                                               np.asarray(v, np.int32), an,
                                               sbac, SbacCtx())
            return (sbac.finish(), sbac.bin_counter, rec_y, rec_u, rec_v,
                    fp.map_mv, None)
        payload, bin_count, rec_y, rec_u, rec_v, map_mv, _refi, tl = \
            encode_frame_native(p.w_aligned, p.h_aligned, p.codec_bit_depth,
                                qp, p.qp_cb_offset, p.qp_cr_offset,
                                slice_type, poc, y, u, v, an,
                                refp=refp, refp1=refp1, pad_l=PAD_L,
                                use_rdoq=p.rdoq,
                                use_deblock=p.use_deblock,
                                main_eipd=p.tool_eipd,
                                tool_iqt=p.tool_iqt,
                                cm_init=p.tool_cm_init,
                                tile_cols=p.tile_columns,
                                tile_rows=p.tile_rows,
                                threads=p.threads,
                                aq_map=aq_map,
                                cu_qp_delta_area=self.pps.cu_qp_delta_area,
                                dquant_flag=self.sps.dquant_flag,
                                tool_ats=p.tool_ats,
                                tool_htdf=p.tool_htdf,
                                tool_addb=p.tool_addb,
                                sps_btt=p.btt,
                                exact_rd=p.exact_rd)
        return payload, bin_count, rec_y, rec_u, rec_v, map_mv, tl

    def encode_frames(self, frames, batch: int = 4):
        """Batch all-intra encode with a two-stage pipeline: the analysis
        of chunk k+1 runs on a producer thread while the native C pass
        codes chunk k.  frames: list of (y, u, v).  Returns a list of
        (bitstream_bytes, (rec_y, rec_u, rec_v)).

        The JAX package's route as it is (xeve_tpu/api.py:817): the
        BatchAnalyzer under analysis="jax", numpy analyze_frame on every
        other engine; Baseline I slices at the fixed p.qp with the Baseline
        chroma table; no RC update and no DPB push.  An exception in the
        producer is raised here."""
        p = self.p
        frames = [self._pad_input(*f) for f in frames]
        qp = p.qp
        bd = p.codec_bit_depth
        qp_y = qp + 6 * (bd - 8)
        qpu_i = int(np.clip(qp + p.qp_cb_offset, -6 * (bd - 8), 57))
        qpv_i = int(np.clip(qp + p.qp_cr_offset, -6 * (bd - 8), 57))
        qp_u = chroma_qp_dynamic(qpu_i) + 6 * (bd - 8)
        qp_v = chroma_qp_dynamic(qpv_i) + 6 * (bd - 8)

        chunks = [frames[i:i + batch] for i in range(0, len(frames), batch)]

        def analyze_chunk(chunk):
            self.analysis_calls += len(chunk)
            if self.analysis_engine == "jax":
                if self._batch_analyzer is None:
                    self._batch_analyzer = BatchAnalyzer(
                        p.w_aligned, p.h_aligned, qp, qp_y, qp_u, qp_v, bd,
                        device=self.device)
                return self._batch_analyzer.analyze(chunk)
            return [analyze_frame(np.asarray(y, dtype=np.int32),
                                  np.asarray(u, dtype=np.int32),
                                  np.asarray(v, dtype=np.int32),
                                  qp, qp_y, qp_u, qp_v, bd)
                    for (y, u, v) in chunk]

        q = Queue(maxsize=1)

        def producer():
            # a new thread starts on device 0: enqueue on self.device
            try:
                with device_scope(self.device):
                    for ch in chunks:
                        q.put((analyze_chunk(ch), None))
            except Exception as e:           # raised by the caller
                q.put((None, e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        out = []
        for ch in chunks:
            analyses, err = q.get()  # chunk k analyses; chunk k+1 in flight
            if err is not None:
                t.join()
                raise err
            for (y, u, v), an in zip(ch, analyses):
                nut = NUT_IDR if self.pic_cnt == 0 else NUT_NONIDR
                bs = b""
                if self.pic_cnt == 0:
                    bs += self._headers()
                sh = SliceHeader(slice_type=SLICE_I, qp=qp,
                                 qp_u_offset=p.qp_cb_offset,
                                 qp_v_offset=p.qp_cr_offset,
                                 deblocking_filter_on=1 if p.use_deblock
                                 else 0)
                bw = BitWriter()
                NalHeader(nut, 0).write(bw)
                sh.write(bw, nut, self.sps, self.pps)
                slice_payload, bin_count, rec_y, rec_u, rec_v, _tl = \
                    encode_intra_frame_native(
                        p.w_aligned, p.h_aligned, bd, qp, p.qp_cb_offset,
                        p.qp_cr_offset, y, u, v, an, use_rdoq=p.rdoq,
                        use_deblock=p.use_deblock,
                        aq_map=self._aq_map(y, u, v),
                        cu_qp_delta_area=self.pps.cu_qp_delta_area,
                        dquant_flag=self.sps.dquant_flag,
                        exact_rd=p.exact_rd)
                payload = bw.get_bytes() + slice_payload
                payload += self._cabac_zero_words(bin_count, len(payload))
                bs += wrap_nal(payload)
                if p.use_pic_sign:
                    bs += self._signature_sei(rec_y, rec_u, rec_v)
                self.pic_cnt += 1
                out.append((bs, (rec_y, rec_u, rec_v)))
        t.join()
        return out

    @staticmethod
    def _frame_workers():
        """Native coding-pass worker threads for frame-parallel coding
        (XEVE_TPU_FRAME_WORKERS env override; default = CPU count, max 4).
        The C pass releases the GIL, so independent frames of a sub-GOP
        code concurrently."""
        return max(1, int(os.environ.get(
            "XEVE_TPU_FRAME_WORKERS", str(min(4, os.cpu_count() or 1)))))

    def encode_stream(self, frames, ahead: int = 3):
        """Encode an iterable of (y, u, v) frames; yields (bitstream_bytes,
        (rec_y, rec_u, rec_v), poc) per frame, the recon backward-mapped
        under DRA: display order for AI/LD, coding order for RA GOP16
        (GopEncoder).

        With the device analysis engine the fused analysis of up to `ahead`
        future frames runs on the device while the native C pass codes the
        current frame (analysis references *original* frames, so it never
        waits for reconstruction).

        Closing the stream closes the route's own generator at once, so
        its frame workers submit nothing more.
        """
        stream = self._encode_stream(frames, ahead)
        try:
            for bs, rec, poc in stream:
                yield bs, self._dra_backward(rec), poc
        finally:
            stream.close()

    def _encode_stream(self, frames, ahead):
        """encode_stream with mapped-domain reconstructions (AI/LD)."""
        p = self.p
        if (p.tool_eipd and p.keyint == 1
                and self.analysis_engine in ("jax", "device")):
            yield from self._encode_stream_main_ai(frames, ahead)
            return
        if self.analysis_engine != "device":
            for fr in frames:
                bs, rec = self._encode_frame_mapped(*self._pad_input(*fr))
                yield bs, rec, self.poc - 1
            return
        dev = self._device()
        pending = deque()
        disp = self.pic_cnt

        # all-intra frames are fully independent: run their closed-loop C
        # passes on the frame-worker pool (emission stays serial, so the
        # bitstream is identical to the serial path)
        par_ai = (p.keyint == 1 and self.rc is None
                  and self.coder_engine == "native"
                  and self._frame_workers() > 1)
        if par_ai and self._code_pool is None:
            self._code_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._frame_workers(),
                thread_name_prefix="xt-frame")

        def code_ai(yuv, hd, poc, t_submit):
            with trace.span("frame.task", poc=poc, t_submit=t_submit):
                y, u, v = yuv
                qp = self._slice_qp(SLICE_I)
                return encode_intra_frame_native(
                    p.w_aligned, p.h_aligned, p.codec_bit_depth, qp,
                    p.qp_cb_offset, p.qp_cr_offset, y, u, v, dev.collect(hd),
                    use_rdoq=p.rdoq, use_deblock=p.use_deblock,
                    aq_map=self._aq_map(y, u, v),
                    cu_qp_delta_area=self.pps.cu_qp_delta_area,
                    dquant_flag=self.sps.dquant_flag,
                    exact_rd=p.exact_rd)

        def dispatch(fr):
            nonlocal disp
            with trace.span("api.feed", poc=disp):
                y, u, v = self._pad_input(*fr)
                dev.put_frame(disp, y, u, v)
            with trace.span("api.schedule", poc=disp):
                # lookahead-lite: per-frame complexity proxy feeding the RC
                # forecast window + scene-cut keyframe insertion
                # (xeve_fcst.c:106 scene type analog)
                px = scene_proxy(np.asarray(y), self._fcst_prev)
                self._fcst_prev = np.asarray(y)
                hist = [c for (_d, c) in self._fcst[-8:]]
                if (self.rc is not None and p.keyint != 1 and disp > 0
                        and len(hist) >= 2
                        and px > 6.0 * max(np.mean(hist), 1.0)):
                    self._force_idr.add(disp)
                self._fcst.append((disp, px))
                if len(self._fcst) > 32:
                    del self._fcst[:-32]
                st = self._slice_type_for(disp)
                qp = self._qp_guess(st)
                qp_y, qp_u, qp_v = self._qp_triplet(qp)
                ref = ref0b = None
                if st != SLICE_I:
                    ref = disp - 1
                    # second L0 ref (refi=1): previous-but-one, unless it
                    # precedes the last I (decoder list constraint)
                    last_i = ((disp // p.keyint) * p.keyint
                              if p.keyint > 1 else 0)
                    if (p.ref_pics > 1 and disp - 2 >= last_i
                            and dev.has_frame(disp - 2)):
                        ref0b = disp - 2
                hd = dev.dispatch_bg(disp, qp, qp_y, qp_u, qp_v, ref_poc=ref,
                                     ref0b_poc=ref0b)
                if par_ai:
                    hd = self._code_pool.submit(code_ai, (y, u, v), hd, disp,
                                                trace.now())
                pending.append(((y, u, v), hd, disp))
            disp += 1

        def code_next():
            yuv, hd, poc = pending.popleft()
            with trace.span("api.emit", poc=poc):
                if par_ai:
                    qp = self._slice_qp(SLICE_I)
                    with trace.span("api.wait", poc=poc):
                        payload, bin_count, rec_y, rec_u, rec_v, _tl = \
                            hd.result()
                    nut = NUT_IDR if (self.pic_cnt == 0
                                      or p.closed_gop) else NUT_NONIDR
                    self.last_intra_poc = self.poc
                    out = b""
                    if self.pic_cnt == 0 or nut == NUT_IDR:
                        out += self._headers()
                    out, rec = self._emit_i_slice(nut, out, qp, payload,
                                                  bin_count, yuv[0],
                                                  (rec_y, rec_u, rec_v))
                    return out, rec, self.poc - 1
                bs, rec = self._encode_frame_mapped(
                    *yuv, analysis_pre=dev.collect(hd))
                if p.closed_loop_ld:
                    # swap the coded frame's ring entry for its reconstruction
                    # so the NEXT P frame's ME references decoded pixels (the
                    # open-loop original-vs-recon mismatch accumulates along
                    # P chains; measured +6 BD points on LD — BDRATE.md)
                    dev.put_frame(self.poc - 1,
                                  np.asarray(rec[0], np.int16),
                                  np.asarray(rec[1], np.int16),
                                  np.asarray(rec[2], np.int16), replace=True)
                return bs, rec, self.poc - 1

        # closed-loop LD cannot dispatch ahead (frame k's analysis needs
        # frame k-1's reconstruction); open-loop overlaps `ahead` frames
        if p.closed_loop_ld:
            ahead = 0
        for fr in frames:
            dispatch(fr)
            if len(pending) > ahead:
                yield code_next()
        while pending:
            yield code_next()

    def _encode_stream_main_ai(self, frames, ahead):
        """Main AI on the "jax" or "device" engine: the EIPD analyses of up
        to `ahead` future frames are enqueued on the device
        (dispatch_main_torch makes no host readback) while the C pass codes
        the current frame.  Under RC an analysis runs at the qp of the
        last coded frame (_qp_guess)."""
        p = self.p
        pending = deque()

        def code_next():
            yuv, hd = pending.popleft()
            bs, rec = self._encode_frame_mapped(
                *yuv, analysis_pre=collect_main_torch(hd))
            return bs, rec, self.poc - 1

        for fr in frames:
            y, u, v = self._pad_input(*fr)
            qp = self._qp_guess(SLICE_I)
            hd = dispatch_main_torch(y, u, v, qp, *self._qp_triplet(qp),
                                     p.codec_bit_depth,
                                     min_log2=p.min_cu_log2,
                                     device=self.device)
            self.analysis_calls += 1
            pending.append(((y, u, v), hd))
            if len(pending) > ahead:
                yield code_next()
        while pending:
            yield code_next()

    def _cabac_zero_words(self, bin_count: int, num_bytes_in_units: int) -> bytes:
        """xeve_enc.c:553-577 conformance stuffing."""
        p = self.p
        log2_sub_wh_c = 2
        raw_bits = p.w_aligned * p.h_aligned * (p.codec_bit_depth +
                                2 * (p.codec_bit_depth >> log2_sub_wh_c))
        threshold = (CABAC_ZERO_PARAM // 3) * num_bytes_in_units + raw_bits // 32
        if bin_count >= threshold:
            target = ((bin_count - raw_bits // 32) * 3 + CABAC_ZERO_PARAM - 1) // CABAC_ZERO_PARAM
            if target > num_bytes_in_units:
                need = target - num_bytes_in_units
                words = (need + 2) // 3
                return b"\x00\x00" * words
        return b""

    def _signature_sei(self, rec_y, rec_u, rec_v) -> bytes:
        """Picture-signature SEI (xeve_eco.c:292-322): MD5 per plane over
        16-bit little-endian samples."""
        bw = BitWriter()
        NalHeader(NUT_SEI, 0).write(bw)
        bw.write(0x10, 8)   # XEVE_UD_PIC_SIGNATURE
        bw.write(16, 8)
        for plane in (rec_y, rec_u, rec_v):
            dig = hashlib.md5(plane.astype('<u2').tobytes()).digest()
            for b in dig:
                bw.write(b, 8)
        return wrap_nal(bw.get_bytes())


def psnr(a: np.ndarray, b: np.ndarray, bd: int = 10) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 99.0
    peak = (1 << bd) - 1
    return 10.0 * np.log10(peak * peak / mse)


# ----------------------------------------------------------------------
# Random-access GOP16 engine (xeve default -b 15 structure)
# ----------------------------------------------------------------------


@dataclass(eq=False)
class _Subgop:
    """One RA sub-GOP scheduled on the frame-DAG C pass: its 17 input
    frames (index: display poc - base), its tasks in coding order (poc,
    display poc, tid, is_ref, dispatch handle, qp), their frozen ref lists
    by poc, and the DPB entries by poc when it was scheduled."""
    base: int
    frames: list
    items: list
    lists: dict
    snap: dict
    deps: dict = field(init=False)

    def __post_init__(self):
        # the POCs of each frame's lists whose recon a task makes
        self.deps = {poc: [q for q in l0 + l1 if q not in self.snap]
                     for poc, (l0, l1) in self.lists.items()}


class _FrameDag:
    """The frame-DAG C pass of an RA stream on the device engine, one for
    all its sub-GOPs: each frame's closed-loop C pass is a task on the
    encoder's `xt-frame` pool, handed to it once every frame of its frozen
    ref lists is in its sub-GOP's DPB snapshot or a done task, so a worker
    never blocks on a reference (a blocked worker would hold a slot and
    serialize the sub-GOP behind the anchor chain: wall time == sum of C
    passes).  Ready tasks go in coding order, older sub-GOP first.
    `subgops` holds the scheduled sub-GOPs not yet fully emitted, oldest
    first; `shadow` the shadow DPB after the last one's simulated inserts;
    `futures` the tasks by poc, while a sub-GOP in flight or a task not yet
    submitted may need them."""

    def __init__(self, enc, dev):
        self.enc, self.dev = enc, dev
        self.lock = threading.RLock()   # done-callbacks can re-enter
        self.futures = {}
        self.pending = []               # (sub-GOP, item) not yet submitted
        self.subgops = deque()
        self.shadow = None
        self.closed = False

    def schedule(self, sg):
        with self.lock:
            self.subgops.append(sg)
            self.pending.extend((sg, it) for it in sg.items)
        self._submit_ready()

    def _submit_ready(self):
        with self.lock:
            while not self.closed:
                ready = next((i for i, (sg, it) in enumerate(self.pending)
                              if all(q in self.futures
                                     and self.futures[q].done()
                                     for q in sg.deps[it[0]])), None)
                if ready is None:
                    return
                sg, it = self.pending.pop(ready)
                ahead = self.subgops.index(sg)
                if ahead:
                    self.enc.ahead_tasks += 1
                fu = self.enc._code_pool.submit(
                    self.enc._code_frame_task, self.dev, sg, it,
                    {q: self.futures[q] for q in sg.deps[it[0]]}, ahead,
                    trace.now())
                self.futures[it[0]] = fu
                fu.add_done_callback(lambda _f: self._submit_ready())

    def retire(self, sg):
        """The last frame of `sg`, the oldest sub-GOP, is emitted."""
        with self.lock:
            self.subgops.remove(sg)
            live = {q for s in self.subgops for q in s.lists}
            live.update(q for s, it in self.pending for q in s.deps[it[0]])
            self.futures = {q: f for q, f in self.futures.items()
                            if q in live}

    def close(self):
        """The stream ends or is closed: no callback submits again."""
        with self.lock:
            self.closed = True
            self.pending.clear()


class GopEncoder(Encoder):
    """Push/flush interface with RA GOP16 reordering when bframes >= 15;
    degenerates to streaming I/P when bframes == 0."""

    # every original that an in-flight dispatch, a collect recovery or a
    # ring_get may name: the sub-GOPs in flight, the one before them, and
    # its base
    _RING_FRAMES = (_SUBGOPS_IN_FLIGHT + 1) * 16 + 1

    def push_frame(self, y, u, v):
        """Push one display-order frame; returns the [(bs, rec, poc)] it
        completes, the recon backward-mapped under DRA."""
        return [(bs, self._dra_backward(rec), poc)
                for bs, rec, poc in self._push_frame(y, u, v)]

    def flush(self):
        """Code the frames still buffered; returns [(bs, rec, poc)] as
        push_frame does."""
        return [(bs, self._dra_backward(rec), poc)
                for bs, rec, poc in self._flush()]

    def _push_frame(self, y, u, v):
        p = self.p
        if p.bframes < 15 or p.keyint == 1:
            bs, rec = self._encode_frame_mapped(*self._pad_input(y, u, v))
            return [(bs, rec, self.poc - 1)]
        self._gop_in.append(self._pad_input(y, u, v))
        out = []
        if not self._first_done:
            self._poc_state.derive(True, 0, 4)
            bs, rec = self._encode_ra_frame(0, 0, 0, True, SLICE_I)
            self._first_done = True
            out.append((bs, rec, 0))
            return out
        if len(self._gop_in) == 17:   # frame 0 + 16 display frames buffered
            out.extend(self._encode_subgop())
        return out

    def _ra_order_derived(self, base, limit=None):
        """Coding order of one (possibly truncated) sub-GOP with the POC
        every conformant decoder will DERIVE from the tid sequence
        (xeve_poc_derivation) rather than the display-grid value:
        [(poc, disp_poc, tid, is_ref)].  For complete sub-GOPs poc ==
        disp_poc; for a truncated FIRST sub-GOP (bumping before poc 16
        exists) the derivation shifts — using the derived value keeps the
        encoder's DPB/ref-list/scaling state identical to the decoder's.
        (The reference encoder itself diverges from its own decoder
        derivation in this case, xeve_enc.c:1146-1160.)  Advances the
        derivation state: call exactly once per coded sub-GOP."""
        out = []
        for (disp, tid, is_ref) in picman_np.ra_gop16_order(base):
            if limit is not None and disp > limit:
                continue
            poc = self._poc_state.derive(False, tid, 4)
            out.append((poc, disp, tid, is_ref))
        return out

    def _flush(self):
        """Encode trailing frames as a truncated sub-GOP: the hierarchical
        coding order restricted to existing display pocs, coded under the
        decoder-derived POCs (_ra_order_derived).  With the device engine
        all remaining analyses are dispatched ahead (same overlap as the
        full-GOP pipeline)."""
        out = []
        base = self._gop_base
        n_left = len(self._gop_in) - 1
        limit = base + n_left
        order = self._ra_order_derived(base, limit)
        if self.analysis_engine == "device" and order and n_left > 0:
            dev = self._device()
            for (poc, disp, tid, is_ref) in order:
                dev.put_frame(poc, *self._gop_in[disp - base])
            if not dev.has_frame(base):
                dev.put_frame(base, *self._gop_in[0])
            handles = []
            shadow = self._shadow_dpb()
            for (poc, disp, tid, is_ref) in order:
                depth = 1 if disp % 16 == 0 else tid + 1
                qp = self._ra_qp(depth) if self.rc is None \
                    else self._qp_guess(SLICE_B)
                qp_y, qp_u, qp_v = self._qp_triplet(qp)
                ref0, ref0b, ref1, ref1b = self._predict_refs(shadow, dev,
                                                              poc, tid, base)
                hd = dev.dispatch_bg(poc, qp, qp_y, qp_u, qp_v, ref_poc=ref0,
                                     ref1_poc=ref1, ref0b_poc=ref0b,
                                     ref1b_poc=ref1b)
                handles.append((poc, disp, tid, is_ref, hd))
                picman_np.dpb_mark_and_insert(
                    shadow, {"poc": poc, "tid": tid, "ref": is_ref}, False)
            for (poc, disp, tid, is_ref, hd) in handles:
                an = dev.collect(hd)
                bs, rec = self._encode_ra_frame(poc, tid, disp - base, is_ref,
                                                SLICE_B, analysis_pre=an)
                out.append((bs, rec, disp))
        else:
            for (poc, disp, tid, is_ref) in order:
                bs, rec = self._encode_ra_frame(poc, tid, disp - base, is_ref,
                                                SLICE_B)
                out.append((bs, rec, disp))
        self._gop_in = self._gop_in[-1:]
        self._gop_base = limit
        return out

    def _encode_subgop(self):
        out = []
        base = self._gop_base
        for (poc, disp, tid, is_ref) in self._ra_order_derived(base):
            bs, rec = self._encode_ra_frame(poc, tid, disp - base, is_ref,
                                            SLICE_B)
            out.append((bs, rec, disp))
        self._gop_base = base + 16
        self._gop_in = self._gop_in[-1:]
        return out

    def _encode_stream(self, frames, ahead):
        """RA GOP16 stream encode, coding order (bs, rec, poc) per frame.
        With the device engine all 16 analyses of a sub-GOP are dispatched
        up front (ME against originals; hierarchical refs L0 = poc - lowbit,
        L1 = poc + lowbit) and the native coding pass overlaps them.
        Without RC, with aq_mode < 2 and more than one frame worker the
        sub-GOPs code on one frame-DAG C pass (_FrameDag): sub-GOP k+1 is
        scheduled once its frames are fed, before sub-GOP k is emitted,
        and the truncated tail codes after the last of them is emitted."""
        p = self.p
        if p.bframes < 15 or p.keyint == 1:
            yield from super()._encode_stream(frames, ahead)
            return
        if self.analysis_engine != "device":
            for fr in frames:
                yield from self._push_frame(*fr)
            yield from self._flush()
            return
        dev = self._device()
        dag = None
        if (self.rc is None and p.aq_mode < 2
                and self._frame_workers() > 1):
            if self._code_pool is None:
                self._code_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._frame_workers(),
                    thread_name_prefix="xt-frame")
            dag = _FrameDag(self, dev)
        try:
            for fr in frames:
                poc = self._gop_base + len(self._gop_in)
                with trace.span("api.feed", poc=poc):
                    self._gop_in.append(self._pad_input(*fr))
                    # stream the upload NOW (display poc == derived poc for
                    # full sub-GOPs) so the ~6 MB/frame device transfer
                    # overlaps the previous sub-GOP's native coding pass
                    # instead of stalling the first collects at the
                    # sub-GOP boundary
                    dev.put_frame(poc, *self._gop_in[-1])
                if not self._first_done:
                    self._poc_state.derive(True, 0, 4)
                    bs, rec = self._encode_ra_frame(0, 0, 0, True, SLICE_I)
                    self._first_done = True
                    yield bs, rec, 0
                    continue
                if len(self._gop_in) == 17:
                    yield from self._encode_subgop_pipelined(dev, dag)
            while dag is not None and dag.subgops:
                yield from self._code_subgop_parallel(dev, dag)
            yield from self._flush()
        finally:
            if dag is not None:
                dag.close()

    def _encode_subgop_pipelined(self, dev, dag=None):
        """Schedule the full sub-GOP at _gop_base: its 16 analyses
        dispatched ahead with refs predicted from the shadow DPB, and the
        coding-time ref lists frozen from it.  On the frame-DAG C pass
        (`dag`) the sub-GOP joins the ones in flight, keeping its own
        input frames, and the oldest are emitted until fewer than
        _SUBGOPS_IN_FLIGHT remain; otherwise it codes serially here."""
        base = self._gop_base
        frames = self._gop_in
        with trace.span("api.schedule", base=base):
            order = self._ra_order_derived(base)
            for (poc, disp, _tid, _is_ref) in order:
                dev.put_frame(poc, *frames[disp - base])
            handles = []
            # a sub-GOP scheduled while another is in flight starts from
            # the shadow DPB that the other's simulated inserts left
            shadow = dag.shadow if dag is not None and dag.subgops \
                else self._shadow_dpb()
            frozen_lists = {}
            for (poc, disp, tid, is_ref) in order:
                depth = 1 if disp % 16 == 0 else tid + 1
                qp = self._ra_qp(depth) if self.rc is None \
                    else self._qp_guess(SLICE_B)
                qp_y, qp_u, qp_v = self._qp_triplet(qp)
                # freeze the coding-time ref list STRUCTURE from the shadow
                # DPB (identical derivation to the _encode_ra_frame call);
                # the frame-parallel coding pass resolves the recon content
                # later
                l0, l1 = picman_np.build_ref_lists(
                    shadow, poc, tid, SLICE_B, SLICE_P, SLICE_B,
                    self.sps.max_num_ref_pics, -(10 ** 9))
                frozen_lists[poc] = ([q["poc"] for q in l0],
                                     [q["poc"] for q in l1])
                ref0, ref0b, ref1, ref1b = self._predict_refs(shadow, dev,
                                                              poc, tid, base)
                hd = dev.dispatch_bg(poc, qp, qp_y, qp_u, qp_v,
                                     ref_poc=ref0, ref1_poc=ref1,
                                     ref0b_poc=ref0b, ref1b_poc=ref1b)
                handles.append((poc, disp, tid, is_ref, hd, ref0, ref1, qp))
                picman_np.dpb_mark_and_insert(
                    shadow, {"poc": poc, "tid": tid, "ref": is_ref}, False)
            if dag is not None:
                dag.shadow = shadow
                self._gop_base = base + 16
                self._gop_in = frames[-1:]
                dag.schedule(_Subgop(
                    base, frames,
                    [(poc, disp, tid, is_ref, hd, qp) for
                     (poc, disp, tid, is_ref, hd, _r0, _r1, qp) in handles],
                    frozen_lists, {q["poc"]: q for q in self.dpb}))
        if dag is not None:
            while len(dag.subgops) >= _SUBGOPS_IN_FLIGHT:
                yield from self._code_subgop_parallel(dev, dag)
            return
        # cutree-lite (aq_mode 2): collect the whole sub-GOP's analyses up
        # front and hand each reference frame the MV fields of the frames
        # predicting from it (xeve_fcst.c:629 blk_tree analog)
        collected = {}
        deps: dict[int, list] = {}
        if self.p.aq_mode >= 2:
            for (poc, disp, tid, is_ref, hd, r0, r1, _qp) in handles:
                an = collected.setdefault(poc, dev.collect(hd))
                if r0 is not None and getattr(an, "mv", None):
                    deps.setdefault(r0, []).append(an.mv[4])
                if r1 is not None and getattr(an, "mv1", None):
                    deps.setdefault(r1, []).append(an.mv1[4])
        for (poc, disp, tid, is_ref, hd, _r0, _r1, _qp) in handles:
            an = collected.get(poc) or dev.collect(hd)
            aq = None
            if self.p.aq_mode >= 2:
                y, u, v = self._gop_in[disp - base]
                aq = self._aq_map(y, u, v, extra_mv_fields=deps.get(poc))
            bs, rec = self._encode_ra_frame(poc, tid, disp - base, is_ref,
                                            SLICE_B, analysis_pre=an,
                                            aq_map=aq)
            yield bs, rec, disp
        self._gop_base = base + 16
        self._gop_in = self._gop_in[-1:]

    def _code_subgop_parallel(self, dev, dag):
        """Emit the oldest sub-GOP scheduled on the frame-DAG C pass:
        each frame, in coding order, once its task is done.  Emission
        (headers, DPB, stats) stays serial on the main thread, keeping the
        bitstream bit-identical to the serial path."""
        p = self.p
        sg = dag.subgops[0]
        for i, (poc, disp, tid, _is_ref, _hd, qp) in enumerate(sg.items):
            with trace.span("api.emit", poc=disp):
                with trace.span("api.wait", poc=disp):
                    while True:
                        with dag.lock:
                            fu = dag.futures.get(poc)
                        if fu is not None:
                            break
                        time.sleep(0.0005)
                    r = fu.result()
                sh = SliceHeader(
                    slice_type=SLICE_B, qp=qp, qp_u_offset=p.qp_cb_offset,
                    qp_v_offset=p.qp_cr_offset,
                    deblocking_filter_on=1 if p.use_deblock else 0)
                self._sh_tiles(sh, r["tile_lens"])
                bw = BitWriter()
                NalHeader(NUT_NONIDR, tid).write(bw)
                sh.write(bw, NUT_NONIDR, self.sps, self.pps)
                payload = bw.get_bytes() + r["payload"]
                payload += self._cabac_zero_words(r["bin_count"], len(payload))
                out = wrap_nal(payload)
                rec_y, rec_u, rec_v = r["rec"]
                if p.use_pic_sign:
                    out += self._signature_sei(rec_y, rec_u, rec_v)
                self._rc_update(SLICE_B, qp, len(out))
                self._prev_orig_y = r["y"]
                picman_np.dpb_mark_and_insert(self.dpb, r["entry"], False)
                self.pic_cnt += 1
                self.last_stat = Stat(
                    bytes=len(out), nalu_type=NUT_NONIDR, slice_type=SLICE_B,
                    qp=qp, poc=poc, tid=tid, ref_pocs_l0=list(r["l0p"]),
                    ref_pocs_l1=list(r["l1p"]))
                if i == len(sg.items) - 1:
                    dag.retire(sg)
            yield out, (rec_y, rec_u, rec_v), disp

    def _code_frame_task(self, dev, sg, item, refs, ahead, t_submit):
        """One frame's closed-loop C pass on a frame worker: its
        references are in the DPB snapshot of its sub-GOP or in `refs`,
        the done tasks of the frames it depends on."""
        poc, disp, tid, is_ref, hd, qp = item
        with trace.span("frame.task", poc=disp, t_submit=t_submit,
                        deps=sg.deps[poc], base=sg.base, ahead=ahead):
            y, u, v = sg.frames[disp - sg.base]
            y = np.asarray(y, np.int32)
            u = np.asarray(u, np.int32)
            v = np.asarray(v, np.int32)

            def resolve(q):
                if q in sg.snap:
                    return sg.snap[q]
                return refs[q].result()["entry"]

            l0p, l1p = sg.lists[poc]
            refp = [resolve(q) for q in l0p]
            refp1 = [resolve(q) for q in l1p]
            an = dev.collect(hd)
            if (refp1 and getattr(an, "mv1", None) is None
                    and getattr(an, "mv", None) is not None):
                an.mv1 = {lg: m for lg, m in an.mv.items()}
            aq_map = self._aq_map(y, u, v)
            payload, bin_count, rec_y, rec_u, rec_v, map_mv, tile_lens = \
                self._code_slice(SLICE_B, poc, qp, y, u, v, an, refp,
                                 refp1, aq_map=aq_map)
            entry = {
                "poc": poc, "tid": tid, "ref": is_ref,
                "list0_poc": refp[0]["poc"] if refp else poc,
                "y_pad": mc_np.pad_picture(np.asarray(rec_y, np.int32),
                                           PAD_L),
                "u_pad": mc_np.pad_picture(np.asarray(rec_u, np.int32),
                                           PAD_L // 2),
                "v_pad": mc_np.pad_picture(np.asarray(rec_v, np.int32),
                                           PAD_L // 2),
                "map_mv": map_mv,
            }
            return {"payload": payload, "bin_count": bin_count,
                    "rec": (rec_y, rec_u, rec_v), "entry": entry,
                    "tile_lens": tile_lens, "y": y,
                    "l0p": l0p, "l1p": l1p}

    def _shadow_dpb(self):
        """Lightweight copy of the DPB metadata for dispatch-ahead ref-list
        prediction (mirrors what build_ref_lists will see at coding time)."""
        return [{"poc": q["poc"], "tid": q["tid"],
                 "ref": q.get("ref", True)} for q in self.dpb]

    def _predict_refs(self, shadow, dev, poc, tid, base):
        """Predict (ref0, ref0b, ref1, ref1b) pocs for the dispatch-ahead
        analysis of a RA B frame, from the simulated DPB state — identical
        list construction to the coding-time build_ref_lists call — among
        the newest _ANALYSIS_REF_WINDOW originals fed."""
        l0, l1 = picman_np.build_ref_lists(
            shadow, poc, tid, SLICE_B, SLICE_P, SLICE_B,
            self.sps.max_num_ref_pics, self.last_intra_poc)
        recent = set(sorted(dev.host_ring)[-_ANALYSIS_REF_WINDOW:])
        p0 = [q["poc"] for q in l0 if q["poc"] in recent]
        p1 = [q["poc"] for q in l1 if q["poc"] in recent]
        ref0 = p0[0] if p0 else (base if base in recent else None)
        ref0b = p0[1] if len(p0) > 1 else None
        ref1 = p1[0] if p1 else None
        ref1b = p1[1] if len(p1) > 1 else None
        return ref0, ref0b, ref1, ref1b

    def encode_stream_meshed(self, frames, mesh):
        """RA GOP16 stream encode with each sub-GOP's B-frame analyses
        spread one per device over `mesh` (parallel.mesh.make_mesh, a list
        of torch devices).  Each frame's analysis is the single-device
        fused graph, so the stream equals encode_stream's for any mesh.
        Yields (bs, rec, poc) in coding order; the recon stays in the
        mapped domain under DRA, as in the JAX package."""
        p = self.p
        assert p.bframes >= 15 and p.keyint != 1, "meshed path is RA GOP16"
        assert p.ref_pics == 1, \
            "meshed batch analysis carries L0/L1 refi-0 planes only"
        dev = self._device()
        for fr in frames:
            self._gop_in.append(self._pad_input(*fr))
            if not self._first_done:
                self._poc_state.derive(True, 0, 4)
                bs, rec = self._encode_ra_frame(0, 0, 0, True, SLICE_I)
                self._first_done = True
                yield bs, rec, 0
                continue
            if len(self._gop_in) == 17:
                yield from self._encode_subgop_meshed(dev, mesh)
        yield from self._flush()

    def _encode_subgop_meshed(self, dev, mesh):
        """One full sub-GOP: the anchor (no L1 ref) through the analyzer's
        own dispatch, the B frames as one batch over the mesh, padded to a
        multiple of its size by repeating the last item."""
        base = self._gop_base
        # full sub-GOP only: derived poc == display poc; the call still
        # advances the derivation state for a later truncated flush
        order = [(poc, tid, is_ref)
                 for (poc, _disp, tid, is_ref) in self._ra_order_derived(base)]
        for (poc, _tid, _is_ref) in order:
            dev.put_frame(poc, *self._gop_in[poc - base])
        handles = {}
        b_items = []          # (poc, prms, prm3, ref0, ref1)
        for (poc, tid, is_ref) in order:
            depth = 1 if poc % 16 == 0 else tid + 1
            qp = self._ra_qp(depth) if self.rc is None \
                else self._qp_guess(SLICE_B)
            qp_y, qp_u, qp_v = self._qp_triplet(qp)
            low = poc & -poc
            ref0 = poc - low if poc % 16 else poc - 16
            ref1 = poc + low if poc % 16 else None
            if ref1 is not None and (ref1 > base + 16
                                     or not dev.has_frame(ref1)):
                ref1 = None
            if ref1 is None:
                handles[poc] = dev.dispatch_bg(poc, qp, qp_y, qp_u, qp_v,
                                               ref_poc=ref0)
                continue
            b_items.append((poc, *dev.params(qp, qp_y, qp_u, qp_v), ref0,
                            ref1))
        if b_items:
            n = len(b_items)
            n_pad = -(-n // len(mesh)) * len(mesh)
            cols = [[] for _ in range(11)]
            for i in list(range(n)) + [n - 1] * (n_pad - n):
                poc, prms, prm3, r0, r1 = b_items[i]
                planes = (*dev.ring_get(poc), *dev.ring_get(r0),
                          *dev.ring_get(r1), prms, prm3)
                for c, a in zip(cols, planes):
                    c.append(a)
            vecs = meshed_subgop_analysis(
                mesh, bd=self.p.codec_bit_depth,
                search_range=self.p.search_range, min_log2=dev.min_log2,
                max_log2=dev.max_log2)(*(torch.stack(c) for c in cols))
            for (poc, _p, _p3, _r0, _r1), vec in zip(b_items, vecs):
                handles[poc] = _Handle(_DeviceVec(vec), "B", self.p.h_aligned,
                                       self.p.w_aligned, dev.min_log2,
                                       dev.max_log2,
                                       planes=(True, False, True, False,
                                               True))
        for (poc, tid, is_ref) in order:
            an = dev.collect(handles[poc])
            bs, rec = self._encode_ra_frame(poc, tid, poc - base, is_ref,
                                            SLICE_B, analysis_pre=an)
            yield bs, rec, poc
        self._gop_base = base + 16
        self._gop_in = self._gop_in[-1:]

    def _ra_qp(self, depth):
        off_layer, off_model, scale_model = QP_ADAPT_RA16[depth]
        qp = self.p.qp + off_layer
        dqp = qp * scale_model + off_model + 0.5
        qp += int(np.floor(np.clip(dqp, 0.0, 3.0)))
        return int(np.clip(qp, 0, 51))

    def _encode_ra_frame(self, poc, tid, disp_idx, is_ref, slice_type,
                         analysis_pre=None, aq_map=None):
        p = self.p
        bd = p.codec_bit_depth
        y, u, v = self._gop_in[disp_idx]
        y = np.asarray(y, np.int32)
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        if slice_type == SLICE_I:
            depth = 0
            self.last_intra_poc = poc
        elif poc % 16 == 0:
            depth = 1
        else:
            depth = tid + 1
        qp = self._rc_qp(slice_type, depth, y,
                         cpx=getattr(analysis_pre, "rc_cost", None))
        if qp is None:
            qp = self._ra_qp(depth) if p.bframes >= 15 else self._slice_qp(slice_type)
        qp_y, qp_u, qp_v = self._qp_triplet(qp)

        refp, refp1 = picman_np.build_ref_lists(
            self.dpb, poc, tid, SLICE_B, SLICE_P, slice_type,
            self.sps.max_num_ref_pics, -(10 ** 9))

        nut = NUT_IDR if poc == 0 and self.pic_cnt == 0 else NUT_NONIDR
        out = b""
        if nut == NUT_IDR:
            out += self._headers()

        if analysis_pre is not None:
            an = analysis_pre
        elif self.analysis_engine == "device":
            dev = self._device()
            if not dev.has_frame(poc):
                dev.put_frame(poc, y, u, v)
            ref_poc = refp[0]["poc"] if (slice_type != SLICE_I and refp) \
                else None
            ref1_poc = refp1[0]["poc"] if (slice_type == SLICE_B and refp1) \
                else None
            ref0b_poc = refp[1]["poc"] if (slice_type != SLICE_I
                                           and len(refp) > 1) else None
            ref1b_poc = refp1[1]["poc"] if (slice_type == SLICE_B
                                            and len(refp1) > 1) else None
            an = dev.collect(dev.dispatch(poc, qp, qp_y, qp_u, qp_v,
                                          ref_poc=ref_poc,
                                          ref1_poc=ref1_poc,
                                          ref0b_poc=ref0b_poc,
                                          ref1b_poc=ref1b_poc))
        elif slice_type == SLICE_I:
            an = self._analyze_intra(y, u, v, qp)
        else:
            an = self._analyze_inter(y, u, v, refp, qp, qp_y, qp_u, qp_v, bd,
                                     refp1=refp1 if slice_type == SLICE_B else None,
                                     search_range=p.search_range)
        if (slice_type == SLICE_B and refp1
                and getattr(an, "mv1", None) is None
                and getattr(an, "mv", None) is not None):
            an.mv1 = {lg: m for lg, m in an.mv.items()}

        if aq_map is None:
            aq_map = self._aq_map(y, u, v)
        slice_payload, bin_count, rec_y, rec_u, rec_v, map_mv, tile_lens = \
            self._code_slice(slice_type, poc, qp, y, u, v, an, refp, refp1,
                             aq_map=aq_map)
        sh = SliceHeader(slice_type=slice_type, qp=qp,
                         qp_u_offset=p.qp_cb_offset,
                         qp_v_offset=p.qp_cr_offset,
                         deblocking_filter_on=1 if p.use_deblock else 0)
        self._sh_tiles(sh, tile_lens)
        bw = BitWriter()
        NalHeader(nut, tid).write(bw)
        sh.write(bw, nut, self.sps, self.pps)
        payload = bw.get_bytes() + slice_payload
        payload += self._cabac_zero_words(bin_count, len(payload))
        out += wrap_nal(payload)
        if p.use_pic_sign:
            out += self._signature_sei(rec_y, rec_u, rec_v)
        self._rc_update(slice_type, qp, len(out))
        self._prev_orig_y = y
        self._dpb_push(rec_y, rec_u, rec_v, map_mv, poc=poc, tid=tid,
                       is_ref=is_ref, is_idr=(nut == NUT_IDR),
                       list0_poc=refp[0]["poc"] if refp else poc)
        self.pic_cnt += 1
        self._fill_stat(len(out), nut, slice_type, qp, poc, tid,
                        refp=refp, refp1=refp1, rec=(rec_y, rec_u, rec_v))
        return out, (rec_y, rec_u, rec_v)
