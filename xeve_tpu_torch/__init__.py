"""PyTorch/CUDA port of the xeve_tpu encoder.

The JAX package `xeve_tpu` stays the reference; this package stands
alone and imports neither JAX nor anything of `xeve_tpu`.  The host
modules it needs are its own copies, at the same module paths as their
originals (constants, params, hls, io/bits, io/video, state, entropy/sbac,
the numpy oracles enc/analysis_np, enc/analysis_inter_np and
enc/analysis_main_np, the numpy coding passes enc/frame_pass and
enc/main_intra_frame, rate control enc/rc, enc/syntax, the native C
coding pass native/ with its ctypes bindings enc/frame_native and
enc/intra_frame_native, enc/aq, ops/mc_np, ops/picman_np and the
conformance decoder dec/decoder with its ops); tests hold each copy to
its original.  The analysis (enc/*_torch.py, enc/device_analyzer.py) is
PyTorch, and the one hand-written kernel (csrc/me_full_search.cu) is
CUDA for Hopper.  The CLIs: `python -m xeve_tpu_torch.app` (encoder) and
`python -m xeve_tpu_torch.dec_app` (decoder).
"""
