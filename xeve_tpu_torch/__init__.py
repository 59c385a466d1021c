"""PyTorch/CUDA port of the xeve_tpu encoder's device analysis.

The JAX package `xeve_tpu` stays the reference.  This package reuses its
host modules (parameters, HLS, picture management, the native C coding
pass and the numpy oracles) by import and never imports JAX.
"""
