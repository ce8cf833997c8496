"""Quantixar ported to PyTorch and hand-written CUDA kernels for an NVIDIA
H100 (sm_90a).  The JAX package ``repro`` beside it is the reference; this
package imports nothing of it and never imports ``jax``."""
