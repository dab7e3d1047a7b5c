"""Stochastic-rounding quantize-pack: CUDA kernel (csrc/quantize_pack.cu), wrapper (ops.py), plain version (ref.py)."""
