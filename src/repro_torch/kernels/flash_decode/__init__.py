"""Paged flash decode: CUDA kernel (csrc/flash_decode_paged.cu), wrapper (ops.py), plain version (ref.py)."""
