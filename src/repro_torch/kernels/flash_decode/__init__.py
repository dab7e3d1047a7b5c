"""Flash decode, paged (K3) and dense (K4): CUDA kernel (csrc/flash_decode_paged.cu), wrappers (ops.py), plain versions (ref.py)."""
