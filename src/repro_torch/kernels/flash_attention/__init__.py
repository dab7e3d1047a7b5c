"""Flash attention forward and backward: CUDA kernels (csrc/flash_attention.cu), autograd wrapper (ops.py), plain versions (ref.py)."""
