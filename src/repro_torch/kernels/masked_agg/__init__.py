"""Fused masked FedAvg: CUDA kernel (csrc/masked_agg.cu), wrapper (ops.py), plain version (ref.py)."""
