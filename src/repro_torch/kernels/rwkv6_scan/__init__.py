"""Chunked RWKV-6 WKV scan (K7): CUDA kernel (csrc/rwkv6_scan.cu), wrappers (ops.py), plain versions (ref.py)."""
