"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family card]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    source="hf:Qwen/Qwen2.5-0.5B",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fl_clients_single_pod=4,
))
