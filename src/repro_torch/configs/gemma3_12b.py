"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt family card]

Sliding window 1024 on local layers; every 6th layer is global.  head_dim
is 256 (gemma3 decouples it from d_model/n_heads)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    source="hf:google/gemma-3-1b-pt",
    qk_norm=True,
    sliding_window=1024,
    global_every=6,              # L L L L L G pattern
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_position=131_072,
    fl_clients_single_pod=4,
))
