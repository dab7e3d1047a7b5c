"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32 i.e. MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b scaled per assignment]
StableLM-2 flavour: LayerNorm, partial rotary (25%), no qkv bias."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b",
    norm="layernorm",
    rope_pct=0.25,
    fl_clients_single_pod=16,
))
