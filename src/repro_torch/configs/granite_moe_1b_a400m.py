"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    moe=MoECfg(num_experts=32, top_k=8, expert_d_ff=512, interleave=1),
    tie_embeddings=True,
    fl_clients_single_pod=16,
))
