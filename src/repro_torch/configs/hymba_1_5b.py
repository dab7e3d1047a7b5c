"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention+mamba heads within each
block, fused by per-branch norm + mean.  [arXiv:2411.13676]

Hymba's meta-tokens and cross-layer KV sharing are left out, as in the
reference; sliding-window attention (window 1,024) on all but every 8th
layer, per the paper's mostly-SWA layout."""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    source="arXiv:2411.13676",
    sliding_window=1024,
    global_every=8,
    ssm=SSMCfg(state_dim=16, conv_width=4, expand=2),
    fl_clients_single_pod=16,
))
