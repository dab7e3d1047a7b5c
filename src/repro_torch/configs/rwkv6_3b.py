"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892]

Attention heads are re-purposed as WKV heads (head_dim 64 per the paper)."""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                  # wkv heads, head_dim 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    source="arXiv:2404.05892",
    ssm=SSMCfg(state_dim=64),    # wkv state is head_dim x head_dim
    fl_clients_single_pod=16,
))
