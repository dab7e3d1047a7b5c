"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert) vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family card]

Maverick interleaves MoE every other block (interleave=2); dense blocks and
the always-on shared expert use d_ff=16384; routed experts d_ff=8192 (the
assigned figure).  Totals ≈400B params, ≈17B active — matching the card.
"Early fusion" refers to the multimodal frontend, which is out of scope for
the assigned text backbone (cf. DESIGN.md §7)."""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,                  # dense-block / shared-expert width
    vocab=202048,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    rope_theta=500_000.0,
    moe=MoECfg(num_experts=128, top_k=1, expert_d_ff=8192,
               interleave=2, shared_d_ff=16384),
    fl_clients_single_pod=1,     # 400B: one silo per pod (DESIGN.md §5)
))
