"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2.  [arXiv:2404.16821]

The port's copy of the reference's config.  The InternViT-6B vision
tower is a stub: the model takes 1,024 patch embeddings of width
``transformer.vit_width`` (1,024), projects them to d_model and puts
them before the text tokens.  This config is the InternLM2-20B style
language backbone."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    source="arXiv:2404.16821",
    rope_theta=1_000_000.0,
    n_patches=1024,
    fl_clients_single_pod=4,
))
