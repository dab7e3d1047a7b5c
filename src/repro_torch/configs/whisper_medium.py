"""whisper-medium [audio] — 24L d_model=1024 16H d_ff=4096 vocab=51865 —
encoder-decoder, conv frontend STUBBED.  [arXiv:2212.04356]

The port's copy of ``repro.configs.whisper_medium``: 1,500 precomputed
frame embeddings (post-conv, post mel-spectrogram) per sequence are the
encoder's input.  LayerNorm, GELU, a 2-matrix MLP with biases, learned
positions (no RoPE), tied decoder embeddings."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                 # decoder layers
    n_enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    source="arXiv:2212.04356",
    norm="layernorm",
    act="gelu",
    glu=False,
    rope_pct=0.0,                # learned absolute positions
    tie_embeddings=True,
    max_position=448,
    fl_clients_single_pod=16,
))
