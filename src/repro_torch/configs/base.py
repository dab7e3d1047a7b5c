"""Architecture config system of the port: its own copy of the
reference's ``configs/base.py`` (the port imports nothing of ``repro``).

Every architecture the port registers gets one module in this package
defining a module-level ``CONFIG: ArchConfig``.  Configs are registered
by name and selectable from the serving and training launchers via
``--arch <id>``.  The port registers the dense family's qwen3-1.7b,
gemma3-12b, qwen2.5-14b (QKV bias) and stablelm-3b (LayerNorm, 25%
rotary), the moe family's granite-moe-1b-a400m and
llama4-maverick-400b-a17b, the ssm family's rwkv6-3b, the hybrid
family's hymba-1.5b, the audio family's whisper-medium and the vlm
family's internvl2-26b (its vision tower a stub that feeds
``n_patches`` patch embeddings).

``ArchConfig.reduced()`` returns the smoke-test variant (≤2 layers,
d_model ≤ 512, ≤4 experts) of the same family, used by tests and CPU
runs.  The dataclass matches the reference's field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_d_ff: int
    # every `interleave`-th block is MoE (1 = all blocks MoE, 2 = alternate)
    interleave: int = 1
    # llama4-style always-on shared expert width (0 = none)
    shared_d_ff: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # token-drop capacity factor; reduced() raises it to dropless so the
    # prefill+decode path is bit-consistent with the full forward
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 16          # N
    conv_width: int = 4
    expand: int = 2              # d_inner = expand * head width share
    dt_rank: int = 0             # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    source: str = ""             # citation (hf:/arXiv:)

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0        # stablelm-2 uses 25% partial rotary
    # sliding window: 0 = full attention everywhere
    sliding_window: int = 0
    # gemma3: every `global_every`-th layer is global, the rest sliding-window
    global_every: int = 0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    glu: bool = True             # gated MLP (False -> 2-matrix MLP, whisper)
    tie_embeddings: bool = False
    max_position: int = 131_072

    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None

    # enc-dec (whisper): encoder layer count; 0 = decoder-only
    n_enc_layers: int = 0
    enc_seq: int = 0             # frame-embedding length fed by the stub frontend
    # vlm: number of patch-embedding tokens fed by the stub frontend
    n_patches: int = 0

    # FL topology on the production pod (see DESIGN.md §5)
    fl_clients_single_pod: int = 16

    param_dtype: str = "float32"      # smoke/training dtype on CPU
    lowering_dtype: str = "bfloat16"  # dry-run dtype (TPU target)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head table rows: vocab rounded up to a multiple of
        128 so the vocab dim shards on the 16-wide model axis and stays
        MXU-aligned (whisper 51865, internvl2 92553, granite 49155 and
        hymba 32001 are odd).  Pad ids are ordinary never-observed
        classes (training from scratch) — DESIGN.md §7."""
        return -(-self.vocab // 128) * 128

    @property
    def subquadratic(self) -> bool:
        """True if long_500k decode is admissible (DESIGN.md §7)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 or self.global_every > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper has a decoder)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/flavour, toy sizes."""
        kw = dict(
            n_layers=2,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            max_position=4096,
            fl_clients_single_pod=4,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                expert_d_ff=64, shared_d_ff=64 if self.moe.shared_d_ff else 0,
                capacity_factor=8.0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=8)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.n_patches:
            kw["n_patches"] = 8
        if self.global_every:
            kw["global_every"] = 2  # keep the local:global interleave alive
            kw["n_layers"] = 4
        if self.sliding_window:
            kw["sliding_window"] = 64
        return self.replace(**kw)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded():
    # import side-effect registration of every config module the port has
    from . import (  # noqa: F401
        gemma3_12b, granite_moe_1b_a400m, hymba_1_5b, internvl2_26b,
        llama4_maverick_400b_a17b, qwen2_5_14b, qwen3_1_7b, rwkv6_3b,
        stablelm_3b, whisper_medium)
