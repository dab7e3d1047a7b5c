"""The four assigned input shapes + per-arch applicability (DESIGN.md §7).

The reference's ``launch/shapes.py``, copied: the port's launchers and
``chip_smoke.py`` take their sequence lengths from here."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs admissible for long_500k (sub-quadratic decode; DESIGN.md §7)
LONG_CONTEXT_OK = ("rwkv6-3b", "hymba-1.5b", "gemma3-12b")


def shape_applicable(arch_name: str, cfg, shape: InputShape
                     ) -> Tuple[bool, str]:
    if shape.name == "long_500k":
        if arch_name in LONG_CONTEXT_OK:
            return True, ""
        return False, ("full-attention arch: 500k dense KV decode skipped "
                       "(DESIGN.md §7)")
    return True, ""


def list_pairs():
    """All (arch, shape) pairs with applicability annotations."""
    from ..configs.base import list_configs, get_config
    out = []
    for a in list_configs():
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(a, cfg, s)
            out.append((a, s.name, ok, why))
    return out
