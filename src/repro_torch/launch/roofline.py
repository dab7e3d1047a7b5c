"""Roofline terms of a dry-run record on one NVIDIA H100 (no card needed).

The port of ``repro.launch.roofline``, with the H100's figures in place
of the TPU's:

  compute    = FLOPs / (chips · peak FLOP/s of the step's dtype)
  memory     = bytes / (chips · 3.35e12 B/s HBM3)
  collective = collective bytes / (chips · 450e9 B/s NVLink per direction)

The FLOPs and bytes are the dry run's own counts (``launch/dryrun.py``):
``FlopCounterMode`` over the step on the ``meta`` device, the operand and
result bytes of every aten op, and attention's work from
:func:`attention_work` (what K5/K6 compute on the card).  The reference
parses collective bytes out of XLA's optimized HLO; the port has no
compiled program, so the dry run counts them from the placements
(``dryrun.collective_terms``).  ``MODEL_FLOPS`` = 6·N·D (train) /
2·N·D (inference) gives the useful-compute ratio.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# NVIDIA H100 SXM5 80GB, per GPU (NVIDIA H100 Tensor Core GPU datasheet,
# dense rates, without sparsity, at the 700 W power limit)
PEAK_FLOPS = {
    "float32": 67e12,        # FP32 outside the tensor cores
    "tfloat32": 494.7e12,    # TF32 tensor core
    "bfloat16": 989.4e12,    # BF16 tensor core
}
HBM_BW = 3.35e12             # HBM3, B/s (datasheet)
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s total, 450 GB/s a direction
HBM_BYTES = 80e9             # HBM3 capacity (datasheet)


def model_flops(cfg, n_params_total: int, n_params_active: Optional[int],
                tokens: int, *, train: bool) -> float:
    """6·N·D (train) / 2·N·D (inference forward) per processed token."""
    n = n_params_active if n_params_active else n_params_total
    mult = 6.0 if train else 2.0
    return mult * n * tokens


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   coll_bytes: float, chips: int = 1,
                   dtype: str = "float32") -> Dict[str, float]:
    """Seconds each bound sets, and which dominates.  Inputs are per
    device (the dry run divides by the chips itself); ``chips`` is kept
    for callers that pass global quantities.  ``dtype`` picks the peak:
    the port's zoo computes in float32 with TF32 off
    (``common/device.py``), so a float32 step is held to 67 TFLOP/s."""
    compute = hlo_flops / (chips * PEAK_FLOPS[dtype])
    memory = hlo_bytes / (chips * HBM_BW)
    collective = coll_bytes / (chips * NVLINK_BW)
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant}


def extrapolate_layers(v_a: float, v_b: float, n_macro: int,
                       a: int = 2) -> float:
    """Cost of the full depth from a-macro and (a+1)-macro counts:
    v(n) = v_a + (n-a)·(v_b-v_a) (the reference's arithmetic; the port
    counts the full depth directly and keeps this for its schema)."""
    return v_a + (n_macro - a) * (v_b - v_a)


def allowed_pairs(sq: int, sk: int, causal: bool, window: int,
                  kv_len: Optional[int] = None) -> int:
    """(query, key) pairs one (batch, head) of attention computes: key j
    of query i is allowed iff j < kv_len, j <= i when causal, and
    j > i - window when windowed — the mask K5/K6 apply."""
    kv_len = sk if kv_len is None else kv_len
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, kv_len - 1) if causal else \
        np.full_like(i, kv_len - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    return int((hi - lo + 1).clip(min=0).sum())


def attention_work(b: int, sq: int, sk: int, h: int, hkv: int, hd: int,
                   causal: bool, window: int, kv_len: Optional[int] = None,
                   esz: int = 4) -> Dict[str, tuple]:
    """``{"fwd": (FLOPs, bytes), "bwd": (FLOPs, bytes)}`` of flash
    attention over q (b, sq, h, hd) and k/v (b, sk, hkv, hd): 2 products
    of ``hd`` MACs a pair forward (QK^T, PV), 5 backward (S again, dV,
    dP, dQ, dK); each input read once and each output written once
    (forward: q, k, v in, o and the fp32 logsumexp out; backward: q, k,
    v, o, dO and two fp32 rows in, dQ, dK, dV out)."""
    pairs = b * h * allowed_pairs(sq, sk, causal, window, kv_len)
    q_n, k_n = b * sq * h * hd, b * sk * hkv * hd
    return {"fwd": (4 * hd * pairs,
                    esz * (2 * q_n + 2 * k_n) + 4 * b * h * sq),
            "bwd": (10 * hd * pairs,
                    esz * (4 * q_n + 4 * k_n) + 8 * b * h * sq)}


def cost_analysis_terms(counts) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of a dry-run count (``dryrun.StepCounts``),
    the keys of the reference's ``cost_analysis`` reading."""
    return {"flops": float(counts.flops), "bytes": float(counts.bytes)}


def memory_analysis_terms(counts) -> Dict[str, float]:
    """The reference's ``memory_analysis`` keys from a dry-run count.

    ``temp_size_in_bytes`` is the peak of the storage the step allocated
    and still held (its new outputs included), so the peak is arguments
    plus temps; ``output_size_in_bytes`` and ``alias_size_in_bytes`` (the
    outputs that are argument storage written in place) are reported
    beside it.  Nothing is compiled: ``generated_code_size_in_bytes`` is
    0."""
    out = {"argument_size_in_bytes": float(counts.argument_bytes),
           "output_size_in_bytes": float(counts.output_bytes),
           "temp_size_in_bytes": float(counts.temp_bytes),
           "alias_size_in_bytes": float(counts.alias_bytes),
           "generated_code_size_in_bytes": 0.0}
    out["peak_bytes"] = (out["argument_size_in_bytes"]
                         + out["temp_size_in_bytes"])
    return out
