"""Partition-spec rules: map parameter paths to per-dim mesh axes.

The port of ``repro.sharding.rules``.  Three intra-client layouts
(DESIGN.md §5):

  * ``tp``        — tensor parallel over the ``model`` axis only; params
                    otherwise replicated.  Used for ≤3B archs (one client
                    per data-axis group).
  * ``fsdp_tp``   — tensor parallel over ``model`` + fully-sharded params
                    over ``data`` on a second dimension.  12–26B archs.
  * ``replicated``— everything replicated (CPU tests / tiny models).

The rule engine is path-pattern based: the FIRST matching rule wins.  A
rule maps a regex over the parameter path to a tuple of logical axis
names per tensor dimension; logical axes are then resolved to mesh axes
per layout.  Unmatched params are replicated.  The tables are the
reference's, copied.

A spec is a tuple with one entry per tensor dim: a mesh axis name, a
tuple of names (the dim split over several axes, major to minor), or
None — what the reference's ``PartitionSpec`` holds.  Only
``mesh.shape`` is read: a ``torch.distributed.device_mesh.DeviceMesh``
(its ``mesh_dim_names`` name the dims) or any stand-in whose ``shape``
maps axis names to sizes.  :func:`placements` turns a spec into DTensor
placements, one per mesh dim.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..common.pytree import Tree

Spec = Tuple[object, ...]

# ---------------------------------------------------------------------------
# logical axes
#   "embed"   : d_model dim            -> never sharded (activations flow)
#   "vocab"   : vocabulary dim         -> model axis (TP)
#   "heads"   : attention heads dim    -> model axis (TP)
#   "kv_heads": kv heads dim           -> model axis if divisible else None
#   "ff"      : mlp hidden dim         -> model axis (TP)
#   "expert"  : MoE expert dim         -> model axis (expert parallel)
#   "fsdp"    : dim to shard over data in fsdp_tp layout
#   None      : replicated dim
# ---------------------------------------------------------------------------

# (path regex, logical spec per dim). Dims beyond the spec are replicated.
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # --- stacked transformer blocks: leading dim is the layer/macro dim ---
    # attention projections (L, d_model, heads, head_dim) / (L, heads, head_dim, d_model)
    # "hd" is the fallback TP dim: it receives the model axis only when the
    # heads dim is not divisible (rwkv 40H, hymba 25H) or in the *_hd decode
    # layouts (kv-heads < mesh width; cache must be hd-sharded).
    (r".*/(attn|xattn)/wq$",      (None, "fsdp", "heads", "hd")),
    (r".*/(attn|xattn)/wk$",      (None, "fsdp", "kv_heads", "hd")),
    (r".*/(attn|xattn)/wv$",      (None, "fsdp", "kv_heads", "hd")),
    (r".*/(attn|xattn)/wo$",      (None, "heads", "hd", "fsdp")),
    (r".*/(attn|xattn)/(bq|q_norm)$", (None, "heads", "hd")),
    (r".*/(attn|xattn)/(bk|bv|k_norm)$", (None, "kv_heads", "hd")),
    (r".*/(attn|xattn)/bo$",      (None, None)),
    # mlp (L, d_model, d_ff) and (L, d_ff, d_model)
    (r".*/mlp/w(_gate|_up|1|3)$", (None, "fsdp", "ff")),
    (r".*/mlp/w(_down|2)$",       (None, "ff", "fsdp")),
    (r".*/mlp/b(1|3|_gate|_up)$", (None, "ff")),
    (r".*/mlp/b(2|_down)$",       (None, None)),
    # MoE experts (L, E, d_model, d_ff) / (L, E, d_ff, d_model); router (L, d_model, E)
    (r".*/moe/w(_gate|_up)$",  (None, "expert", "fsdp", "ff_inner")),
    (r".*/moe/w_down$",        (None, "expert", "ff_inner", "fsdp")),
    (r".*/moe/router$",        (None, "fsdp", None)),
    (r".*/shared/w(_gate|_up)$", (None, "fsdp", "ff")),
    (r".*/shared/w_down$",       (None, "ff", "fsdp")),
    # rwkv6 time-mix / channel-mix (L, H, dk, dv) and friends
    (r".*/wkv/(wr|wk|wv|wg)$", (None, "fsdp", "heads", "hd")),
    (r".*/wkv/wo$",            (None, "heads", "hd", "fsdp")),
    (r".*/wkv/(decay_w1)$",    (None, "fsdp", None)),
    (r".*/wkv/(decay_w2)$",    (None, None, "heads", None)),
    (r".*/wkv/(tmix_w1)$",     (None, "fsdp", None, None)),
    (r".*/wkv/(tmix_w2)$",     (None, None, None, "fsdp")),
    (r".*/wkv/(u|ln_w|ln_b)$", (None, "heads", None)),
    (r".*/wkv/(mu_.*)$",       (None, None)),
    (r".*/cmix/wk$",           (None, "fsdp", "ff")),
    (r".*/cmix/wv$",           (None, "ff", "fsdp")),
    (r".*/cmix/(mu_.*)$",      (None, None)),
    # mamba/ssm branch (hymba)
    (r".*/ssm/w_in$",          (None, "fsdp", "heads", None)),
    (r".*/ssm/w_out$",         (None, "heads", None, "fsdp")),
    (r".*/ssm/(w_dt|w_b|w_c)$", (None, "heads", None, None)),
    (r".*/ssm/(a_log|dt_bias|d_skip)$", (None, "heads", None)),
    (r".*/ssm/conv_w$",        (None, "heads", None, None)),
    # norms / scalars inside blocks
    (r".*/(ln1|ln2|ln0|norm|pre_norm|post_norm|attn_norm|ssm_norm)/(w|b|scale|bias)$",
     (None, None)),
    # --- top-level ---
    (r"^embed/table$",     ("vocab", None)),
    (r"^embed/pos$",       (None, None)),
    (r"^head/w$",          (None, "vocab")),
    (r"^head/b$",          ("vocab",)),
    (r"^final_norm/(w|b)$", (None,)),
    # encoder stacks (whisper) reuse block rules via .*
    (r"^enc_embed/.*$",    (None, None)),
    # vlm projector
    (r"^projector/w$",     (None, "fsdp")),
    (r"^projector/b$",     (None,)),
    # --- paper models (VGG16 / LSTM / CNN): replicated (they are tiny) ---
    (r"^(conv|dense|lstm|embed_small).*$", ()),
)

_LOGICAL_TO_MESH = {
    "tp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "hd": "model", "ff": "model", "expert": "model", "ff_inner": None,
        "fsdp": None,
    },
    "fsdp_tp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "hd": "model", "ff": "model", "expert": "model", "ff_inner": None,
        "fsdp": "data",
    },
    # decode layouts for archs whose kv-head count does not divide the
    # model axis: attention TP moves from heads to head_dim so q and the
    # hd-sharded KV cache line up with zero resharding.
    "tp_hd": {
        "vocab": "model", "heads": None, "kv_heads": None, "hd": "model",
        "ff": "model", "expert": "model", "ff_inner": None, "fsdp": None,
    },
    "fsdp_tp_hd": {
        "vocab": "model", "heads": None, "kv_heads": None, "hd": "model",
        "ff": "model", "expert": "model", "ff_inner": None, "fsdp": "data",
    },
    # pure data/fsdp variant (beyond-paper perf iteration for small archs:
    # no TP activation all-reduces; params fully sharded over BOTH axes).
    "fsdp_only": {
        "vocab": None, "heads": None, "kv_heads": None, "hd": None,
        "ff": None, "expert": "model", "ff_inner": None,
        "fsdp": ("data", "model"),
    },
    "replicated": {k: None for k in
                   ("vocab", "heads", "kv_heads", "hd", "ff", "expert",
                    "ff_inner", "fsdp")},
}


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh-dim order, of a ``DeviceMesh`` or of a
    stand-in whose ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _divides(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    size = 1
    for a in axes:
        size *= sizes[a]
    return n % size == 0


def spec_for(path: str, shape: Sequence[int], layout: str, mesh,
             extra_leading: Tuple[Optional[str], ...] = ()) -> Spec:
    """Resolve the spec of one param: one entry per dim of ``shape``
    (fewer when trailing dims are replicated, as the reference's
    ``PartitionSpec``).

    ``extra_leading`` prepends mesh axes (e.g. ("client",) when params
    carry a leading client dim in the FL round step).
    """
    table = _LOGICAL_TO_MESH[layout]
    sizes = axis_sizes(mesh)
    for pat, logical in _RULES:
        if re.match(pat, path):
            axes: list = list(extra_leading)
            used = {a for a in extra_leading if a}
            # logical spec is aligned to the trailing dims when the param
            # has MORE dims than the rule (unstacked variant drops the
            # leading layer dim).
            spec = list(logical)
            nd = len(shape) - len(extra_leading)
            if len(spec) > nd:
                spec = spec[len(spec) - nd:]
            while len(spec) < nd:
                spec.append(None)
            for dim, logical_ax in zip(shape[len(extra_leading):], spec):
                mesh_ax = table.get(logical_ax) if logical_ax else None
                ok = mesh_ax is not None
                if ok:
                    parts = (mesh_ax,) if isinstance(mesh_ax, str) \
                        else tuple(mesh_ax)
                    ok = all(a in sizes and a not in used
                             for a in parts) and \
                        _divides(dim, mesh, mesh_ax) and \
                        dim >= max(sizes[a] for a in parts)
                if ok:
                    axes.append(mesh_ax)
                    used.update(parts)
                else:
                    axes.append(None)
            return tuple(axes)
    return tuple(extra_leading)


def params_specs(params: Tree, layout: str, mesh,
                 extra_leading: Tuple[Optional[str], ...] = ()) -> Tree:
    """``{path: spec}`` over a flat param tree (tensors on any device,
    ``meta`` included, or anything with a ``shape``)."""
    return {p: spec_for(p, tuple(x.shape), layout, mesh, extra_leading)
            for p, x in params.items()}


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d takes that mesh axis, else
    ``Replicate()``.

    DTensor splits a dim sharded over several mesh dims in mesh-dim
    order, major to minor; the spec orders them the same way, major to
    minor.  A spec listing them in another order than the mesh's would
    place every shard elsewhere, so it raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        parts = (ax,) if isinstance(ax, str) else tuple(ax)
        order = [names.index(a) for a in parts]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec}: dim {d} is split over {parts}, not in the "
                f"mesh's axis order {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def params_shardings(params: Tree, layout: str, mesh,
                     extra_leading: Tuple[Optional[str], ...] = ()) -> Tree:
    """``{path: placements}`` on ``mesh`` (the reference's
    ``NamedSharding`` tree)."""
    return {p: placements(s, mesh) for p, s in
            params_specs(params, layout, mesh, extra_leading).items()}


def batch_spec(mesh, client_axis: bool = False) -> Spec:
    """Token batches shard over the data axis (and client axis in FL)."""
    lead = ("client",) if client_axis else ()
    data_ax = "data" if "data" in axis_sizes(mesh) else None
    return (*lead, data_ax)


def layout_for(cfg) -> str:
    """Pick the intra-client layout by model scale (DESIGN.md §5)."""
    if cfg.fl_clients_single_pod <= 4:
        return "fsdp_tp"
    return "tp"


def validate_specs(params: Tree, specs: Tree, mesh) -> list:
    """Return a list of (path, shape, spec) divisibility violations."""
    sizes = axis_sizes(mesh)
    bad = []
    for p, x in params.items():
        s = specs[p]
        for dim, ax in zip(x.shape, tuple(s) + (None,) * len(x.shape)):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            size = int(np.prod([sizes[a] for a in axes]))
            if dim % size != 0:
                bad.append((p, tuple(x.shape), s))
                break
    return bad
