"""Network-transfer accounting (paper Table 4 / §4.2.5).

Byte counts are exact functions of the unit assignment and the selection
matrix — no simulation noise.  Pure numpy, copied from
``repro.core.comm`` so the port's byte counts equal the reference's
exactly.  Ported: the hub accounting the paper reports, the edge
membership and the hierarchical and gossip rounds; the buffered
(async) formulas wait for the async engine.

* **hub** (the paper's FEDn combiner): per round,
    uplink_c   = Σ_u sel_cu · unit_bytes_u      (only trained layers ship)
    downlink_c = full model                     (server broadcasts globals)
  The paper's Table 4 reports the 10-client uplink sum.  With
  ``downlink="selected"`` the server broadcasts only the units the round
  updated (exact: aggregation changes *only* units somebody trained).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .masking import UnitAssignment, unit_param_counts


def unit_bytes(assign: UnitAssignment, params, bytes_per_param: int = 4
               ) -> np.ndarray:
    return unit_param_counts(assign, params) * bytes_per_param


def _safe_frac(num: float, denom: float) -> float:
    """Uplink fraction with the degenerate-round guard: a round where
    nothing could have shipped (zero effective clients/edges or an
    empty model) is a 0.0-fraction round, not a ZeroDivision/NaN."""
    return num / denom if denom > 0 else 0.0


def hub_round_bytes(sel: np.ndarray, ubytes: np.ndarray,
                    include_downlink: bool = False,
                    downlink: str = "full") -> Dict[str, float]:
    """sel (C, U) 0/1 for one round.

    ``downlink="full"``: the server broadcasts the whole model to every
    client (the paper's FEDn behaviour).  ``downlink="selected"``: the
    server broadcasts only the units the round's aggregation touched —
    the per-round selection union — which is sufficient to keep every
    client's global copy exact (frozen units never change server-side).
    Under synchronized selection the union equals the shared subset, so
    downlink shrinks by the same frozen fraction as uplink.
    """
    sel = np.asarray(sel)
    uplink = float((sel @ ubytes).sum())
    total_model = float(ubytes.sum())
    if downlink == "full":
        down = total_model * sel.shape[0]
    elif downlink == "selected":
        union = sel.max(axis=0) if sel.shape[0] else np.zeros(sel.shape[1])
        down = float(union @ ubytes) * sel.shape[0]
    else:
        raise ValueError(f"downlink must be 'full' or 'selected', "
                         f"got {downlink!r}")
    out = {"uplink": uplink,
           "uplink_frac": _safe_frac(uplink, total_model * sel.shape[0]),
           "downlink": down}
    out["total"] = uplink + (down if include_downlink else 0.0)
    return out


def edge_membership(n_clients: int, n_edges: int) -> np.ndarray:
    """(E, C) 0/1 — contiguous near-equal client groups per edge."""
    if not 1 <= n_edges <= n_clients:
        raise ValueError(f"n_edges={n_edges} out of range for "
                         f"{n_clients} clients")
    mem = np.zeros((n_edges, n_clients), np.float32)
    for e, grp in enumerate(np.array_split(np.arange(n_clients), n_edges)):
        mem[e, grp] = 1.0
    return mem


def hierarchical_round_bytes(sel: np.ndarray, ubytes: np.ndarray,
                             membership: np.ndarray,
                             include_downlink: bool = False,
                             downlink: str = "full") -> Dict[str, float]:
    """Two-stage accounting: client->edge (LAN) and edge->hub (WAN).

    Each edge uploads one partial aggregate per unit in its selection
    *union* — a unit trained by several of the edge's clients crosses
    the WAN once, which is where hierarchical beats the flat hub.
    ``uplink`` is the WAN (edge->hub) term.
    """
    sel = np.asarray(sel)
    membership = np.asarray(membership)
    n_edges, n_clients = membership.shape
    total_model = float(ubytes.sum())
    client_edge = float((sel @ ubytes).sum())
    # per-edge selection union: (E, U)
    union = (membership @ sel > 0).astype(np.float64)
    edge_hub = float((union @ ubytes).sum())
    if downlink == "full":
        down = total_model * (n_edges + n_clients)
    elif downlink == "selected":
        gu = sel.max(axis=0) if sel.shape[0] else np.zeros(sel.shape[1])
        down = float(gu @ ubytes) * (n_edges + n_clients)
    else:
        raise ValueError(f"downlink must be 'full' or 'selected', "
                         f"got {downlink!r}")
    out = {"uplink": edge_hub,
           "uplink_frac": _safe_frac(edge_hub, total_model * n_edges),
           "edge_hub_uplink": edge_hub,
           "client_edge_uplink": client_edge,
           "downlink": down}
    out["total"] = edge_hub + client_edge + (down if include_downlink
                                             else 0.0)
    return out


def gossip_round_bytes(sel: np.ndarray, ubytes: np.ndarray,
                       degree: Optional[int] = None) -> Dict[str, float]:
    """Peer-exchange accounting for one gossip round.

    Every client ships its FULL replica to each of its ``degree``
    out-neighbours (ring default: 2, capped by C-1); the mixing step
    blends all entries of a replica, so selection cannot shrink the
    payload — ``uplink_frac`` is 1 by construction and ``sel`` only
    informs ``trained_params`` elsewhere.
    """
    sel = np.asarray(sel)
    n_clients = sel.shape[0]
    if degree is None:
        degree = min(2, max(n_clients - 1, 0))
    total_model = float(ubytes.sum())
    payload = total_model * n_clients * degree
    return {"uplink": payload,
            "uplink_frac": 1.0 if n_clients > 1 else 0.0,
            "peer_bytes": payload,
            "degree": float(degree),
            "downlink": 0.0,
            "total": payload}


def table4_row(assign: UnitAssignment, params, sel_history,
               bytes_per_param: int = 4,
               wire_ubytes=None) -> Dict[str, float]:
    """Reproduce one Table 4 cell from a run's selection history.

    sel_history: (rounds, C, U).  Returns average per-round uplink bytes
    and trained-parameter count across the history.  ``wire_ubytes``
    (codec-encoded per-unit bytes, core/codecs.py) rebills the uplink
    terms at wire width while ``reduction_vs_full`` keeps the fp32
    full-model denominator, so the reduction composes structural freeze
    × codec compression.
    """
    ub = unit_bytes(assign, params, bytes_per_param)
    counts = unit_param_counts(assign, params)
    hist = np.asarray(sel_history)
    per_round_bytes = np.einsum(
        "rcu,u->r", hist, ub if wire_ubytes is None else wire_ubytes)
    per_round_params = np.einsum("rcu,u->r", hist, counts)
    return {
        "avg_uplink_bytes": float(per_round_bytes.mean()),
        "avg_trained_params": float(per_round_params.mean()),
        "total_uplink_bytes": float(per_round_bytes.sum()),
        "reduction_vs_full": 1.0 - float(per_round_bytes.mean()) /
        (float(ub.sum()) * hist.shape[1]),
    }
