"""The paper's Table 4 in the port: uplink bytes per round on VGG16 at
full width (14,736,714 params), 10 clients, for each topology.

    PYTHONPATH=src python -m repro_torch.comm_table
        [--topology hub|hierarchical|gossip|all] [--rounds N]

* ``hub`` — the paper's table: trained params and uplink per round at
  4/7/10/14 trained layers, beside the paper's values, and the reduction
  against shipping the full model.
* ``hierarchical`` — the same selections under 2 edge aggregators of 5
  clients: client->edge (LAN) bytes and the edge->hub (WAN) bytes,
  which carry each edge's selection union only and so sit strictly
  below the flat hub's uplink whenever fewer than all layers train.
* ``gossip`` — ring peer exchange: every client ships its full replica
  to its 2 neighbours, so freezing does not shrink the traffic.

Selections are the port's ``uniform`` strategy drawn from a
``torch.Generator`` per (layers, round): the reference's script draws
with JAX's threefry keys, which have no torch twin, so the averages are
over other draws of the same distribution.  The byte math is the
reference's, exactly (``core/comm.py``).  Runs on the CPU in seconds.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from .core import comm
from .core.masking import build_units_flat, unit_param_counts
from .core.strategies import SelectionContext, get_strategy
from .models import paper_models as pm

# the paper's Table 4: trained params and uplink bytes per round
PAPER = {4: (34.88e6, 133.1e6), 7: (67.92e6, 259.1e6),
         10: (101.3e6, 386.5e6), 14: (147.2e6, 561.6e6)}
CLIENTS = 10
N_EDGES = 2
LAYERS = {"hub": (4, 7, 10, 14), "hierarchical": (4, 7, 10, 14),
          "gossip": (4, 7, 14)}


def unit_tables():
    """VGG16's per-unit parameter counts and fp32 bytes."""
    params = pm.init_vgg16(torch.Generator().manual_seed(0))
    assign = build_units_flat(params, pm.vgg16_units(params))
    return unit_param_counts(assign, params), comm.unit_bytes(assign, params)


def draw_selections(n_train: int, rounds: int, n_units: int
                    ) -> List[np.ndarray]:
    """``rounds`` uniform (CLIENTS, n_units) selections of ``n_train``."""
    ctx = SelectionContext(CLIENTS, n_units, n_train)
    strat = get_strategy("uniform")
    return [strat.select(torch.Generator().manual_seed(1000 * n_train + r),
                         ctx).numpy() for r in range(rounds)]


def hub_row(sels, counts, ub) -> Dict[str, float]:
    params = [float((s @ counts).sum()) for s in sels]
    uplink = [comm.hub_round_bytes(s, ub)["uplink"] for s in sels]
    return {"trained_params": float(np.mean(params)),
            "uplink": float(np.mean(uplink)),
            "reduction_vs_full":
                1 - float(np.mean(uplink)) / (ub.sum() * CLIENTS)}


def hierarchical_row(sels, ub, n_edges: int = N_EDGES) -> Dict[str, float]:
    mem = comm.edge_membership(CLIENTS, n_edges)
    rows = [comm.hierarchical_round_bytes(s, ub, mem) for s in sels]
    flat = float(np.mean([comm.hub_round_bytes(s, ub)["uplink"]
                          for s in sels]))
    wan = float(np.mean([r["edge_hub_uplink"] for r in rows]))
    return {"flat_hub_uplink": flat,
            "client_edge_uplink":
                float(np.mean([r["client_edge_uplink"] for r in rows])),
            "edge_hub_uplink": wan, "wan_vs_flat": wan / flat}


def gossip_row(sels, ub) -> Dict[str, float]:
    flat = float(np.mean([comm.hub_round_bytes(s, ub)["uplink"]
                          for s in sels]))
    peer = float(np.mean([comm.gossip_round_bytes(s, ub)["peer_bytes"]
                          for s in sels]))
    return {"flat_hub_uplink": flat, "peer_bytes": peer,
            "ratio": peer / flat}


def table(topology: str, rounds: int) -> Dict[int, Dict[str, float]]:
    """Rows of ``topology``'s table, keyed by trained layers."""
    counts, ub = unit_tables()
    out = {}
    for n in LAYERS[topology]:
        sels = draw_selections(n, rounds, len(ub))
        if topology == "hub":
            out[n] = hub_row(sels, counts, ub)
        elif topology == "hierarchical":
            out[n] = hierarchical_row(sels, ub)
            if n < len(ub) and not out[n]["wan_vs_flat"] < 1.0:
                raise AssertionError(
                    f"edge->hub WAN not below the flat hub at {n} layers")
        else:
            out[n] = gossip_row(sels, ub)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--topology", default="all",
                    choices=sorted(LAYERS) + ["all"])
    ap.add_argument("--rounds", type=int, default=100)
    a = ap.parse_args(argv)
    for name in (list(LAYERS) if a.topology == "all" else [a.topology]):
        rows = table(name, a.rounds)
        print(f"# {name}: VGG16, {CLIENTS} clients"
              + (f", {N_EDGES} edges" if name == "hierarchical" else "")
              + f", mean of {a.rounds} rounds, 4 B/param")
        if name == "hub":
            print("# layers, trained_params(M), paper(M), uplink(MB), "
                  "paper(MB), reduction_vs_full")
            for n, r in rows.items():
                pp, pb = PAPER[n]
                print(f"{n},{r['trained_params'] / 1e6:.2f},{pp / 1e6:.2f},"
                      f"{r['uplink'] / 1e6:.1f},{pb / 1e6:.1f},"
                      f"{r['reduction_vs_full']:.3f}")
        elif name == "hierarchical":
            print("# layers, flat_hub_uplink(MB), client_edge(MB), "
                  "edge_hub_WAN(MB), wan_vs_flat")
            for n, r in rows.items():
                print(f"{n},{r['flat_hub_uplink'] / 1e6:.1f},"
                      f"{r['client_edge_uplink'] / 1e6:.1f},"
                      f"{r['edge_hub_uplink'] / 1e6:.1f},"
                      f"{r['wan_vs_flat']:.3f}")
        else:
            print("# layers, flat_hub_uplink(MB), gossip_peer_bytes(MB), "
                  "ratio")
            for n, r in rows.items():
                print(f"{n},{r['flat_hub_uplink'] / 1e6:.1f},"
                      f"{r['peer_bytes'] / 1e6:.1f},{r['ratio']:.2f}")


if __name__ == "__main__":
    main()
