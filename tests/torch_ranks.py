"""Multi-rank workers for the port's mesh tests, on gloo over the CPU.

``spawn(target, world, tmp_path, **kw)`` starts ``world`` Python
processes running ``python tests/torch_ranks.py``; each joins a gloo
process group through a ``FileStore`` under ``tmp_path`` (no TCP port,
so tests running side by side under ``pytest -n`` cannot collide), runs
``target(**kw)`` and saves what it returns with ``torch.save``; the
parent gets the list of results in rank order.  ``fake_run`` does the
same in one process on the ``fake`` backend (``FakeStore``), which
builds meshes of production shape without any peer.  No process group
is ever initialized in the pytest process itself.

The workers import ``torch`` and ``repro_torch`` only; the tests hold
what they return against the reference.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def spawn(target: str, world: int, tmp_path, timeout: float = 120,
          backend: str = "gloo", **kw):
    store = os.path.join(str(tmp_path), f"store-{target}")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        out = os.path.join(str(tmp_path), f"{target}-{rank}.pt")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, target, str(rank), str(world), store,
             out, json.dumps(kw), backend], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), out))
    results, errors = [], []
    for p, out in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise
        if p.returncode:
            errors.append(err[-3000:])
        else:
            import torch
            results.append(torch.load(out, weights_only=False))
    assert not errors, "\n".join(errors)
    return results


def fake_run(target: str, world: int, rank: int = 0, timeout: float = 120,
             **kw):
    """``target(**kw)`` in one process joined to a ``fake`` group of
    ``world`` ranks as ``rank``; returns what it returns (pickled)."""
    return fake_runs([(target, world, rank, kw)], timeout)[0]


def fake_runs(calls, timeout: float = 120):
    """Several ``fake_run`` calls, ``(target, world, rank, kw)`` each, in
    processes side by side."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, target, str(rank), str(world), "fake",
         "-", json.dumps(kw)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for target, world, rank, kw in calls]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err.decode()[-3000:]
        outs.append(pickle.loads(out))
    return outs


# ---------------------------------------------------------------------------
# targets


C = 4                  # clients of the toy MLP runs


def toy_setup():
    import torch
    from repro_torch.models import toy
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=6,
                         d=16, hidden=32, out=4)
    return p, toy.toy_units(p), toy.toy_batches(
        torch.Generator().manual_seed(1), n_clients=C, steps=2, batch=2,
        d=16, out=4)


# every star round path: the plain loop (dense hub through K1's wrapper
# and its client rows, the masked loop with scoring telemetry, the full
# strategy, hierarchical), the packed stage, the cohort engine and the
# async engine (dispatches of fewer clients than shards: empty blocks)
ROUND_PATHS = {
    "dense hub fused": dict(fused_agg="on"),
    "dense hub score_weighted": dict(strategy="score_weighted"),
    "full": dict(strategy="full", train_fraction=1.0),
    "hierarchical fused": dict(topology="hierarchical", n_edges=2,
                               fused_agg="on"),
    "packed qint8": dict(packed=True, codec="qint8"),
    "hierarchical packed": dict(topology="hierarchical", n_edges=2,
                                packed=True),
    "cohort chunk 2": dict(packed=True, codec="qint8", n_registered=C,
                           cohort_chunk=2),
    "async buffer 2": dict(packed=True, async_buffer=2,
                           client_delay_dist="exponential:1.0"),
}


def toy_run(name: str, shards: int = 0, rounds: int = 2):
    """One path of ``ROUND_PATHS`` on the toy MLP, ``rounds`` rounds
    (flushes): (params, losses, sel_history, comm_summary)."""
    import numpy as np
    import torch
    from repro_torch.core import FLConfig, Federation
    from repro_torch.models import toy
    p, assign, b = toy_setup()
    kw = dict(n_clients=C, train_fraction=0.5, lr=1e-2)
    kw.update(ROUND_PATHS[name])
    fl = FLConfig(client_shards=shards, **kw)
    fed = Federation(loss_fn=functools.partial(toy.toy_loss, device="cpu"),
                     params=dict(p), assign=assign, fl=fl, seed=3,
                     dropout_rate=0.25 if "async" not in name else 0.0,
                     device="cpu")
    if fl.uses_cohort_engine():
        fn = lambda r, ids: {k: v[torch.as_tensor(np.asarray(ids))]  # noqa
                             for k, v in b.items()}
    else:
        fn = lambda r: b                                             # noqa
    fed.server.run(rounds, fn)
    return ({q: x.clone() for q, x in fed.params.items()},
            [r.loss for r in fed.history],
            [np.asarray(s) for s in fed.server.sel_history],
            fed.comm_summary())


def client_shard_runs(shards: int = 2):
    """Every path of ``ROUND_PATHS`` with ``client_shards``; beside them
    the cohort widths each path's stage ran at (``"widths"``) and the
    zoo facade's params from a seed (``"server params"``)."""
    from repro_torch.launch import mesh
    widths: dict = {}
    block = mesh.ClientShards.block

    def recording(self, n_clients):
        widths.setdefault(name, []).append(n_clients)
        return block(self, n_clients)

    mesh.ClientShards.block = recording
    out = {}
    for name in ROUND_PATHS:
        out[name] = toy_run(name, shards)
    mesh.ClientShards.block = block
    out["widths"] = widths
    out["server params"] = server_params()
    return out


def shard_over_clients_case(n_clients: int = 8, device: str = "cpu"):
    """``shard_over_clients`` over the group against the plain call, on a
    tree of outputs; the same call with 1 client (an empty block).  On
    ``cuda`` every rank's tensors lie on the one card (results back on
    the CPU)."""
    import torch
    from repro_torch.launch import mesh
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n_clients, 5, generator=gen).to(device)
    y = torch.randn(n_clients, 3, 2, generator=gen).to(device)
    g = torch.randn(5, generator=gen).to(device)

    def fn(rep, x, y):
        return {"a": torch.tanh(x * rep), "b": (y.sum(-1), x @ rep)}

    world = mesh.world_size()
    kind = torch.device(device).type
    got = mesh.shard_over_clients(fn, world, n_clients,
                                  device_type=kind)(g, x, y)
    shards = mesh.ClientShards(mesh.make_client_mesh(world,
                                                     device_type=kind))
    one = shards.run(fn, g, x[:1], y[:1])
    out = got, fn(g, x, y), one, fn(g, x[:1], y[:1])
    return torch.utils._pytree.tree_map(lambda t: t.cpu(), out)


def server_params(seed: int = 0):
    """The zoo facade's params from a seed on this rank (every rank must
    build the same)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import get_model
    cfg = get_config("granite-moe-1b-a400m").reduced()
    return get_model(cfg).init_params(torch.Generator().manual_seed(seed))


MOE_CASES = {"top2": (8, 2), "top1": (8, 1), "top4": (4, 4)}


def moe_ep_cuda(e, k, seed):
    """``moe_ep_case`` on a ``(data 1, model 1)`` mesh of CUDA devices
    over this group (one rank, NCCL), against ``apply_moe`` on the card:
    the largest differences of y, aux and each gradient (relative)."""
    import torch
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import moe
    mesh = _mesh((1, 1), ("data", "model"), "cuda")
    y, aux, grads, _ = moe_ep_case(mesh, e, k, seed, device="cuda")
    p, x, g, mcfg = moe_inputs(e, k, seed)
    p = {n: v.cuda().requires_grad_(True) for n, v in p.items()}
    x, g = x.cuda().requires_grad_(True), g.cuda()
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"], x]
    wy, waux = moe.apply_moe(p, x, mcfg)
    want = torch.autograd.grad((wy * g).sum() + waux, leaves)
    return (float((y - wy).abs().max()), float((aux - waux).abs()),
            [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(grads, want)], y.device.type)


def moe_ep_case(mesh, e, k, seed, fault=False, device="cpu"):
    """``apply_moe_sharded`` on ``mesh``: y, aux, the gradients of ``(y *
    g).sum() + aux`` w.r.t. every expert leaf and x, and this rank's
    dropped copies; ``p``, ``x`` and ``g`` drawn from ``seed`` on every
    rank (and by the parent).  ``fault`` plants a wrong dispatch: ranks
    past model index 0 take the expert shard one expert further on."""
    import torch
    from repro_torch.models import moe
    p, x, g, mcfg = moe_inputs(e, k, seed)
    p = {n: v.to(device) for n, v in p.items()}
    x, g = x.to(device), g.to(device)
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"], x]
    for t in leaves:
        t.requires_grad_(True)
    moe.reset_dropped()
    shard = moe._ExpertShard.apply
    if fault:
        moe._ExpertShard.apply = lambda w, lo, hi, *a: shard(
            torch.roll(w, -1, 0) if lo else w, lo, hi, *a)
    try:
        y, aux = moe.apply_moe_sharded(p, x, mcfg, mesh=mesh)
        grads = torch.autograd.grad((y * g).sum() + aux, leaves)
    finally:
        moe._ExpertShard.apply = shard
    return (y.detach(), aux.detach(), [t.detach() for t in grads],
            moe.dropped_copies())


def decisive(cfg, params, seed=0, spacing=0.1, scale=5.0):
    """``params`` with decisive routing: embedding codes (a permutation of
    E codes ``spacing`` apart) on the first E coordinates, those
    coordinates written by no layer, each router reading its expert's
    coordinate at ``scale``."""
    import numpy as np
    import torch
    e = cfg.moe.num_experts
    out = {p: x.clone() for p, x in params.items()}
    table = out["embed/table"]
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.permutation(e) for _ in range(table.shape[0])])
    table[:, :e] = torch.as_tensor((codes - (e - 1) / 2) * spacing,
                                   dtype=table.dtype)
    for p, x in out.items():
        if p.endswith("/attn/wo") or p.endswith("/w_down"):
            x[..., :e] = 0
        if p.endswith("/moe/router"):
            x.zero_()
            x[:, torch.arange(e), torch.arange(e)] = scale
    return out


def granite_cut(seed=0):
    """Reduced granite-moe-1b-a400m (2 layers) with decisive routing, and
    tokens (2, 8)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import get_model
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = decisive(cfg, get_model(cfg).init_params(
        torch.Generator().manual_seed(seed)))
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(seed + 1))
    return cfg, params, tokens


def moe_ep_cases(shape, names):
    """Every ``MOE_CASES`` case on a ``shape`` mesh over the group, the
    planted fault on top2, and a 2-layer granite cut's ``forward`` with
    ``moe_mesh``: its logits and aux."""
    import torch
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import get_model
    mesh = _mesh(tuple(shape), tuple(names), "cpu")
    out = {name: moe_ep_case(mesh, e, k, seed=10 * e + k)
           for name, (e, k) in MOE_CASES.items()}
    out["top2 fault"] = moe_ep_case(mesh, 8, 2, seed=82, fault=True)
    cfg, params, tokens = granite_cut()
    with torch.no_grad():
        logits, aux, _ = get_model(cfg).forward(params, tokens,
                                                moe_mesh=mesh)
    out["granite forward"] = (logits, aux)
    return out


def moe_inputs(e, k, seed, d=32, ff=16, b=4, s=8):
    """The MoE layer's params, tokens and output weights from ``seed``,
    with decisive routing: the first ``e`` coordinates of every token a
    permutation of codes 0.05 apart, the router reading coordinate i for
    expert i at 3.0 plus a small random part."""
    import numpy as np
    import torch
    from repro_torch.configs.base import MoECfg
    from repro_torch.models import moe
    mcfg = MoECfg(num_experts=e, top_k=k, expert_d_ff=ff)
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, d, mcfg, torch.float32)
    x = torch.randn(b, s, d, generator=gen)
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.permutation(e) for _ in range(b * s)])
    x[..., :e] = torch.as_tensor((codes - (e - 1) / 2) * 0.05,
                                 dtype=torch.float32).view(b, s, e)
    p["router"][:e] = 3.0 * torch.eye(e)
    p["router"][e:] *= 0.01
    g = torch.randn(b, s, d, generator=gen)
    return p, x, g, mcfg


def fake_meshes():
    """On a ``fake`` group: every builder's mesh (axis names, shape, this
    rank's coordinate) or its ``ValueError`` text, by call."""
    from repro_torch.launch import mesh as M
    calls = {
        "production": lambda: M.make_production_mesh(device_type="cpu"),
        "production multi_pod": lambda: M.make_production_mesh(
            multi_pod=True, device_type="cpu"),
        "fl 16": lambda: M.make_fl_mesh(16, device_type="cpu"),
        "fl 16 multi_pod": lambda: M.make_fl_mesh(16, multi_pod=True,
                                                  device_type="cpu"),
        "fl 5": lambda: M.make_fl_mesh(5, device_type="cpu"),
        "fl 3 multi_pod": lambda: M.make_fl_mesh(3, multi_pod=True,
                                                 device_type="cpu"),
        "hier 4 16": lambda: M.make_hier_fl_mesh(4, 16, device_type="cpu"),
        "hier 3 4": lambda: M.make_hier_fl_mesh(3, 4, device_type="cpu"),
        "hier 0 4": lambda: M.make_hier_fl_mesh(0, 4, device_type="cpu"),
        "hier 1 3": lambda: M.make_hier_fl_mesh(1, 3, device_type="cpu"),
        "client 0": lambda: M.make_client_mesh(0, device_type="cpu"),
        "client -1": lambda: M.make_client_mesh(-1, device_type="cpu"),
        "client world+1": lambda: M.make_client_mesh(
            M.world_size() + 1, device_type="cpu"),
        "client 4": lambda: M.make_client_mesh(4, device_type="cpu"),
        "shard 3 of 4": lambda: M.shard_over_clients(
            lambda g, x: x, 3, 4, device_type="cpu"),
    }
    out = {"world": M.world_size()}
    for name, call in calls.items():
        try:
            m = call()
            out[name] = (tuple(m.mesh_dim_names), tuple(m.shape),
                         m.get_coordinate())
        except ValueError as e:
            out[name] = str(e)
    return out


def fake_local_shapes(cases):
    """DTensor local shapes and global offsets on the production mesh
    (this rank's coordinate) of ``(shape, spec)`` cases, placed by
    ``sharding.placements``; a spec whose axes run against the mesh's
    order raises."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import placements
    multi = M.world_size() == 512
    mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    out = []
    for shape, spec in cases:
        spec = tuple(tuple(a) if isinstance(a, list) else a for a in spec)
        try:
            pl = placements(spec, mesh)
        except ValueError as e:
            out.append(str(e))
            continue
        local, offset = compute_local_shape_and_global_offset(
            tuple(shape), mesh, pl)
        out.append((tuple(local), tuple(offset)))
    return {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
            "sizes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "cases": out}


def _main():
    target, rank, world, store, out, kw = sys.argv[1:7]
    backend = sys.argv[7] if len(sys.argv) > 7 else "gloo"
    rank, world = int(rank), int(world)
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    if store == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        res = globals()[target](**json.loads(kw))
    finally:
        dist.destroy_process_group()
    if store == "fake":
        sys.stdout.buffer.write(pickle.dumps(res))
    else:
        import torch
        torch.save(res, out)


if __name__ == "__main__":
    _main()
