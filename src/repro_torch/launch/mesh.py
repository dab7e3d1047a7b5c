"""Production meshes and FL logical views on a torch ``DeviceMesh``.

The port of ``repro.launch.mesh``.  The reference is single-controller:
``jax.make_mesh`` lays one program over every device.  The port is
PyTorch's SPMD: one process (rank) per mesh position, over the default
process group, which the caller initializes
(``torch.distributed.init_process_group``: ``torchrun`` on a multi-card
host, spawned gloo ranks in the tests).  "Devices visible" in the
reference's messages is the process group's world size here.  Every
builder takes ``device_type`` (``"cuda"`` unless the caller asks for
``"cpu"``); the axis names and shapes are the reference's:

``make_production_mesh`` is the spec-literal mesh: (16, 16)
("data", "model") for one 256-chip pod; (2, 16, 16)
("pod", "data", "model") for the 2-pod, 512-chip deployment.

``make_fl_mesh`` is the federated *view* of the same ranks (DESIGN.md
§5): a leading ``client`` axis carved out of the data axis — clients
are mesh subgroups (cross-device mode) or whole pods (cross-silo mode,
multi-pod: the pod axis folds into the client axis).

``make_hier_fl_mesh`` is the hierarchical topology's view (DESIGN.md
§6): ``(edge, client, data, model)``, clients of one edge adjacent.

``make_client_mesh`` / ``shard_over_clients`` are the cohort's 1-D
``(client,)`` mesh (DESIGN.md §13): rank r runs the cohort stage on its
contiguous block of the client axis and the per-client outputs are
all-gathered along dim 0, so every rank returns the full-width result.
Per-client rows of a local update are independent of their cohort, and
an all-gather copies bytes, so the sharded run is bitwise the unsharded
one.

The collectives are ``all_gather`` into a list of tensors (gloo does
not take ``all_gather_into_tensor``) and ``all_gather_object`` for the
shapes of an empty block's outputs.  gloo takes CUDA tensors in
``all_gather`` (it stages them through host memory itself), which is how
two ranks share one card: NCCL refuses two ranks on one device.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def _nearest_valid(total: int, want: int) -> str:
    """Human hint: the divisors of ``total`` bracketing ``want``."""
    divs = [d for d in range(1, total + 1) if total % d == 0]
    below = max((d for d in divs if d < want), default=None)
    above = min((d for d in divs if d > want), default=None)
    opts = [str(d) for d in (below, above) if d is not None]
    return " or ".join(opts) if opts else "none"


def world_size() -> int:
    """The default process group's size (the reference's visible device
    count); raises when no group is initialized."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs the default process group: call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its environment; on one card, ranks share it over gloo)")
    return dist.get_world_size()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device_type: str):
    """A ``DeviceMesh`` of ``shape`` over ranks ``0 .. prod(shape) - 1``
    (the reference's ``devices[:size]``)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    world, size = world_size(), _size(shape)
    if size > world:
        raise ValueError(
            f"mesh {dict(zip(names, shape))} needs {size} ranks; the "
            f"process group has {world}")
    if size == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_fl_mesh(n_clients: int, *, multi_pod: bool = False,
                 device_type: str = "cuda"):
    """(client, data, model) view with client*data = pods*16, model = 16."""
    pods = 2 if multi_pod else 1
    total_dp = pods * 16
    if multi_pod:
        # cross-silo: the pod axis folds into the client axis
        n_clients = max(n_clients, pods)
        if n_clients % pods:
            raise ValueError(
                f"multi-pod clients must fill the {pods} pods evenly: "
                f"requested {n_clients} clients with "
                f"{world_size()} devices visible; nearest valid "
                f"cohort sizes: {pods * (n_clients // pods)} or "
                f"{pods * (n_clients // pods + 1)}")
    if total_dp % n_clients:
        raise ValueError(
            f"client axis {n_clients} must divide the {total_dp}-way "
            f"data parallelism ({world_size()} devices visible, "
            f"model axis 16); nearest valid cohort sizes: "
            f"{_nearest_valid(total_dp, n_clients)}")
    shape = (n_clients, total_dp // n_clients, 16)
    return _mesh(shape, ("client", "data", "model"), device_type)


def make_hier_fl_mesh(n_edges: int, n_clients: int, *,
                      multi_pod: bool = False, device_type: str = "cuda"):
    """(edge, client, data, model) view: edge * client * data = DP chips.

    The flat client axis of ``make_fl_mesh`` is split edge-major, so
    client c lands in edge c // (n_clients/n_edges) — matching the
    contiguous edge groups the hierarchical aggregation stage uses
    (core/comm.py ``edge_membership``).
    """
    pods = 2 if multi_pod else 1
    total_dp = pods * 16
    if n_edges < 1 or n_clients % n_edges:
        raise ValueError(
            f"edge axis {n_edges} must divide the {n_clients} clients "
            f"evenly ({world_size()} devices visible); nearest "
            f"valid edge counts for {n_clients} clients: "
            f"{_nearest_valid(n_clients, max(n_edges, 1))}")
    if total_dp % n_clients:
        raise ValueError(
            f"client axis {n_clients} must divide the {total_dp}-way "
            f"data parallelism ({world_size()} devices visible, "
            f"model axis 16); nearest valid cohort sizes: "
            f"{_nearest_valid(total_dp, n_clients)}")
    shape = (n_edges, n_clients // n_edges, total_dp // n_clients, 16)
    return _mesh(shape, ("edge", "client", "data", "model"), device_type)


def make_client_mesh(n_shards: int, *, device_type: str = "cuda"):
    """1-D ``(client,)`` mesh over the first ``n_shards`` ranks."""
    ndev = world_size()
    if n_shards < 1 or n_shards > ndev:
        raise ValueError(
            f"client_shards={n_shards} needs between 1 and {ndev} "
            f"devices ({ndev} visible)")
    return _mesh((n_shards,), ("client",), device_type)


def client_block(rank: int, n_shards: int, n_clients: int
                 ) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous block ``[lo, hi)`` of ``n_clients``:
    equal blocks when ``n_shards`` divides it, else the first
    ``n_clients % n_shards`` ranks take one more (a block may be empty)."""
    base, extra = divmod(n_clients, n_shards)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


class ClientShards:
    """A cohort split over a ``(client,)`` mesh: which clients this rank
    runs (:meth:`block`), and the all-gathers that hand every rank the
    others' rows (:meth:`gather`, :meth:`fill`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group(0)
        self.n_shards = mesh.size()
        coord = mesh.get_coordinate()
        self.rank = None if coord is None else coord[0]

    def block(self, n_clients: int) -> Tuple[int, int]:
        if self.rank is None:            # a rank outside the mesh runs all
            return 0, n_clients
        return client_block(self.rank, self.n_shards, n_clients)

    def _sizes(self, n_clients: int) -> List[int]:
        return [hi - lo for lo, hi in (client_block(r, self.n_shards,
                                                    n_clients)
                                       for r in range(self.n_shards))]

    def fill(self, full: torch.Tensor) -> torch.Tensor:
        """``full`` (n, ...) holds this rank's block of rows: all-gather
        the other ranks' blocks into it, in place (equal blocks only)."""
        if self.rank is None:
            return full
        import torch.distributed as dist
        n = full.shape[0]
        sizes = self._sizes(n)
        if len(set(sizes)) != 1:
            raise ValueError(f"fill needs equal blocks: {n} rows over "
                             f"{self.n_shards} ranks")
        outs = list(full.split(sizes[0]))
        lo, hi = self.block(n)
        # the input is a copy: it must not alias its own output slot
        dist.all_gather(outs, full[lo:hi].clone(), group=self.group)
        return full

    def gather(self, local: Any, n_clients: int,
               device: Optional[torch.device] = None) -> Any:
        """Every rank's block of a tree of per-client tensors (leading
        client axis), concatenated in rank order: the ``n_clients`` rows
        on every rank.  ``local`` is None on a rank whose block is empty;
        ``device`` places that rank's result."""
        if self.rank is None:
            return local
        import torch.distributed as dist
        import torch.utils._pytree as pytree
        sizes = self._sizes(n_clients)
        if local is not None:
            leaves, spec = pytree.tree_flatten(local)
            meta = (pytree.treespec_dumps(spec),
                    [None if x is None else (tuple(x.shape[1:]), x.dtype)
                     for x in leaves])
        if min(sizes) == 0:
            # an empty block knows no output shapes: take them from a rank
            # that ran
            metas: List[Any] = [None] * self.n_shards
            dist.all_gather_object(metas, meta if local is not None
                                   else None, group=self.group)
            meta = next(m for m in metas if m is not None)
            spec = pytree.treespec_loads(meta[0])
        if local is None:
            leaves = [None if m is None else
                      torch.empty((0,) + m[0], dtype=m[1], device=device)
                      for m in meta[1]]
        big = max(sizes)
        out = []
        for x in leaves:
            if x is None:                # an absent output (None) stays so
                out.append(None)
                continue
            x = x.contiguous()
            if all(s == big for s in sizes):
                parts = [torch.empty_like(x) for _ in sizes]
                dist.all_gather(parts, x, group=self.group)
                out.append(torch.cat(parts))
                continue
            pad = x.new_zeros((big,) + tuple(x.shape[1:]))
            pad[:x.shape[0]] = x
            parts = [torch.empty_like(pad) for _ in sizes]
            dist.all_gather(parts, pad, group=self.group)
            out.append(torch.cat([p[:s] for p, s in zip(parts, sizes)]))
        return pytree.tree_unflatten(out, spec)

    def run(self, fn: Callable, replicated: Any, *per_client: Any) -> Any:
        """``fn(replicated, *per_client)`` on this rank's block of the
        client axis, gathered to the full width."""
        import torch.utils._pytree as pytree
        leaves = pytree.tree_leaves(per_client)
        n = leaves[0].shape[0]
        lo, hi = self.block(n)
        dev = next((x.device for x in pytree.tree_leaves(replicated)
                    if isinstance(x, torch.Tensor)), None)
        local = None
        if hi > lo:
            local = fn(replicated, *pytree.tree_map(
                lambda x: x[lo:hi], per_client))
        return self.gather(local, n, dev)


def shard_over_clients(fn: Callable, n_shards: int, n_clients: int, *,
                       device_type: str = "cuda") -> Callable:
    """Split ``fn``'s leading client axis over a ``(client,)`` mesh.

    ``fn(replicated, *per_client) -> per-client outputs``: the first
    argument (a tree, e.g. global params) is replicated, every other
    argument and every output leaf carries a leading client axis.  Rank
    r runs ``fn`` on its contiguous block of ``n_clients // n_shards``
    clients and the blocks are all-gathered along dim 0, so every rank
    returns bitwise what the unsharded call produces.
    """
    ndev = world_size()
    if n_clients % n_shards:
        valid = [d for d in range(1, min(n_clients, ndev) + 1)
                 if n_clients % d == 0]
        raise ValueError(
            f"client_shards={n_shards} must divide the cohort of "
            f"{n_clients} clients ({ndev} devices visible); valid "
            f"shard counts here: {valid}")
    shards = ClientShards(make_client_mesh(n_shards,
                                           device_type=device_type))

    def wrapped(replicated, *per_client):
        return shards.run(fn, replicated, *per_client)

    return wrapped


def make_host_mesh(*, model: int = 1, device_type: str = "cpu"):
    """Degenerate ``(1, model)`` mesh for CPU tests and examples."""
    return _mesh((1, model), ("data", "model"), device_type)


def _size(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
