"""Federated round construction (DESIGN.md §4), PyTorch port.

``build_round_step`` closes over the model loss, unit assignment and a
**registered selection strategy** (core/strategies.py) and returns

    round_step(global_params, client_batches, weights, gen)
        -> (new_global_params, metrics)

where ``client_batches`` leaves carry (C, local_steps, ...) and ``gen``
is the ``torch.Generator`` the selection draws from.  Selection, masked
local training (an ordered loop over clients where JAX vmaps) and
participation-weighted aggregation run eagerly on the round's device.

Topology is a second plugin axis (core/topology.py): ``fl.topology``
names a registered :class:`Topology` that owns the aggregation stage
and its byte accounting (``hub``, ``hierarchical``, ``gossip``).  With
``fl.packed`` the round trains and aggregates packed slot buffers, and
``fl.codec`` names a registered uplink codec (core/codecs.py) that
round-trips the packed deltas before aggregation.

``FLConfig`` keeps the reference's fields, defaults and validators.
The switches of engines that are not ported yet (async, cohort, faults,
client sharding, history cap) raise :class:`NotPortedError` when set to
anything but their default.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Union

import torch

from ..common import Device, resolve_device
from .masking import UnitAssignment
from .strategies import SelectionStrategy
from .registry import NotPortedError
from .topology import Topology, resolve_topology


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int
    n_train_units: int = 0        # N_l in the paper
    strategy: str = "uniform"     # any registered strategy name
    synchronized: bool = False    # beyond-paper collective shrinking
    lr: float = 1e-2              # paper: 0.01
    optimizer: str = "adam"       # paper: ADAM
    prox_mu: float = 0.0          # >0 -> FedProx
    always_train_head: bool = False
    # alternative to n_train_units when the unit count isn't known yet
    # (the paper's 25%/50%/75% settings); resolved against the unit
    # assignment by build_round_step
    train_fraction: Optional[float] = None
    # federation topology: any registered Topology plugin name
    # (core/topology.py: "hub" | "hierarchical" | "gossip" | custom)
    topology: str = "hub"
    # edge-aggregator count for the hierarchical topology; None means
    # ~sqrt(n_clients) so neither tier degenerates
    n_edges: Optional[int] = None
    # packed trained-unit round path (DESIGN.md §7): carry only the
    # round's selected slot rows through local training, optimizer
    # state and the cross-client reduce.  Dense-masked stays the
    # default; packed is regression-tested bit-comparable against it.
    packed: bool = False
    # fused CUDA aggregation (kernels/masked_agg): "auto" runs the
    # kernel when the round runs on a CUDA device and the plain
    # masked_fedavg elsewhere; "on" routes through the kernel's wrapper
    # (its plain version on CPU tensors), "off" the plain masked_fedavg.
    # The packed path has its own ordered accumulate and ignores this.
    fused_agg: str = "auto"
    # semi-async buffered aggregation (core/async_agg.py, DESIGN.md §8):
    # >0 switches the round loop to FedBuff-style flush rounds — the
    # server buffers this many packed per-client updates (tagged with
    # their origin round) and applies them as one global step.  0 keeps
    # the synchronous loop.
    async_buffer: int = 0
    # stale-delta reweighting rule (register_staleness registry):
    # "polynomial" = FedBuff's 1/(1+s)^alpha, "constant" = no decay
    staleness: str = "polynomial"
    staleness_alpha: float = 0.5
    # simulated client-latency distribution for the async scheduler:
    # "none" | "exponential[:scale]" | "lognormal[:sigma]" |
    # "pareto[:alpha]" (heavy-tailed straggler regime); draws are pure
    # functions of (seed, client, dispatch), so runs replay bit-exactly
    client_delay_dist: str = "none"
    # scored selection (DESIGN.md §11): EMA decay for the per-unit
    # gradient-norm scores a stateful strategy (score_weighted, ...)
    # maintains — s' = score_ema * s + (1 - score_ema) * observed_norm
    score_ema: float = 0.9
    # state-update cadence: fold telemetry into the selection state
    # every this many rounds/flushes (1 = every round; the round
    # counter advances regardless)
    score_every: int = 1
    # --- fleet-scale cohort engine (core/cohort.py, DESIGN.md §13) ---
    # registered fleet size R: >0 attaches the CohortEngine, which
    # samples an n_clients-sized cohort out of R registered clients
    # every round (host state stays O(R) scalars + O(cohort) arrays)
    n_registered: int = 0
    # stream the cohort through the round in chunks of this many
    # clients (0 = single shot); must divide n_clients.  Any chunking
    # is bitwise-equal to the single-shot vmapped round.
    cohort_chunk: int = 0
    # registered ClientSampler name: which R-fleet clients form the
    # round's cohort ("uniform" | "loss_proportional" |
    # "telemetry_driven" | custom)
    client_sampler: str = "uniform"
    # EMA decay of the fleet's per-client loss/grad-norm signals the
    # scored samplers read
    sampler_ema: float = 0.9
    # split the in-flight cohort's local training over this many device
    # groups of the (client,) mesh via shard_map (0 = plain vmap on one
    # device); rows are bitwise independent of the split
    client_shards: int = 0
    # CommAccounting retention cap: keep at most this many rounds of
    # per-client selection rows on the host (0 = unbounded).  Older
    # rounds fold into running totals, so comm_summary stays exact
    # while accounting memory stays O(cap * cohort)
    history_cap: int = 0
    # --- fault injection + defenses (core/faults.py, DESIGN.md §14) ---
    # chaos spec "name:prob[,name:prob[:param]]" over the registered
    # fault kinds (crash, nan, inf, bitflip, scale, duplicate, torn,
    # kill).  "" = no injection.  A spec that names delta faults — even
    # at rate 0 — compiles the corruption transform and validation gate
    # into the packed round step (both bitwise identities at rate 0)
    faults: str = ""
    # validation-gate norm threshold: quarantine any upload whose total
    # valid-slot delta L2 norm exceeds this (0 = finiteness check only,
    # and the gate is compiled in only when delta faults are configured)
    max_delta_norm: float = 0.0
    # async-path permanent packet loss: each (client, seq) update is
    # lost with this probability (seeded, DelayScheduler draw domain) —
    # the engine re-dispatches the client, nothing enters the buffer
    client_drop_prob: float = 0.0
    # crash handling: bounded resampling attempts per crashed cohort
    # slot (common/retry.py jittered backoff) before the slot degrades
    # to a zero-weight hole in the round
    fault_retries: int = 3
    # --- uplink compression codec axis (core/codecs.py, DESIGN.md §16) ---
    # registered codec applied to packed trained-slot deltas before they
    # cross the WAN: "none" | "qint8" | "qint4" | "topk_ef" | custom.
    # "none" compiles no transform at all (bitwise-equal to pre-codec
    # rounds); the others multiply a lossy factor on the structural
    # freeze reduction and CommAccounting bills encoded wire bytes.
    codec: str = "none"
    # top-k keep fraction per slot row for the topk_ef codec
    # (k = max(1, ceil(codec_topk * row_params)))
    codec_topk: float = 0.1

    def __post_init__(self):
        # validate the knobs whose misuse only surfaces rounds later
        # (a train_fraction of 25 instead of 0.25 "works" until the
        # resolved n_train overruns the unit count) at build time
        if self.n_clients < 1:
            raise ValueError(
                f"n_clients must be >= 1, got {self.n_clients}")
        if self.n_train_units < 0:
            raise ValueError(
                f"n_train_units must be >= 0 (0 = use train_fraction), "
                f"got {self.n_train_units}")
        if self.lr <= 0.0:
            raise ValueError(f"lr must be > 0, got {self.lr}")
        if self.prox_mu < 0.0:
            raise ValueError(
                f"prox_mu must be >= 0 (0 = plain FedAvg), got "
                f"{self.prox_mu}")
        if self.async_buffer < 0:
            raise ValueError(
                f"async_buffer must be >= 0 (0 = synchronous), got "
                f"{self.async_buffer}")
        if self.staleness_alpha < 0.0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got "
                f"{self.staleness_alpha}")
        if self.train_fraction is not None \
                and not 0.0 < self.train_fraction <= 1.0:
            raise ValueError(
                f"train_fraction must be in (0, 1] (the paper's 25%/50%/"
                f"75% settings are 0.25/0.5/0.75), got {self.train_fraction}")
        if not 0.0 <= self.score_ema < 1.0:
            raise ValueError(
                f"score_ema must be in [0, 1) (EMA decay; 0 = no "
                f"smoothing), got {self.score_ema}")
        if self.score_every < 1:
            raise ValueError(
                f"score_every must be >= 1, got {self.score_every}")
        if self.n_registered and self.n_registered < self.n_clients:
            raise ValueError(
                f"n_registered={self.n_registered} must be >= the "
                f"cohort size n_clients={self.n_clients} (0 = cohort "
                f"is the whole fleet)")
        if self.cohort_chunk:
            if self.cohort_chunk < 0 or self.n_clients % self.cohort_chunk:
                valid = [d for d in range(1, self.n_clients + 1)
                         if self.n_clients % d == 0]
                raise ValueError(
                    f"cohort_chunk={self.cohort_chunk} must divide the "
                    f"cohort of {self.n_clients} clients so every chunk "
                    f"compiles to one static shape; valid chunk sizes: "
                    f"{valid}")
        if self.client_shards:
            width = self.cohort_chunk or self.n_clients
            if self.client_shards < 0 or width % self.client_shards:
                raise ValueError(
                    f"client_shards={self.client_shards} must divide "
                    f"the vmapped cohort width {width} "
                    f"({'chunk size' if self.cohort_chunk else 'cohort'})")
        if not 0.0 <= self.sampler_ema < 1.0:
            raise ValueError(
                f"sampler_ema must be in [0, 1), got {self.sampler_ema}")
        if self.history_cap < 0:
            raise ValueError(
                f"history_cap must be >= 0 (0 = unbounded), got "
                f"{self.history_cap}")
        if self.history_cap and self.async_buffer:
            raise ValueError(
                "history_cap with async_buffer is not supported yet: "
                "buffered flush accounting keeps per-flush entry rows; "
                "cap the sync/cohort paths or leave history uncapped")
        if self.uses_cohort_engine() and self.async_buffer:
            raise ValueError(
                "the cohort engine (n_registered/cohort_chunk) and the "
                "buffered-async engine (async_buffer) both own the "
                "round loop — set one of them, not both")
        if self.max_delta_norm < 0.0:
            raise ValueError(
                f"max_delta_norm must be >= 0 (0 = finiteness gate "
                f"only), got {self.max_delta_norm}")
        if self.fault_retries < 0:
            raise ValueError(
                f"fault_retries must be >= 0, got {self.fault_retries}")
        if not 0.0 <= self.client_drop_prob < 1.0:
            raise ValueError(
                f"client_drop_prob must be in [0, 1), got "
                f"{self.client_drop_prob}")
        if self.client_drop_prob > 0.0 and not self.async_buffer:
            raise ValueError(
                "client_drop_prob models lost async updates; it needs "
                "the buffered engine (async_buffer > 0)")
        if not 0.0 < self.codec_topk <= 1.0:
            raise ValueError(
                f"codec_topk must be in (0, 1] (keep fraction per slot "
                f"row), got {self.codec_topk}")
        if self.codec != "none":
            # resolve at config time so typos fail before any round runs
            from .codecs import resolve_codec
            cd = resolve_codec(self.codec)
            if not self.packed:
                raise ValueError(
                    "codecs transform packed trained-slot deltas: set "
                    "packed=True")
            if self.topology == "gossip":
                raise ValueError(
                    "the gossip topology exchanges full model replicas "
                    "and has no packed uplink; codecs need hub or "
                    "hierarchical")
            if cd.stateful and self.uses_cohort_engine():
                raise ValueError(
                    "error-feedback codec state is per in-flight client; "
                    "the chunked cohort engine streams stateless chunks — "
                    "use qint8/qint4 there, or drop "
                    "n_registered/cohort_chunk")
        # engines of the reference that the port does not have yet:
        # refuse their switches instead of silently running without them
        defaults = FLConfig.__dataclass_fields__
        for name in _UNPORTED_SWITCHES:
            value = getattr(self, name)
            if value != defaults[name].default:
                raise NotPortedError(
                    f"FLConfig.{name}={value!r}: that engine is not "
                    f"ported to repro_torch yet (leave it at "
                    f"{defaults[name].default!r})")

    def uses_cohort_engine(self) -> bool:
        """Whether the reference would attach the chunk-streaming
        CohortEngine (not ported yet) instead of the synchronous loop."""
        return bool(self.n_registered or self.cohort_chunk)

    def resolve_fused_agg(self, device: Device) -> bool:
        """Whether the round step aggregates through the fused CUDA
        kernel's wrapper (resolved once at build time)."""
        if self.fused_agg == "auto":
            return torch.device(device).type == "cuda"
        if self.fused_agg in ("on", "off"):
            return self.fused_agg == "on"
        raise ValueError(
            f"fused_agg must be 'auto', 'on' or 'off', got "
            f"{self.fused_agg!r}")

    def resolve_n_edges(self) -> int:
        """Edge-aggregator count of the hierarchical topology:
        ``n_edges``, or ~sqrt(n_clients) when it is None."""
        if self.n_edges is not None:
            if not 1 <= self.n_edges <= self.n_clients:
                raise ValueError(f"n_edges={self.n_edges} out of range "
                                 f"for {self.n_clients} clients")
            return self.n_edges
        return max(1, round(self.n_clients ** 0.5))

    def resolve_n_train(self, n_units: int) -> int:
        if self.train_fraction is not None:
            from .freezing import n_train_from_fraction
            return n_train_from_fraction(n_units, self.train_fraction)
        return self.n_train_units

    def resolve_n_slots(self, n_units: int) -> int:
        """Static slot budget of the packed round path (DESIGN.md §7):
        the trained-unit count plus the optional always-trained head."""
        return min(n_units, self.resolve_n_train(n_units)
                   + (1 if self.always_train_head else 0))


# FLConfig switches of engines that are not ported yet
_UNPORTED_SWITCHES = ("async_buffer", "n_registered", "cohort_chunk",
                      "client_shards", "history_cap", "faults",
                      "max_delta_norm", "client_drop_prob")


def build_round_step(loss_fn: Callable, assign: UnitAssignment,
                     fl: FLConfig, loss_kwargs: Optional[Dict] = None,
                     *, strategy: Union[str, SelectionStrategy, None] = None,
                     scores=None,
                     topology: Union[str, Topology, None] = None,
                     device: Device = "cuda"):
    """Returns the round_step function for ``device``.

    ``strategy`` overrides ``fl.strategy`` and ``topology`` overrides
    ``fl.topology`` with a name or an instance (e.g. one constructed in
    user code and never registered).  ``scores`` are static per-unit
    scores for the selection context (the deprecated ``weighted``
    strategy reads them); a stateful strategy's live scores come from
    the ``sel_state`` the server passes each round.
    """
    dev = resolve_device(device)
    topo = resolve_topology(topology if topology is not None
                            else fl.topology)
    return topo.build_round_step(loss_fn, assign, fl, loss_kwargs,
                                 strategy=strategy, scores=scores,
                                 device=dev)


def build_fullmodel_round_step(loss_fn: Callable, fl: FLConfig,
                               loss_kwargs: Optional[Dict] = None,
                               assign: Optional[UnitAssignment] = None,
                               *, device: Device = "cuda"):
    """Deprecated shim: the conventional FedAvg baseline is the
    registered ``full`` strategy on the unified path.

    ``assign`` is optional for call-site compatibility; without it the
    selection matrix in the metrics is (C, 1), a single pseudo-unit
    covering the whole model.
    """
    warnings.warn(
        "build_fullmodel_round_step is deprecated; use "
        "build_round_step with FLConfig(strategy='full') or "
        "Federation.from_config instead", DeprecationWarning, stacklevel=2)
    if assign is None:
        assign = UnitAssignment(1, None, ("model",))
    fl = dataclasses.replace(fl, strategy="full",
                             n_train_units=assign.n_units,
                             prox_mu=0.0, always_train_head=False)
    return build_round_step(loss_fn, assign, fl, loss_kwargs, device=device)
