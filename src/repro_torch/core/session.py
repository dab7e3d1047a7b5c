"""The ``Federation`` facade: one object that owns a federated run.

``Federation.from_config`` wires model init -> unit assignment ->
loader -> ``build_round_step`` -> ``Server`` once::

    fed = Federation.from_config(spec, fl, data=loader, eval_fn=acc)
    fed.fit(rounds=20, log_every=1)
    fed.comm_summary()

``spec`` is a zoo ``ArchConfig`` (``repro_torch.configs``: params from
``get_model(cfg).init_params`` drawn on the run's device, one freeze
unit per layer from ``build_units_zoo``) or a :class:`ModelSpec` — the
paper's VGG16, IMDB and CASA models live in
``repro_torch.models.paper_models``. Strategy and topology are
registered plugin names in ``fl.strategy`` / ``fl.topology``; pass
``strategy=`` / ``topology=`` to override either with an instance (a
replay strategy in the parity tests, for one). The run lives on
``device`` — the GPU unless the caller asks for the CPU.

Scored selection (DESIGN.md §11) needs no knob beyond the strategy
name: a stateful strategy (``score_weighted``, ``depth_dropout``,
``successive``) makes the ``Server`` own a ``SelectionState``, turns on
the gradient-norm telemetry in the round step, and checkpoints carry
the state.  ``save`` / ``restore`` write and read the reference's
checkpoint format (``repro_torch.ckpt``); a resumed run continues
bitwise.

The round engines attach here, in the reference's order: the fault
injector (``fl.faults``, ``core/faults.py``), the buffered-async engine
(``fl.async_buffer``, with the validation gate wrapped around its flush
when ``faults.gate_enabled``), the chunk-streamed cohort engine
(``fl.n_registered`` / ``fl.cohort_chunk``) and last the ``ChaosHook``,
so an injected kill fires after a user ``Checkpointer`` saved.
``incarnation`` feeds the kill draw (``faults.run_with_restarts``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ..common import Device, resolve_device
from ..data import FederatedLoader
from .federation import FLConfig, build_round_step
from .masking import UnitAssignment, build_units_flat, build_units_zoo
from .server import RoundRecord, Server, ServerHook
from .strategies import SelectionStrategy
from .topology import Topology, resolve_topology


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A model described by plain functions.

    ``init_params(gen)`` draws CPU params from a ``torch.Generator``;
    ``unit_order`` is either the explicit freeze-unit order (top-level
    param keys) or a callable ``params -> order`` (e.g.
    ``paper_models.vgg16_units``).  ``conv_spatial`` is the spatial rank
    of the model's conv kernels (2 for VGG16, 1 for IMDB's conv1d),
    which checkpoints need to convert layouts (``convert.py``).
    """
    name: str
    init_params: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    loss_fn: Callable                               # (params, batch) -> (loss, aux)
    unit_order: Union[Sequence[str], Callable[[Any], Sequence[str]]]
    conv_spatial: int = 2


class Federation:
    """Owns params, unit assignment, round step, server, data."""

    def __init__(self, *, loss_fn: Callable, params, assign: UnitAssignment,
                 fl: FLConfig, loader: Optional[FederatedLoader] = None,
                 eval_fn: Optional[Callable] = None,
                 loss_kwargs: Optional[Dict] = None, seed: int = 0,
                 dropout_rate: float = 0.0,
                 hooks: Sequence[ServerHook] = (),
                 strategy: Union[str, SelectionStrategy, None] = None,
                 scores=None,
                 topology: Union[str, Topology, None] = None,
                 conv_spatial: int = 2, device: Device = "cuda",
                 incarnation: int = 0):
        self.device = resolve_device(device)
        self.fl = fl
        self.assign = assign
        self.loader = loader
        self.topology = resolve_topology(topology if topology is not None
                                         else fl.topology)
        round_step = build_round_step(loss_fn, assign, fl, loss_kwargs,
                                      strategy=strategy, scores=scores,
                                      topology=self.topology,
                                      device=self.device)
        self.server = Server(round_step, assign, fl, params,
                             eval_fn=eval_fn, seed=seed,
                             dropout_rate=dropout_rate, hooks=hooks,
                             topology=self.topology, strategy=strategy,
                             conv_spatial=conv_spatial, device=self.device)
        # fault-injection chaos axis (DESIGN.md §14): the injector is a
        # pure function of (seed, incarnation, coordinates), so a
        # restarted process with incarnation+1 replays a *different*
        # kill schedule while the training streams stay identical
        injector = None
        if fl.faults:
            from .faults import FaultInjector
            injector = FaultInjector(fl.faults, seed=seed,
                                     incarnation=incarnation)
        self.server.fault_injector = injector
        if fl.async_buffer:
            # semi-async buffered rounds (DESIGN.md §8): the engine owns
            # the simulated-delay scheduler, per-version selections and
            # the FedBuff-style buffer; one fit "round" = one flush
            from .async_agg import AsyncRoundEngine, build_cohort_step
            from .faults import gate_enabled
            select_fn, cohort_fn, _ = build_cohort_step(
                loss_fn, assign, fl, loss_kwargs, strategy=strategy,
                scores=scores)
            base_flush = self.topology.build_buffered_flush(assign, fl)
            flush_fn, gated = base_flush, False
            if gate_enabled(fl):
                from .aggregation import gate_packed_updates

                def flush_fn(g, pdeltas, rows, valid, sel, weights,
                             clients, _base=base_flush):
                    pdeltas, gw, quar = gate_packed_updates(
                        assign, pdeltas, valid, weights,
                        fl.max_delta_norm)
                    return _base(g, pdeltas, rows, valid, sel, gw,
                                 clients), quar
                gated = True
            self.server.attach_async_engine(AsyncRoundEngine(
                self.server, assign, fl, select_fn=select_fn,
                cohort_fn=cohort_fn, flush_fn=flush_fn,
                seed=seed, gated=gated))
        if fl.uses_cohort_engine():
            # fleet-scale cohort engine (DESIGN.md §13): samples the
            # round's cohort out of n_registered clients and streams it
            # through the round in cohort_chunk-sized chunks (mutually
            # exclusive with async_buffer — FLConfig validates)
            from .cohort import CohortEngine, build_cohort_programs
            programs = build_cohort_programs(
                loss_fn, assign, fl, loss_kwargs, strategy=strategy,
                scores=scores, topology=self.topology)
            self.server.attach_cohort_engine(CohortEngine(
                self.server, assign, fl, programs=programs, seed=seed))
        if injector is not None:
            # appended LAST so a user Checkpointer hook has already
            # saved the round before an injected kill can raise
            from .faults import ChaosHook
            self.server.hooks.append(ChaosHook(injector))

    # -- construction -----------------------------------------------------

    @classmethod
    def from_config(cls, cfg, fl: FLConfig, *, data=None, seed: int = 0,
                    eval_fn: Optional[Callable] = None,
                    loss_kwargs: Optional[Dict] = None,
                    batch_size: int = 8, steps_per_round: int = 2,
                    device: Device = "cuda", **kwargs) -> "Federation":
        """Wire a full federated run from a config.

        ``cfg`` is a zoo ``ArchConfig`` or a :class:`ModelSpec`.  A zoo
        model's params are drawn on ``device`` from a generator seeded
        with ``seed``; its ``loss_kwargs`` default to the reference's
        host default (``attn_impl="reference"``, nothing for the ``ssm``
        family); launchers pass their own (``launch.steps.
        default_loss_kwargs``).  ``data`` is a :class:`FederatedLoader`,
        or a list of per-client array dicts (then
        ``batch_size``/``steps_per_round`` apply), or None (supply
        batches to ``run_round`` yourself).  Remaining ``kwargs`` go to
        the constructor (hooks, dropout_rate, strategy, scores,
        topology).
        """
        dev = resolve_device(device)
        conv_spatial = 2
        if isinstance(cfg, ModelSpec):
            params = cfg.init_params(torch.Generator().manual_seed(seed))
            order = cfg.unit_order(params) if callable(cfg.unit_order) \
                else list(cfg.unit_order)
            assign = build_units_flat(params, order)
            loss_fn = cfg.loss_fn
            conv_spatial = cfg.conv_spatial
        elif hasattr(cfg, "family"):
            from ..models import get_model
            model = get_model(cfg)
            params = model.init_params(
                torch.Generator(device=dev).manual_seed(seed))
            assign = build_units_zoo(cfg, params)
            loss_fn = model.loss_fn
            if loss_kwargs is None:
                loss_kwargs = {} if cfg.family == "ssm" else \
                    {"attn_impl": "reference"}
        else:
            raise TypeError(
                f"cfg must be an ArchConfig or ModelSpec, got {type(cfg)}")
        loader = data
        if data is not None and not isinstance(data, FederatedLoader):
            loader = FederatedLoader(list(data), batch_size=batch_size,
                                     steps_per_round=steps_per_round,
                                     key=seed)
        return cls(loss_fn=loss_fn, params=params, assign=assign, fl=fl,
                   loader=loader, eval_fn=eval_fn, loss_kwargs=loss_kwargs,
                   seed=seed, conv_spatial=conv_spatial, device=dev,
                   **kwargs)

    # -- the run ----------------------------------------------------------

    def fit(self, rounds: int, *, log_every: int = 0,
            weights=None) -> List[RoundRecord]:
        """Run ``rounds`` federated rounds off the attached loader.

        In buffered-async mode (``fl.async_buffer > 0``) a "round" is
        one buffer flush, and the loader is indexed by each client's own
        dispatch window (the engine carries per-client counters across
        ``fit`` calls and restores), not a shared round counter.  In
        cohort-engine mode the loader holds the registered fleet and
        serves one chunk of sampled clients at a time.
        """
        if self.loader is None:
            raise ValueError("Federation has no data attached; pass "
                             "data= to from_config or use run_round")
        if weights is None:
            weights = torch.as_tensor(self.loader.weights())
        if self.server.cohort_engine is not None:
            # indexed by absolute round (resume-safe): no history base
            def chunk(r, ids):
                return {k: torch.as_tensor(v, device=self.device)
                        for k, v in self.loader.client_batches(
                            r, ids).items()}

            return self.server.run(rounds, chunk, weights=weights,
                                   log_every=log_every)
        base = 0 if self.server.async_engine is not None \
            else len(self.server.history)

        def batches(r):
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in self.loader.round_batches(base + r).items()}

        return self.server.run(rounds, batches, weights=weights,
                               log_every=log_every)

    def run_round(self, client_batches, weights=None) -> RoundRecord:
        return self.server.run_round(client_batches, weights)

    def evaluate(self) -> Optional[float]:
        if self.server.eval_fn is None:
            return None
        return float(self.server.eval_fn(self.server.global_params()))

    def comm_summary(self) -> Dict[str, float]:
        return self.server.comm_summary()

    # -- state ------------------------------------------------------------

    @property
    def params(self):
        """Single-model view (the mean replica under gossip)."""
        return self.server.global_params()

    @property
    def state(self):
        """The raw topology state the server carries across rounds."""
        return self.server.params

    @property
    def history(self) -> List[RoundRecord]:
        return self.server.history

    def save(self, path: str, extra: Optional[Dict] = None) -> None:
        from ..ckpt import save_server_state
        save_server_state(path, self.server, extra=extra)

    def restore(self, path: str) -> Dict:
        from ..ckpt import restore_server_state
        return restore_server_state(path, self.server)
