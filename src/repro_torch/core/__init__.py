"""The paper's contribution, in PyTorch: federated partial-layer freezing.

strategies — pluggable layer-selection strategies + registry (Alg. 2
             line 3), incl. the scored family and its SelectionState
topology   — pluggable federation topologies + registry (hub,
             hierarchical, gossip)
freezing   — functional wrappers over the strategy registry
masking    — freeze units over param trees, mask trees, slot packing
aggregation— FedAvg / participation-weighted masked FedAvg (dense + packed,
             flat and two-stage)
client     — ClientUpdate (Alg. 2): masked and packed local training
federation — FLConfig + the federated round step
server     — round orchestration (Alg. 1) + composable ServerHooks
             (accounting, stragglers, logging, Checkpointer)
async_agg  — FedBuff-style semi-async buffered rounds + staleness registry
cohort     — fleet-scale chunk-streamed cohort engine + sampler registry
session    — the Federation facade (from_config -> fit/evaluate/comm)
comm       — exact transfer-byte accounting (Table 4), per topology
faults     — seeded fault-injection chaos axis + fault-tolerant defenses
codecs     — uplink compression codec axis over packed trained-slot deltas
"""
from . import (freezing, masking, aggregation, client, federation,  # noqa: F401
               server, comm, strategies, session, topology, async_agg,
               cohort, faults, codecs)
from .codecs import (Codec, UnknownCodecError, available_codecs,  # noqa: F401
                     build_codec_transform, codec_unit_bytes,
                     encoded_wire_bytes, get_codec, init_codec_state,
                     register_codec, resolve_codec, unregister_codec)
from .federation import (FLConfig, build_fullmodel_round_step,  # noqa: F401
                         build_round_step)
from .freezing import (n_train_from_fraction, select_clients,  # noqa: F401
                       select_fixed_last, select_uniform, select_weighted)
from .masking import (LeafUnit, NormHook, UnitAssignment,  # noqa: F401
                      apply_mask, build_units_flat, dense_norm_hook,
                      mask_tree, packed_norm_hook, slot_gather, slot_merge,
                      slot_plan, unit_param_counts, unit_sqnorm,
                      unit_sqnorm_packed)
from .registry import NotPortedError  # noqa: F401
from .server import (Checkpointer, CommAccounting, RoundLogger,  # noqa: F401
                     RoundRecord, Server, ServerHook, StragglerDropout)
from .session import Federation, ModelSpec  # noqa: F401
from .strategies import (NormTelemetry, Replay,  # noqa: F401
                         ScoredStrategy, SelectionContext, SelectionState,
                         SelectionStrategy, Synchronized,
                         UnknownStrategyError, get_strategy,
                         register_strategy, registered_strategies,
                         resolve_strategy, unregister_strategy)
from .topology import (Topology, UnknownTopologyError,  # noqa: F401
                       get_topology, register_topology,
                       registered_topologies, resolve_topology,
                       ring_mixing_matrix, unregister_topology)
from .async_agg import (AsyncRoundEngine, BufferedAggregator,  # noqa: F401
                        BufferedUpdate, DelayScheduler,
                        UnknownStalenessError, build_cohort_step,
                        get_staleness, register_staleness,
                        registered_staleness, staleness_weights,
                        unregister_staleness)
from .cohort import (ClientSampler, CohortContext, CohortEngine,  # noqa: F401
                     FleetState, UnknownClientSamplerError,
                     build_cohort_programs, fleet_init,
                     get_client_sampler, register_client_sampler,
                     registered_client_samplers, resolve_client_sampler,
                     unregister_client_sampler)
from .faults import (ChaosHook, ClientCrashed, Fault, FaultInjector,  # noqa: F401
                     ServerKilled, UnknownFaultError, chaos_inject,
                     get_fault, parse_faults, register_fault,
                     registered_faults, run_with_restarts,
                     unregister_fault)
