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
session    — the Federation facade (from_config -> fit/evaluate/comm)
comm       — exact transfer-byte accounting (Table 4)
codecs     — uplink compression codec axis over packed trained-slot deltas
"""
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
