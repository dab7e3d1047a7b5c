"""The paper's contribution, in PyTorch: federated partial-layer freezing.

strategies — pluggable layer-selection strategies + registry (Alg. 2 line 3)
topology   — pluggable federation topologies + registry (hub,
             hierarchical, gossip)
freezing   — functional wrappers over the strategy registry
masking    — freeze units over param trees, mask trees, slot packing
aggregation— FedAvg / participation-weighted masked FedAvg (dense + packed,
             flat and two-stage)
client     — ClientUpdate (Alg. 2): masked and packed local training
federation — FLConfig + the federated round step
server     — round orchestration (Alg. 1) + composable ServerHooks
session    — the Federation facade (from_config -> fit/evaluate/comm)
comm       — exact transfer-byte accounting (Table 4)
codecs     — uplink compression codec axis over packed trained-slot deltas
"""
from .codecs import (Codec, UnknownCodecError, available_codecs,  # noqa: F401
                     build_codec_transform, codec_unit_bytes,
                     encoded_wire_bytes, get_codec, init_codec_state,
                     register_codec, resolve_codec, unregister_codec)
from .federation import FLConfig, build_round_step  # noqa: F401
from .masking import (LeafUnit, UnitAssignment, apply_mask,  # noqa: F401
                      build_units_flat, mask_tree, slot_gather, slot_merge,
                      slot_plan, unit_param_counts)
from .registry import NotPortedError  # noqa: F401
from .server import (CommAccounting, RoundLogger, RoundRecord,  # noqa: F401
                     Server, ServerHook, StragglerDropout)
from .session import Federation, ModelSpec  # noqa: F401
from .strategies import (Replay, SelectionContext,  # noqa: F401
                         SelectionStrategy, Synchronized,
                         UnknownStrategyError, get_strategy,
                         register_strategy, resolve_strategy)
from .topology import (Topology, UnknownTopologyError,  # noqa: F401
                       get_topology, register_topology, resolve_topology,
                       ring_mixing_matrix)
