"""Checkpoints of a federated run, in the reference's on-disk format."""
from .store import (  # noqa: F401
    FORMAT_VERSION, CheckpointError, CheckpointVersionError,
    CorruptCheckpointError, load_metadata, load_pytree,
    restore_server_state, save_pytree, save_server_state,
)
