import os
import sys

# tests run on the single real CPU device (the 512-device XLA_FLAGS hack is
# confined to launch/dryrun.py subprocesses — see the dry-run contract).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # offline container: fall back to the deterministic stub
    import _hypothesis_stub
    _hypothesis_stub.install()

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config, list_configs


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running subprocess/compile tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def reduced_cfg(name):
    return get_config(name).reduced()


def tiny_batch(cfg, key, b=2, s=32):
    batch = {"tokens": jax.random.randint(key, (b, s), 0, cfg.vocab),
             "labels": jax.random.randint(key, (b, s), 0, cfg.vocab)}
    if cfg.family == "vlm":
        from repro.models.transformer import vit_width
        batch["patches"] = jax.random.normal(
            key, (b, cfg.n_patches, vit_width(cfg)))
    if cfg.family == "audio":
        batch["frames"] = jax.random.normal(key, (b, cfg.enc_seq, cfg.d_model))
    return batch


ALL_ARCHS = list(list_configs())
