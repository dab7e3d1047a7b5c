"""``FLConfig.client_shards`` on every round path of the port, over 2 gloo
ranks on the CPU (``torch_ranks.spawn``; no process group in this
process), on the toy MLP (6 stacked blocks, 4 clients, 2 local steps,
straggler dropout 0.25): the dense hub through K1's wrapper (each rank's
clients written into its rows of the tile buffer, the others gathered),
the masked loop with scoring telemetry, the ``full`` strategy, the
hierarchical fused and packed rounds, the packed qint8 stage, the
cohort engine in chunks of 2 and the async engine with a buffer of 2
(whose dispatches of one client leave a rank's block empty).  Every
rank's params, losses, selections and bill are bitwise the port's
unsharded run's, and so every rank's equal the others'; the zoo
facade's params from a seed are bitwise equal on both ranks.  The
unsharded run stays within 2e-5 of the reference's round step on the
same selection (dense hub and packed).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten, unflatten
from repro_torch.core import FLConfig, Replay, build_round_step
from repro_torch.models import toy

import torch_ranks

TOL = 2e-5
PATHS = sorted(torch_ranks.ROUND_PATHS)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return torch_ranks.spawn("client_shard_runs", 2,
                             tmp_path_factory.mktemp("ranks"), shards=2)


def _same(a, b):
    (pa, la, sa, ca), (pb, lb, sb, cb) = a, b
    assert list(pa) == list(pb)
    assert all(torch.equal(pa[p], pb[p]) for p in pa)
    assert la == lb and ca == cb
    assert len(sa) == len(sb) and all(np.array_equal(x, y)
                                      for x, y in zip(sa, sb))


@pytest.mark.parametrize("name", PATHS)
def test_sharded_path_bitwise_unsharded(sharded, name):
    want = torch_ranks.toy_run(name, 0)
    for rank in sharded:
        _same(rank[name], want)
    widths = sharded[0]["widths"][name]
    assert widths, f"{name}: the cohort stage never ran through the mesh"


def test_async_empty_blocks(sharded):
    """The async engine dispatches fewer clients than shards: a rank with
    nothing to train takes the other's rows."""
    assert min(sharded[0]["widths"]["async buffer 2"]) < 2


def test_ranks_build_the_same_params(sharded):
    a, b = sharded[0]["server params"], sharded[1]["server params"]
    assert list(a) == list(b)
    assert all(torch.equal(a[p], b[p]) for p in a)


def test_client_shards_need_a_process_group():
    p, assign, _ = torch_ranks.toy_setup()
    fl = FLConfig(n_clients=4, train_fraction=0.5, client_shards=2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_round_step(functools.partial(toy.toy_loss, device="cpu"),
                         assign, fl, device="cpu")


def test_gossip_refuses_client_shards():
    p, assign, _ = torch_ranks.toy_setup()
    fl = FLConfig(n_clients=4, train_fraction=0.5, topology="gossip",
                  client_shards=2)
    with pytest.raises(ValueError, match="gossip carries per-client"):
        build_round_step(functools.partial(toy.toy_loss, device="cpu"),
                         assign, fl, device="cpu")


@pytest.mark.parametrize("packed", [False, True])
def test_unsharded_round_matches_reference(packed):
    """One round of the port (no shards) against the reference's jitted
    round step on the same params, batches and selection."""
    p, assign, b = torch_ranks.toy_setup()
    w = np.asarray([1.0, 0.0, 1.5, 0.5], np.float32)
    kw = dict(n_clients=torch_ranks.C, train_fraction=0.5, lr=1e-2,
              packed=packed, fused_agg="off")
    rp = jax.tree_util.tree_map(jnp.asarray, unflatten(
        {q: x.numpy() for q, x in p.items()}))
    rb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    step = jax.jit(r_build_round_step(r_toy_loss, r_toy_units(rp),
                                      RFLConfig(**kw)))
    new, m = step(rp, rb, jnp.asarray(w), jax.random.PRNGKey(5))
    sel = np.asarray(m["sel"])
    port = build_round_step(functools.partial(toy.toy_loss, device="cpu"),
                            assign, FLConfig(**kw), strategy=Replay([sel]),
                            device="cpu")
    got, gm = port(dict(p), b, torch.as_tensor(w), None)
    np.testing.assert_array_equal(gm["sel"].numpy(), sel)
    for q, x in flatten(jax.tree_util.tree_map(np.asarray, new)).items():
        np.testing.assert_allclose(got[q].numpy(), x, atol=TOL, rtol=TOL,
                                   err_msg=q)
    assert abs(float(gm["loss_mean"]) - float(m["loss_mean"])) < TOL
