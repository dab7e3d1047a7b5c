"""The port's selection strategies, FLConfig, registries, masking, comm
accounting and tree plumbing against the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree_paths as r_tree_paths
from repro.core import comm as rcomm
from repro.core import federation as rfed
from repro.core import freezing as rfreezing
from repro.core import masking as rmasking
from repro.core import strategies as rstrat
from repro.core import topology as rtopo
from repro_torch import common as tcommon
from repro_torch.core import comm, federation, freezing, masking
from repro_torch.core import strategies, topology
from repro_torch.core.registry import NotPortedError

U, NTRAIN, NCLI = 14, 5, 6


def _ctx():
    return strategies.SelectionContext(NCLI, U, NTRAIN)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_contract(seed):
    s1 = strategies.get_strategy("uniform").select(
        torch.Generator().manual_seed(seed), _ctx())
    s2 = strategies.get_strategy("uniform").select(
        torch.Generator().manual_seed(seed), _ctx())
    assert s1.shape == (NCLI, U) and s1.dtype == torch.float32
    assert torch.equal(s1.sum(1), torch.full((NCLI,), float(NTRAIN)))
    assert set(s1.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(s1, s2)                       # seeded repeatability
    assert len({tuple(r) for r in s1.tolist()}) > 1  # independent rows


@pytest.mark.parametrize("name", ["fixed_last", "full"])
def test_deterministic_rows_equal_reference(name):
    rctx = rstrat.SelectionContext(n_clients=NCLI, n_units=U, n_train=NTRAIN)
    ref = np.asarray(rstrat.get_strategy(name).select(
        jax.random.PRNGKey(0), rctx))
    got = strategies.get_strategy(name).select(None, _ctx())
    np.testing.assert_array_equal(got.numpy(), ref)
    assert strategies.get_strategy(name).dense == \
        rstrat.get_strategy(name).dense


def test_synchronized_rows_shared():
    sel = strategies.resolve_strategy("uniform", synchronized=True).select(
        torch.Generator().manual_seed(0), _ctx())
    assert torch.equal(sel, sel[:1].expand_as(sel))
    assert sel[0].sum() == NTRAIN
    named = strategies.get_strategy("synchronized").select(
        torch.Generator().manual_seed(0), _ctx())
    assert torch.equal(named, named[:1].expand_as(named))


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75, 0.01, 1.0])
def test_n_train_from_fraction_equal(frac):
    assert freezing.n_train_from_fraction(U, frac) == \
        rfreezing.n_train_from_fraction(U, frac)


def test_replay_exhausts_and_checks_shape():
    rows = np.eye(U, dtype=np.float32)[:NCLI]
    rep = strategies.Replay([rows])
    np.testing.assert_array_equal(rep.select(None, _ctx()).numpy(), rows)
    with pytest.raises(IndexError):
        rep.select(None, _ctx())
    with pytest.raises(ValueError, match="shape"):
        strategies.Replay([rows[:2]]).select(None, _ctx())


def test_unknown_names_match_reference_message():
    with pytest.raises(strategies.UnknownStrategyError) as got:
        strategies.get_strategy("nope")
    assert str(got.value).startswith("unknown selection strategy 'nope'")
    with pytest.raises(topology.UnknownTopologyError) as got:
        topology.get_topology("nope")
    with pytest.raises(rtopo.UnknownTopologyError) as ref:
        rtopo.get_topology("nope")
    assert str(got.value) == \
        "unknown topology 'nope'; registered: gossip, hierarchical, hub"
    assert str(ref.value).startswith("unknown topology 'nope'")


@pytest.mark.parametrize("name", ["hub", "hierarchical", "gossip"])
def test_topologies_resolve(name):
    got, ref = topology.resolve_topology(name), rtopo.resolve_topology(name)
    assert got.name == ref.name == name
    assert type(got).__name__ == type(ref).__name__
    assert got.stateful == ref.stateful == (name == "gossip")
    assert topology.get_topology(name) is got


def test_flconfig_fields_and_defaults_equal_reference():
    ref = {f.name: f.default for f in dataclasses.fields(rfed.FLConfig)}
    got = {f.name: f.default for f in dataclasses.fields(federation.FLConfig)}
    assert got == ref


@pytest.mark.parametrize("kw", [
    {"n_clients": 0}, {"n_clients": 2, "n_train_units": -1},
    {"n_clients": 2, "lr": 0.0}, {"n_clients": 2, "prox_mu": -1.0},
    {"n_clients": 2, "train_fraction": 25.0},
    {"n_clients": 2, "score_ema": 1.0}, {"n_clients": 2, "score_every": 0},
    {"n_clients": 4, "n_registered": 2},
    {"n_clients": 4, "cohort_chunk": 3},
    {"n_clients": 2, "client_drop_prob": 0.5},
    {"n_clients": 2, "codec_topk": 0.0},
])
def test_flconfig_validators_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        rfed.FLConfig(**kw)
    with pytest.raises(ValueError) as got:
        federation.FLConfig(**kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    {"max_delta_norm": 1.0, "packed": True}, {"async_buffer": 2},
    {"n_registered": 8}, {"cohort_chunk": 2}, {"client_shards": 2},
    {"history_cap": 3}, {"faults": "crash:0.1"},
    {"faults": "nan:0.1", "packed": True, "codec": "qint8"},
])
def test_unported_engines_raise(kw):
    rfed.FLConfig(n_clients=4, **kw)               # valid in the reference
    with pytest.raises(NotPortedError, match="not ported"):
        federation.FLConfig(n_clients=4, **kw)


@pytest.mark.parametrize("mode,device,want", [
    ("auto", "cuda", True), ("auto", "cpu", False), ("on", "cpu", True),
    ("off", "cuda", False)])
def test_resolve_fused_agg(mode, device, want):
    fl = federation.FLConfig(n_clients=2, fused_agg=mode)
    assert fl.resolve_fused_agg(device) is want


def test_resolve_fused_agg_rejects_typos():
    with pytest.raises(ValueError, match="fused_agg"):
        federation.FLConfig(n_clients=2, fused_agg="yes").resolve_fused_agg(
            "cpu")


def _nested():
    rng = np.random.default_rng(0)
    return {"conv10": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                       "b": rng.normal(size=(3,)).astype(np.float32)},
            "conv2": {"w": rng.normal(size=(4,)).astype(np.float32)},
            "dense0": {"b": np.zeros((), np.float32),
                       "w": rng.normal(size=(3, 2)).astype(np.float32)}}


def test_flatten_order_matches_jax():
    flat = tcommon.flatten(_nested())
    assert tuple(flat) == r_tree_paths(_nested())
    assert tcommon.tree_paths(dict(reversed(list(flat.items())))) == \
        r_tree_paths(_nested())
    back = tcommon.unflatten(flat)
    assert tcommon.flatten(back).keys() == flat.keys()


def test_tree_arithmetic_and_counts():
    t = {k: torch.as_tensor(v) for k, v in tcommon.flatten(_nested()).items()}
    s = tcommon.tree_add(t, t)
    d = tcommon.tree_sub(s, t)
    assert all(torch.equal(d[k], t[k]) for k in t)
    st = tcommon.tree_stack([t, s])
    assert st["conv2/w"].shape == (2, 4)
    assert tcommon.param_count(t) == 6 + 3 + 4 + 1 + 6
    assert tcommon.param_bytes(t) == 4 * tcommon.param_count(t)
    assert tcommon.param_bytes(t, 2) == 2 * tcommon.param_count(t)


def _assignments():
    nested = _nested()
    order = ["conv2", "conv10", "dense0"]
    flat = {k: torch.as_tensor(v) for k, v in tcommon.flatten(nested).items()}
    return (rmasking.build_units_flat(nested, order),
            masking.build_units_flat(flat, order), nested, flat)


def test_masking_matches_reference():
    ra, ta, nested, flat = _assignments()
    assert ta.n_units == ra.n_units and ta.unit_names == ra.unit_names
    sel = np.asarray([1.0, 0.0, 1.0], np.float32)
    rmask = rmasking.mask_tree(ra, jnp.asarray(sel), nested)
    tmask = masking.mask_tree(ta, torch.as_tensor(sel), flat)
    for path, m in tcommon.flatten(
            jax.tree_util.tree_map(np.asarray, rmask)).items():
        np.testing.assert_array_equal(tmask[path].numpy(), m)
    rm = tcommon.flatten(jax.tree_util.tree_map(
        np.asarray, rmasking.apply_mask(rmask, nested)))
    tm = masking.apply_mask(tmask, flat)
    for path in rm:
        np.testing.assert_array_equal(tm[path].numpy(), rm[path])
    np.testing.assert_array_equal(masking.unit_param_counts(ta, flat),
                                  rmasking.unit_param_counts(ra, nested))
    with pytest.raises(ValueError, match="not in unit order"):
        masking.build_units_flat(flat, ["conv2"])


def test_stacked_leaf_masks():
    lu = masking.LeafUnit("stacked", 1, 2)
    assign = masking.UnitAssignment(6, {"blocks/w": lu}, tuple("abcdef"))
    params = {"blocks/w": torch.ones(3, 2)}
    sel = torch.as_tensor([0.0, 1.0, 0.0, 0.0, 0.0, 1.0])
    np.testing.assert_array_equal(
        masking.mask_tree(assign, sel, params)["blocks/w"].numpy(),
        [1.0, 0.0, 1.0])
    assert list(masking.unit_param_counts(assign, params)) == \
        [0, 2, 0, 2, 0, 2]


@pytest.mark.parametrize("downlink", ["full", "selected"])
def test_hub_round_bytes_exact(downlink):
    rng = np.random.default_rng(0)
    sel = rng.integers(0, 2, (NCLI, U)).astype(np.float32)
    ub = rng.integers(1, 10_000, U) * 4
    assert comm.hub_round_bytes(sel, ub, True, downlink) == \
        rcomm.hub_round_bytes(sel, ub, True, downlink)


@pytest.mark.parametrize("c,e", [(6, 2), (7, 3), (4, 4)])
def test_edge_membership_exact(c, e):
    np.testing.assert_array_equal(comm.edge_membership(c, e),
                                  rcomm.edge_membership(c, e))


def test_table4_row_exact():
    ra, ta, nested, flat = _assignments()
    hist = np.random.default_rng(1).integers(0, 2, (4, 5, 3)) \
        .astype(np.float32)
    assert comm.table4_row(ta, flat, hist) == \
        rcomm.table4_row(ra, nested, hist)
    np.testing.assert_array_equal(comm.unit_bytes(ta, flat),
                                  rcomm.unit_bytes(ra, nested))
