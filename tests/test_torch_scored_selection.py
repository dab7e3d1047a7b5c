"""The port's scored selection against the reference: the strategies'
rows with the reference's Gumbel noise injected (exact), the state
update on the reference's own cases (1e-6), the gradient-norm telemetry
(rtol 1e-5), and scored rounds on hub, hierarchical and gossip with the
reference's noise injected (selections exact, params 2e-5, state 1e-6).

The toy MLP (6 stacked blocks, d 16, hidden 32, 4 clients, a
zero-weight client) carries both leaf kinds.  Rounds use Adam at lr
1e-2 and one local step, as the other round parity tests do.  The
reference's runs are computed once per module.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import Federation as RFederation
from repro.core import NormTelemetry as RNormTelemetry
from repro.core import ScoredStrategy as RScoredStrategy
from repro.core import SelectionContext as RSelectionContext
from repro.core import SelectionState as RSelectionState
from repro.core import ServerHook as RServerHook
from repro.core import get_strategy as r_get_strategy
from repro.core import get_topology as r_get_topology
from repro.core.freezing import (select_fixed_last as r_select_fixed_last,
                                 select_weighted as r_select_weighted)
from repro.core.masking import slot_plan as r_slot_plan
from repro.core.masking import unit_sqnorm as r_unit_sqnorm
from repro.core.masking import unit_sqnorm_packed as r_unit_sqnorm_packed
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten
from repro_torch.convert import from_reference
from repro_torch.core import (FLConfig, Federation, NormTelemetry,
                              ScoredStrategy, SelectionContext,
                              SelectionState, Server, ServerHook,
                              UnknownStrategyError, UnknownTopologyError,
                              build_fullmodel_round_step, build_round_step,
                              get_strategy, get_topology, register_topology,
                              registered_strategies, registered_topologies,
                              select_clients, select_fixed_last,
                              select_uniform, select_weighted,
                              unregister_strategy, unregister_topology)
from repro_torch.core import masking
from repro_torch.models import toy

C, LR = 4, 1e-2
TOL = 2e-5             # the round parity bar of the other round tests
STATE_TOL = 1e-6       # SelectionState against the reference's
NORM_RTOL = 1e-5       # per-unit squared gradient norms (telemetry)
MARGIN = 1e-4          # n_train-th vs next perturbed score: no near tie
W = np.asarray([1.0, 0.0, 1.5, 0.5], np.float32)     # a zero-weight client
SEED = 5
ROUNDS = 3
tloss = functools.partial(toy.toy_loss, device="cpu")
SCORED = ("score_weighted", "depth_dropout", "successive")


def _np_flat(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, tol, what=""):
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), w, atol=tol,
                                   rtol=tol, err_msg=f"{what} {path}")


def _injected(strategy, rows):
    """A fresh instance of ``strategy`` whose Gumbel draws are ``rows``
    (numpy (U,) rows, consumed in order)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        strat = type(get_strategy(strategy))()
    it = iter(rows)
    strat.gumbel = lambda gen, n: torch.tensor(np.asarray(next(it)))
    return strat


def _ref_noise(round_key, n_units):
    """The reference's per-client Gumbel rows for one round key."""
    return [np.asarray(jax.random.gumbel(k, (n_units,)))
            for k in jax.random.split(round_key, C)]


def _round_keys(seed, rounds):
    """The round keys a reference Server seeded with ``seed`` draws."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, rk = jax.random.split(key)
        out.append(rk)
    return out


@pytest.fixture(scope="module")
def toy_setup():
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    batches = r_toy_batches(jax.random.PRNGKey(1), n_clients=C, steps=1,
                            batch=4, d=16, out=4)
    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    return {"rp": rp, "r_assign": r_toy_units(rp), "tp": tp,
            "assign": toy.toy_units(tp), "batches": batches,
            "tb": {k: torch.as_tensor(np.asarray(v))
                   for k, v in batches.items()}}


# -- registry ------------------------------------------------------------------

def test_scored_strategies_registered():
    assert {"uniform", "fixed_last", "weighted", "full", "synchronized",
            *SCORED} <= set(registered_strategies())
    for name in SCORED:
        assert get_strategy(name).stateful
        assert r_get_strategy(name).stateful
    assert not get_strategy("uniform").stateful


def test_unregister_strategy_and_topology():
    class Mine(ScoredStrategy):
        name = "_test_mine"
    from repro_torch.core import register_strategy
    register_strategy(Mine)
    assert "_test_mine" in registered_strategies()
    unregister_strategy("_test_mine")
    assert "_test_mine" not in registered_strategies()
    unregister_strategy("_test_mine")             # absent: a no-op
    register_topology(type(get_topology("hub"))(), name="_test_hub")
    assert "_test_hub" in registered_topologies()
    unregister_topology("_test_hub")
    assert "_test_hub" not in registered_topologies()
    assert {"hub", "hierarchical", "gossip"} <= set(registered_topologies())


@pytest.mark.parametrize("kind", ["strategy", "topology"])
def test_unknown_name_errors_equal_reference(kind):
    get, rget, err = ((get_strategy, r_get_strategy, UnknownStrategyError)
                      if kind == "strategy" else
                      (get_topology, r_get_topology, UnknownTopologyError))
    with pytest.raises(err) as got:
        get("nope")
    with pytest.raises(ValueError) as want:
        rget("nope")
    # the reference lists its own registry; the port's lists the same
    # built-ins (custom names registered by other tests aside)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_weighted_is_deprecated():
    with pytest.warns(DeprecationWarning, match="score_weighted"):
        get_strategy("weighted")


# -- the draws -------------------------------------------------------------------

def _ctx(n_units=8, n_train=3, scores=None, state=None):
    return SelectionContext(n_clients=C, n_units=n_units, n_train=n_train,
                            scores=scores, state=state)


def _rctx(n_units=8, n_train=3, scores=None, state=None):
    return RSelectionContext(n_clients=C, n_units=n_units, n_train=n_train,
                             scores=scores, state=state)


def test_no_signal_is_bitwise_uniform():
    """``weighted`` and ``score_weighted`` with no scores draw the exact
    ``uniform`` rows from the same generator."""
    ctx = _ctx()
    uni = get_strategy("uniform").select(torch.Generator().manual_seed(11),
                                         ctx)
    with pytest.warns(DeprecationWarning):
        wtd = get_strategy("weighted").select(
            torch.Generator().manual_seed(11), ctx)
    sco = get_strategy("score_weighted").select(
        torch.Generator().manual_seed(11), ctx)
    assert torch.equal(uni, wtd) and torch.equal(uni, sco)
    assert (uni.sum(1) == 3).all()


SCORES = [np.asarray([0., 0., 0., 0., 0., 5., 5., 5.], np.float32),
          np.asarray([0.3, 2.0, 0.1, 7.0, 1.0, 0.2, 3.0, 0.5], np.float32),
          np.asarray([1e-3, 2e-3, 3e-3, 0., 0., 0., 9e-3, 5e-3], np.float32)]


def _margin(ranking, noise, n_train):
    v = np.sort(np.asarray(ranking, np.float32) + noise)[::-1]
    return float(v[n_train - 1] - v[n_train])


def _score_z(s):
    s = np.asarray(s, np.float32)
    return (s - s.mean()) / (s.std() + np.float32(1e-6))


@pytest.mark.parametrize("name", ["score_weighted", "weighted"])
@pytest.mark.parametrize("si", range(len(SCORES)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scored_rows_equal_reference(name, si, seed):
    """Gumbel top-k rows with the reference's noise injected: exact."""
    key = jax.random.PRNGKey(100 * si + seed)
    s = SCORES[si]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(r_get_strategy(name).select_row(
            key, _rctx(scores=jnp.asarray(s))))
    noise = np.asarray(jax.random.gumbel(key, (8,)))
    ranking = _score_z(s) if name == "score_weighted" else s
    assert _margin(ranking, noise, 3) > MARGIN
    got = _injected(name, [noise]).select_row(
        None, _ctx(scores=torch.as_tensor(s)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rnd", [0, 7, 32, 64, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_depth_dropout_rows_equal_reference(rnd, seed):
    key = jax.random.PRNGKey(seed)
    rst = RSelectionState(jnp.zeros(8), jnp.zeros(8),
                          jnp.asarray(rnd, jnp.int32))
    want = np.asarray(r_get_strategy("depth_dropout").select_row(
        key, _rctx(state=rst)))
    st = SelectionState(torch.zeros(8), torch.zeros(8),
                        torch.tensor(rnd, dtype=torch.int32))
    got = _injected("depth_dropout",
                    [np.asarray(jax.random.gumbel(key, (8,)))]).select_row(
        None, _ctx(state=st))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == 3


@pytest.mark.parametrize("n_units,n_train", [(8, 3), (14, 7), (5, 5),
                                             (6, 1)])
def test_successive_rows_equal_reference(n_units, n_train):
    strat, rstrat = get_strategy("successive"), r_get_strategy("successive")
    for rnd in range(0, 8 * strat.phase_rounds, 3):
        rst = RSelectionState(jnp.zeros(n_units), jnp.zeros(n_units),
                              jnp.asarray(rnd, jnp.int32))
        st = SelectionState(torch.zeros(n_units), torch.zeros(n_units),
                            torch.tensor(rnd, dtype=torch.int32))
        want = np.asarray(rstrat.select(None, _rctx(n_units, n_train,
                                                     state=rst)))
        got = strat.select(None, _ctx(n_units, n_train, state=st))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["score_weighted", "depth_dropout"])
def test_select_matrix_with_injected_keys_equals_reference(name):
    """(C, U): one row per client key ``split(round_key, C)``."""
    rk = jax.random.PRNGKey(9)
    s = SCORES[1]
    rst = RSelectionState(jnp.asarray(s), jnp.ones(8),
                          jnp.asarray(5, jnp.int32))
    want = np.asarray(r_get_strategy(name).select(
        rk, _rctx(scores=rst.scores, state=rst)))
    st = SelectionState(torch.as_tensor(s), torch.ones(8),
                        torch.tensor(5, dtype=torch.int32))
    got = _injected(name, _ref_noise(rk, 8)).select(
        None, _ctx(scores=st.scores, state=st))
    np.testing.assert_array_equal(got.numpy(), want)


def test_freezing_wrappers(monkeypatch):
    np.testing.assert_array_equal(select_fixed_last(8, 3).numpy(),
                                  np.asarray(r_select_fixed_last(8, 3)))
    row = select_uniform(torch.Generator().manual_seed(0), 8, 3)
    assert row.shape == (8,) and row.sum() == 3
    key, s = jax.random.PRNGKey(4), SCORES[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(r_select_weighted(key, 8, 3, jnp.asarray(s)))
        strat = get_strategy("weighted")
    noise = np.asarray(jax.random.gumbel(key, (8,)))
    monkeypatch.setattr(strat, "gumbel",
                        lambda gen, n: torch.as_tensor(noise), raising=False)
    with pytest.warns(DeprecationWarning):
        got = select_weighted(None, 8, 3, s)
    np.testing.assert_array_equal(got.numpy(), want)
    sync = select_clients(torch.Generator().manual_seed(1), C, 8, 3,
                          synchronized=True)
    assert (sync == sync[0]).all() and (sync.sum(1) == 3).all()
    indep = select_clients(torch.Generator().manual_seed(1), C, 8, 3)
    again = get_strategy("uniform").select(torch.Generator().manual_seed(1),
                                           _ctx())
    assert torch.equal(indep, again)


# -- the state update (the reference's own cases) ---------------------------------

def _update_cases():
    ema_counts = [
        (4, 0.5, np.array([4.0, 16.0, 0, 0]), np.array([1.0, 4.0, 0, 0]),
         np.array([1.0, 4.0, 0, 0])),
        (4, 0.5, None, None, None),
        (4, 0.5, np.array([36.0, 0, 9.0, 0]), np.array([1.0, 0, 1.0, 0]),
         np.array([1.0, 0, 1.0, 0]))]
    staleness = [
        (3, 0.5, np.array([4.0, 4.0, 4.0]), np.ones(3), np.ones(3)),
        (3, 0.5, np.array([36.0, 18.0, 0.0]), np.array([1.0, 0.5, 0.0]),
         np.ones(3))]
    return {"ema_and_counts": ema_counts, "staleness": staleness}


@pytest.mark.parametrize("case", ["ema_and_counts", "staleness"])
def test_update_state_equals_reference(case):
    steps = _update_cases()[case]
    n, ema = steps[0][0], steps[0][1]
    rctx = dataclasses.replace(_rctx(n_units=n, n_train=1), score_ema=ema)
    ctx = dataclasses.replace(_ctx(n_units=n, n_train=1), score_ema=ema)
    rs, s = RScoredStrategy(), ScoredStrategy()
    rst, st = rs.init_state(rctx), s.init_state(ctx)
    for _, _, sq, cnt, raw in steps:
        rst = rs.update_state(rst, rctx, None if sq is None else
                              RNormTelemetry(sq, cnt, raw))
        st = s.update_state(st, ctx, None if sq is None else
                            NormTelemetry(sq, cnt, raw))
        for a, b in zip(st, rst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=STATE_TOL, atol=STATE_TOL)
        assert st.round.dtype == torch.int32
        assert st.scores.dtype == st.counts.dtype == torch.float32
    if case == "ema_and_counts":
        np.testing.assert_allclose(st.scores.numpy(),
                                   [0.5 * 2 + 0.5 * 6, 2.0, 3.0, 0.0])
        np.testing.assert_allclose(st.counts.numpy(), [2, 4, 1, 0])
        assert int(st.round) == 3
    else:
        np.testing.assert_allclose(
            st.scores.numpy(), [0.5 * 2 + 0.5 * 6, 0.75 * 2 + 0.25 * 6, 2.0],
            rtol=1e-6)


# -- telemetry -------------------------------------------------------------------

def test_unit_sqnorm_equals_reference(toy_setup):
    rp, ra, ta = toy_setup["rp"], toy_setup["r_assign"], toy_setup["assign"]
    rng = np.random.default_rng(0)
    grads = {p: rng.standard_normal(x.shape).astype(np.float32)
             for p, x in toy_setup["tp"].items()}
    # a frozen scalar unit and frozen stacked rows: exact zeros
    grads["head/w"][:] = 0.0
    grads["head/b"][:] = 0.0
    for p in ("blocks/w1", "blocks/b1", "blocks/w2"):
        grads[p][[1, 4]] = 0.0
    rg = jax.tree_util.tree_map(jnp.asarray, _nested(grads))
    want = np.asarray(r_unit_sqnorm(ra, rg))
    got = masking.unit_sqnorm(ta, {p: torch.as_tensor(g)
                                   for p, g in grads.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL)
    frozen = np.asarray([7, 2, 5])                 # head, blocks 1 and 4
    assert (got.numpy()[frozen] == 0).all() and (want[frozen] == 0).all()
    # leaves local training never differentiates are simply absent
    live = {p: torch.as_tensor(g) for p, g in grads.items()
            if not p.startswith("head")}
    torch.testing.assert_close(masking.unit_sqnorm(ta, live), got,
                               rtol=NORM_RTOL, atol=0)


def _nested(flat):
    from repro_torch.common import unflatten
    return unflatten(flat)


def test_unit_sqnorm_packed_equals_reference(toy_setup):
    rp, ra, ta = toy_setup["rp"], toy_setup["r_assign"], toy_setup["assign"]
    sel = np.zeros(ta.n_units, np.float32)
    sel[[0, 2, 3, 6]] = 1.0
    n_slots = 4
    r_rows, r_valid = r_slot_plan(ra, jnp.asarray(sel), n_slots, rp)
    rows, valid = masking.slot_plan(ta, torch.as_tensor(sel), n_slots,
                                    toy_setup["tp"])
    for p in rows:
        np.testing.assert_array_equal(rows[p].numpy(),
                                      np.asarray(_np_flat(r_rows)[p]))
    rng = np.random.default_rng(1)
    grads = {}
    for p, x in toy_setup["tp"].items():
        v = valid[p].numpy()
        shape = ((rows[p].shape[0],) + tuple(x.shape[1:])
                 if ta.leaf_units[p].kind == "stacked" else tuple(x.shape))
        g = rng.standard_normal(shape).astype(np.float32)
        grads[p] = g * v.reshape(v.shape + (1,) * (g.ndim - v.ndim))
    want = np.asarray(r_unit_sqnorm_packed(
        ra, jax.tree_util.tree_map(jnp.asarray, _nested(grads)), r_rows))
    got = masking.unit_sqnorm_packed(
        ta, {p: torch.as_tensor(g) for p, g in grads.items()}, rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL)
    assert (got.numpy()[sel == 0] == 0).all()


# -- rounds with the reference's noise injected ---------------------------------

CASES = [("score_weighted", "hub", False), ("score_weighted", "hub", True),
         ("score_weighted", "hierarchical", False),
         ("score_weighted", "hierarchical", True),
         ("score_weighted", "gossip", False), ("depth_dropout", "hub", False),
         ("successive", "hub", False)]


def _fl_kw(strategy, topology, packed):
    kw = dict(n_clients=C, train_fraction=0.4, lr=LR, strategy=strategy,
              topology=topology, packed=packed)
    if topology == "hierarchical":
        kw["n_edges"] = 2
    return kw


class _Record:
    """Hook recording the state before each round and its metrics."""

    def __init__(self):
        self.before, self.metrics = [], []

    def on_round_start(self, server, r, weights):
        self.before.append(jax.tree_util.tree_map(
            lambda x: np.array(x), server.sel_state))
        return None

    def on_round_end(self, server, record, metrics):
        self.metrics.append({"sel": np.asarray(metrics["sel"]),
                             "unit_sqnorm":
                                 np.asarray(metrics["unit_sqnorm"])})

    def on_fit_end(self, server, history):
        pass


class _RRecord(_Record, RServerHook):
    pass


class _TRecord(_Record, ServerHook):
    pass


@pytest.fixture(scope="module")
def ref_scored(toy_setup):
    out = {}
    for case in CASES:
        rfl = RFLConfig(fused_agg="off", **_fl_kw(*case))
        rec = _RRecord()
        fed = RFederation(loss_fn=r_toy_loss, params=toy_setup["rp"],
                          assign=toy_setup["r_assign"], fl=rfl, seed=SEED,
                          hooks=(rec,))
        fed.server.run(ROUNDS, lambda r: toy_setup["batches"],
                       weights=jnp.asarray(W))
        out[case] = {"state": _np_flat(fed.state),
                     "sel_state": [np.asarray(x) for x in
                                   fed.server.sel_state],
                     "rec": rec, "summary": fed.comm_summary(),
                     "losses": [r.loss for r in fed.history]}
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_scored_rounds_equal_reference(toy_setup, ref_scored, case):
    """Three scored rounds through ``Federation`` with the reference's
    Gumbel noise injected: the selections are the reference's exactly
    (each perturbed ranking clears its next unit by more than MARGIN),
    the telemetry within NORM_RTOL, the state within TOL and the
    ``SelectionState`` within STATE_TOL; the bill is equal."""
    strategy, topology, packed = case
    ref = ref_scored[case]
    n_units = toy_setup["assign"].n_units
    n_train = FLConfig(**_fl_kw(*case)).resolve_n_train(n_units)
    noise = []
    for r, rk in enumerate(_round_keys(SEED, ROUNDS)):
        rows = _ref_noise(rk, n_units)
        noise += rows
        if strategy == "score_weighted":
            z = _score_z(ref["rec"].before[r].scores)
            for row in rows:
                assert _margin(z, row, n_train) > MARGIN
    strat = _injected(strategy, noise)
    fl = FLConfig(fused_agg="off", **_fl_kw(*case))
    rec = _TRecord()
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=SEED,
                     strategy=strat, hooks=(rec,), device="cpu")
    assert fed.server.strategy is strat
    fed.server.run(ROUNDS, lambda r: toy_setup["tb"],
                   weights=torch.as_tensor(W))
    for r in range(ROUNDS):
        np.testing.assert_array_equal(rec.metrics[r]["sel"],
                                      ref["rec"].metrics[r]["sel"])
        assert rec.metrics[r]["unit_sqnorm"].shape == (C, n_units)
        np.testing.assert_allclose(rec.metrics[r]["unit_sqnorm"],
                                   ref["rec"].metrics[r]["unit_sqnorm"],
                                   rtol=NORM_RTOL)
        sq, sel = rec.metrics[r]["unit_sqnorm"], rec.metrics[r]["sel"]
        assert (sq[sel == 0] == 0).all() and (sq[sel > 0] > 0).all()
    _close(fed.state, ref["state"], TOL, str(case))
    for a, b in zip(fed.server.sel_state, ref["sel_state"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=STATE_TOL,
                                   atol=STATE_TOL)
    assert int(fed.server.sel_state.round) == ROUNDS
    assert fed.comm_summary() == ref["summary"]
    np.testing.assert_allclose([r.loss for r in fed.history], ref["losses"],
                               rtol=1e-5)


def test_packed_and_dense_telemetry_agree(toy_setup):
    """Inside the port, on the same selection: packed telemetry within
    NORM_RTOL of the dense path's (not bitwise: the reference's bitwise
    claim fails there), both exact zeros on untrained units."""
    st = get_strategy("score_weighted").init_state(
        _ctx(n_units=toy_setup["assign"].n_units, n_train=4))
    st = st._replace(scores=torch.linspace(0.1, 2.0, st.scores.shape[0]))
    out = {}
    for packed in (False, True):
        fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                      strategy="score_weighted", packed=packed)
        step = build_round_step(tloss, toy_setup["assign"], fl, device="cpu")
        out[packed] = step(dict(toy_setup["tp"]), toy_setup["tb"],
                           torch.as_tensor(W),
                           torch.Generator().manual_seed(3), sel_state=st)
    (pd, md), (pp, mp) = out[False], out[True]
    assert torch.equal(md["sel"], mp["sel"])
    torch.testing.assert_close(mp["unit_sqnorm"], md["unit_sqnorm"],
                               rtol=NORM_RTOL, atol=0)
    sel = md["sel"]
    assert (md["unit_sqnorm"][sel == 0] == 0).all()
    assert (mp["unit_sqnorm"][sel == 0] == 0).all()
    for p in pd:
        torch.testing.assert_close(pp[p], pd[p], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("topology", ["hub", "hierarchical", "gossip"])
def test_stateless_rounds_unchanged(toy_setup, topology):
    """A stateless strategy's step carries no telemetry, and a Server
    run equals driving the bare step by hand with the same generator,
    bitwise: the scored plumbing is invisible to it."""
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR, topology=topology)
    srv = Server(build_round_step(tloss, toy_setup["assign"], fl,
                                  device="cpu"),
                 toy_setup["assign"], fl, toy_setup["tp"], seed=13,
                 device="cpu")
    assert srv.sel_state is None
    srv.run_round(toy_setup["tb"])
    srv.run_round(toy_setup["tb"])
    raw = build_round_step(tloss, toy_setup["assign"], fl, device="cpu")
    topo = get_topology(topology)
    state = topo.init_state(dict(toy_setup["tp"]), fl)
    gen = torch.Generator().manual_seed(13)
    for _ in range(2):
        state, m = raw(state, toy_setup["tb"], torch.ones(C), gen)
        assert "unit_sqnorm" not in m
    assert all(torch.equal(srv.params[p], state[p]) for p in state)


def test_score_every_throttles_updates_but_round_advances(toy_setup):
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                  strategy="score_weighted", score_every=2)
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=1, device="cpu")
    fed.server.run(3, lambda r: toy_setup["tb"])       # telemetry 0 and 2
    st = fed.server.sel_state
    assert int(st.round) == 3
    assert float(st.counts.sum()) == 2 * C * 4


def test_dropped_clients_contribute_no_telemetry(toy_setup):
    class DropAllButOne(ServerHook):
        def on_round_start(self, server, r, weights):
            return weights * torch.as_tensor([1.0, 0.0, 0.0, 0.0])

    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                  strategy="score_weighted")
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=1,
                     hooks=(DropAllButOne(),), device="cpu")
    fed.server.run(2, lambda r: toy_setup["tb"])
    st = fed.server.sel_state
    assert float(st.counts.sum()) == 2 * 4
    want = sum(torch.as_tensor(s[0]) for s in fed.server.sel_history)
    assert torch.equal(st.counts, want)


def test_all_dropped_round_advances_the_counter(toy_setup):
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                  strategy="score_weighted")
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=1, device="cpu")
    rec = fed.run_round(toy_setup["tb"], weights=torch.zeros(C))
    assert rec.skipped and int(fed.server.sel_state.round) == 1
    assert float(fed.server.sel_state.counts.sum()) == 0.0


def test_server_honors_round_step_strategy_override(toy_setup):
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR)
    step = build_round_step(tloss, toy_setup["assign"], fl,
                            strategy="score_weighted", device="cpu")
    srv = Server(step, toy_setup["assign"], fl, toy_setup["tp"], seed=2,
                 device="cpu")
    assert srv.strategy.name == "score_weighted"
    srv.run_round(toy_setup["tb"])
    assert srv.sel_state is not None and int(srv.sel_state.round) == 1
    assert float(srv.sel_state.scores.max()) > 0.0


def test_scored_selection_follows_live_scores(toy_setup):
    """After training, ``score_weighted`` favours the units with large
    norm EMAs (the reference's own check)."""
    fl = FLConfig(n_clients=C, train_fraction=0.25, lr=LR,
                  strategy="score_weighted", score_ema=0.5)
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=0, device="cpu")
    fed.server.run(12, lambda r: toy_setup["tb"])
    scores = fed.server.sel_state.scores.numpy()
    late = np.stack(fed.server.sel_history[6:]).sum((0, 1))
    order = np.argsort(-scores)
    assert late[order[:2]].mean() > late[order[-2:]].mean()


@pytest.mark.parametrize("kw", [dict(score_ema=1.0), dict(score_ema=-0.1),
                                dict(score_every=0)])
def test_flconfig_rejects_bad_score_knobs_as_reference(kw):
    with pytest.raises(ValueError) as got:
        FLConfig(n_clients=4, **kw)
    with pytest.raises(ValueError) as want:
        RFLConfig(n_clients=4, **kw)
    assert str(got.value) == str(want.value)


def test_fullmodel_shim_deprecated_and_equivalent(toy_setup):
    fl = FLConfig(n_clients=C, n_train_units=toy_setup["assign"].n_units,
                  lr=LR)
    with pytest.warns(DeprecationWarning):
        shim = build_fullmodel_round_step(tloss, fl,
                                          assign=toy_setup["assign"],
                                          device="cpu")
    unified = build_round_step(tloss, toy_setup["assign"],
                               dataclasses.replace(fl, strategy="full"),
                               device="cpu")
    p1, m1 = shim(dict(toy_setup["tp"]), toy_setup["tb"], torch.ones(C), None)
    p2, _ = unified(dict(toy_setup["tp"]), toy_setup["tb"], torch.ones(C),
                    None)
    assert all(torch.equal(p1[p], p2[p]) for p in p1)
    assert float(m1["sel"].min()) == 1.0
    with pytest.warns(DeprecationWarning):
        legacy = build_fullmodel_round_step(tloss, fl, device="cpu")
    srv = Server(legacy, masking.UnitAssignment(1, None, ("model",)), fl,
                 toy_setup["tp"], device="cpu")
    rec = srv.run_round(toy_setup["tb"])
    n = sum(x.numel() for x in toy_setup["tp"].values())
    assert srv.sel_history[0].shape == (C, 1)
    assert rec.uplink_bytes == 4.0 * n * C and rec.trained_params == n * C
    assert srv.comm_summary()["avg_uplink_bytes"] == 4.0 * n * C
