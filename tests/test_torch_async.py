"""The port's buffered-async engine (``repro_torch.core.async_agg``)
against the reference's.

Host-side numpy draws are ported verbatim and held **array-equal**:
the staleness rules, the delay scheduler's latencies and in-transit
drops.  One async run of 4 flushes (the toy MLP of the reference's own
async tests, qint8 codec, heavy-tailed delays) is held against the
reference's with its draws injected — the reference's per-version
selections replayed (``Replay``) and its rounding uniforms fed through
``AsyncRoundEngine.codec_draw``: parameters within 2e-5 (SGD, one local
step; a decoded code that rounds the other way would move an element by
one scale step, far beyond that, so none did), and the flushed clients,
staleness, simulated clock and bytes **exact**.  Inside the port,
bitwise: a zero-staleness flush (``delay_dist="none"``, buffer == C)
equals the synchronous packed round, codec included, whatever the
arrival order.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import Federation as RFederation
from repro.core import async_agg as rasync
from repro.core import topology as rtopo
from repro.core.codecs import CODEC_KEY_TAG
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten
from repro_torch.convert import from_reference
from repro_torch.core import (FLConfig, Federation, Replay, Server,
                              async_agg, build_round_step, get_topology)
from repro_torch.models import toy

C = 4
PARAM_TOL = 2e-5       # engine parameters, port vs reference
tloss = functools.partial(toy.toy_loss, device="cpu")


# -- staleness registry and delay scheduler: array-equal ----------------------

def test_staleness_rules_equal_reference():
    assert async_agg.registered_staleness() == rasync.registered_staleness()
    s = np.asarray([0.0, 1.0, 2.0, 3.0, 7.5, 40.0])
    for name in async_agg.registered_staleness():
        for alpha in (0.0, 0.5, 1.0, 2.3):
            got = async_agg.get_staleness(name)(s, alpha)
            want = rasync.get_staleness(name)(s, alpha)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            w = np.asarray([1.0, 2.0, 0.0, 3.0, 0.5, 1.5], np.float32)
            assert np.array_equal(
                async_agg.staleness_weights(w, s, name, alpha),
                rasync.staleness_weights(w, s, name, alpha))
    assert async_agg.get_staleness("polynomial")(np.zeros(1), 0.5)[0] == 1.0
    with pytest.raises(async_agg.UnknownStalenessError) as got:
        async_agg.get_staleness("linear")
    with pytest.raises(rasync.UnknownStalenessError) as want:
        rasync.get_staleness("linear")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["none", "fixed", "exponential",
                                  "exponential:0.3", "lognormal:0.8",
                                  "pareto", "pareto:1.2", "gamma:2"])
def test_delay_scheduler_equals_reference(spec):
    try:
        want_parsed = rasync.parse_delay_dist(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            async_agg.parse_delay_dist(spec)
        assert str(got.value) == str(e)
        return
    assert async_agg.parse_delay_dist(spec) == want_parsed
    a = async_agg.DelayScheduler(spec, seed=4, drop_prob=0.3)
    b = rasync.DelayScheduler(spec, seed=4, drop_prob=0.3)
    grid = [(c, s) for c in range(6) for s in range(12)]
    assert [a.delay(c, s) for c, s in grid] == [b.delay(c, s) for c, s in grid]
    assert [a.dropped(c, s) for c, s in grid] == \
        [b.dropped(c, s) for c, s in grid]
    assert any(a.dropped(c, s) for c, s in grid)
    with pytest.raises(ValueError):
        async_agg.DelayScheduler(spec, drop_prob=1.0)


def test_mixed_window_batches_equals_reference():
    rng = np.random.default_rng(0)
    per = {w: {"x": rng.normal(size=(C, 2, 3)).astype(np.float32)}
           for w in range(4)}
    windows = [2, 0, 2, 3]
    want = rasync._mixed_window_batches(
        lambda w: {"x": jnp.asarray(per[w]["x"])}, windows)
    got = async_agg._mixed_window_batches(
        lambda w: {"x": torch.as_tensor(per[w]["x"])}, windows)
    assert np.array_equal(got["x"].numpy(), np.asarray(want["x"]))
    sub = async_agg._mixed_window_batches(
        lambda w: {"x": torch.as_tensor(per[w]["x"])}, windows, [3, 1])
    assert np.array_equal(sub["x"].numpy(), np.asarray(want["x"])[[3, 1]])


# -- one async run against the reference's ------------------------------------

_RUN = dict(n_clients=C, train_fraction=0.5, packed=True, codec="qint8",
            optimizer="sgd", async_buffer=2, client_delay_dist="pareto:1.5")
SEED, FLUSHES = 5, 4


@pytest.fixture(scope="module")
def ref_async_run():
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    rb = r_toy_batches(jax.random.PRNGKey(1), n_clients=C, steps=1,
                       batch=4, d=16, out=4)
    fed = RFederation(loss_fn=r_toy_loss, params=rp, assign=r_toy_units(rp),
                      fl=RFLConfig(fused_agg="off", **_RUN), seed=SEED)
    eng = fed.server.async_engine
    sels, select = [], eng.select_fn

    def recording_select(*args):
        sel = select(*args)
        sels.append(np.asarray(sel))
        return sel

    eng.select_fn = recording_select
    fed.server.run(FLUSHES, lambda w: rb)
    return {"rp": rp, "rb": rb, "fed": fed, "sels": sels,
            "params": jax.tree_util.tree_map(np.asarray, fed.server.params)}


def _reference_uniforms(seed):
    """``codec_draw`` with the reference's uniforms: dispatch d draws
    leaf i's rows for the whole cohort from ``fold_in(fold_in(base, d),
    i)``; the dispatched clients' rows are kept."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), CODEC_KEY_TAG)

    def draw(d, clients, i, shape):
        rows = shape[0] // len(clients)
        full = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(base, d), i),
            (C * rows,) + tuple(shape[1:]), jnp.float32))
        full = full.reshape((C, rows) + tuple(shape[1:]))
        return torch.as_tensor(full[clients].reshape(shape))
    return draw


def test_async_run_equals_reference(ref_async_run):
    ref = ref_async_run
    tp = from_reference(ref["rp"])
    fed = Federation(loss_fn=tloss, params=tp, assign=toy.toy_units(tp),
                     fl=FLConfig(**_RUN), seed=SEED, device="cpu",
                     strategy=Replay(ref["sels"]))
    eng = fed.server.async_engine
    eng.codec_draw = _reference_uniforms(SEED)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in ref["rb"].items()}
    fed.server.run(FLUSHES, lambda w: tb)
    reng = ref["fed"].server.async_engine
    assert eng._codec_dispatch == reng._codec_dispatch
    assert all(np.array_equal(a, b) for a, b in
               zip(eng.flush_clients, reng.flush_clients))
    assert len(eng.flush_clients) == FLUSHES
    for a, b in zip(fed.history, ref["fed"].history):
        assert (a.staleness_mean, a.staleness_max, a.sim_time,
                a.n_participants, a.uplink_bytes, a.trained_params,
                a.effective_weights) == \
            (b.staleness_mean, b.staleness_max, b.sim_time,
             b.n_participants, b.uplink_bytes, b.trained_params,
             b.effective_weights)
        assert abs(a.loss - b.loss) < 1e-5
    assert max(r.staleness_max for r in fed.history) > 0   # stale work
    assert fed.comm_summary() == ref["fed"].comm_summary()
    assert list(eng.seq) == list(reng.seq) and eng.clock == reng.clock
    want = from_reference(ref["params"])
    err = max(float((fed.params[p] - want[p]).abs().max()) for p in want)
    assert err <= PARAM_TOL, err


# -- zero staleness == the synchronous packed round, inside the port ----------

class _PermutedDelays(async_agg.DelayScheduler):
    """First dispatches complete in a shuffled order; later dispatches
    take forever."""

    def __init__(self, order):
        super().__init__("none", 0)
        self.order = order

    def delay(self, client, seq):
        return 100.0 if seq > 0 else 1.0 + 0.1 * self.order[client]


@pytest.fixture(scope="module")
def toy_setup():
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=6,
                         d=16, hidden=32, out=4)
    return p, toy.toy_units(p), toy.toy_batches(
        torch.Generator().manual_seed(1), n_clients=C, steps=2, batch=2,
        d=16, out=4)


@pytest.mark.parametrize("topology", ["hub", "hierarchical"])
@pytest.mark.parametrize("codec,strategy,arrival", [
    ("none", "uniform", "inorder"), ("qint8", "uniform", "shuffled"),
    ("none", "synchronized", "shuffled"), ("qint8", "score_weighted",
                                           "inorder")])
def test_zero_staleness_flush_bitwise_equals_sync(toy_setup, topology,
                                                  codec, strategy, arrival):
    """B = C and one origin version: the first flush is bitwise one
    synchronous packed round — params, selection state, bill — with a
    straggler-zeroed client, in any arrival order, and under qint8 (the
    first dispatch draws the sync round's uniforms)."""
    p, assign, b = toy_setup
    w = torch.tensor([1.0, 2.0, 0.0, 3.0])
    kw = dict(n_clients=C, train_fraction=0.5, strategy=strategy,
              topology=topology, packed=True, codec=codec)
    sync_fl = FLConfig(**kw)
    srv = Server(build_round_step(tloss, assign, sync_fl, device="cpu"),
                 assign, sync_fl, p, seed=11, device="cpu")
    srv.run_round(b, w)
    fed = Federation(loss_fn=tloss, params=p, assign=assign,
                     fl=FLConfig(async_buffer=C, client_delay_dist="none",
                                 **kw), seed=11, device="cpu")
    if arrival == "shuffled":
        fed.server.async_engine.scheduler = _PermutedDelays([2, 0, 3, 1])
    fed.server.run(1, lambda window: b, weights=w)
    assert all(torch.equal(srv.params[k], fed.params[k]) for k in p)
    rec, want = fed.history[0], srv.history[0]
    assert rec.staleness_mean == 0.0 and rec.staleness_max == 0.0
    assert rec.n_participants == C - 1 == want.n_participants
    assert rec.uplink_bytes == want.uplink_bytes
    if strategy == "score_weighted":
        assert all(torch.equal(x, y) for x, y in
                   zip(srv.sel_state, fed.server.sel_state))


# -- the scored engine's decayed telemetry ------------------------------------

def test_flush_telemetry_decays_like_reference():
    """A stale entry's telemetry is weighted by its staleness factor,
    dropped and quarantined entries by 0, as the reference weights it."""
    rng = np.random.default_rng(3)
    u, b = 6, 5
    stats = {"entry_sqnorm": rng.uniform(0, 2, (b, u)).astype(np.float32),
             "entry_sel": (rng.uniform(size=(b, u)) > 0.5).astype(np.float32),
             "effective_weights": np.asarray([1, 0.5, 0, 2, 1], np.float32),
             "staleness_factor": 1.0 / np.sqrt(1.0 + np.arange(b)),
             "quarantined": np.asarray([0, 0, 0, 1, 0], np.float32)}
    for with_quar in (True, False):
        st = dict(stats) if with_quar else \
            {k: v for k, v in stats.items() if k != "quarantined"}
        fake = types.SimpleNamespace(
            server=types.SimpleNamespace(sel_state=object()),
            fl=types.SimpleNamespace(score_every=1))
        got = async_agg.AsyncRoundEngine._flush_telemetry(fake, 3, st)
        want = rasync.AsyncRoundEngine._flush_telemetry(fake, 3, st)
        for g, w_ in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w_))
    fake.fl.score_every = 2
    assert async_agg.AsyncRoundEngine._flush_telemetry(fake, 3, st) is None


def test_scored_async_state_decays_with_staleness(toy_setup):
    """score_weighted under stale buffered rounds: the constant rule
    counts every entry at full weight (4 flushes x buffer 2 x 4 trained
    units), the polynomial rule strictly less."""
    p, assign, b = toy_setup

    def run(rule):
        fl = FLConfig(n_clients=C, train_fraction=0.5,
                      strategy="score_weighted", async_buffer=2,
                      staleness=rule, staleness_alpha=1.0,
                      client_delay_dist="pareto:1.5")
        fed = Federation(loss_fn=tloss, params=p, assign=assign, fl=fl,
                         seed=5, device="cpu")
        fed.server.run(4, lambda w: b)
        return fed

    poly, const = run("polynomial"), run("constant")
    assert int(poly.server.sel_state.round) == 4
    assert float(poly.server.sel_state.scores.max()) > 0.0
    assert max(r.staleness_mean for r in poly.history) > 0.0
    assert float(const.server.sel_state.counts.sum()) == 4 * 2 * 4
    assert float(const.server.sel_state.counts.sum()) > \
        float(poly.server.sel_state.counts.sum())


# -- the reference's refusals ---------------------------------------------------

def test_gossip_and_full_refuse_async_like_reference(toy_setup):
    p, assign, _ = toy_setup
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=2, d=4, hidden=4, out=2)
    ra = r_toy_units(rp)
    for name in ("build_buffered_flush", "build_chunk_agg"):
        with pytest.raises(ValueError) as want:
            getattr(rtopo.get_topology("gossip"), name)(
                ra, RFLConfig(n_clients=C))
        with pytest.raises(ValueError) as got:
            getattr(get_topology("gossip"), name)(assign, FLConfig(n_clients=C))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        rasync.build_cohort_step(r_toy_loss, ra,
                                 RFLConfig(n_clients=C, strategy="full"))
    with pytest.raises(ValueError) as got:
        async_agg.build_cohort_step(tloss, assign,
                                    FLConfig(n_clients=C, strategy="full"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="buffered-async path"):
        Federation(loss_fn=tloss, params=p, assign=assign, device="cpu",
                   fl=FLConfig(n_clients=C, train_fraction=0.5,
                               topology="gossip", async_buffer=2))


def test_run_round_refused_in_async_mode(toy_setup):
    p, assign, b = toy_setup
    fed = Federation(loss_fn=tloss, params=p, assign=assign, device="cpu",
                     fl=FLConfig(n_clients=C, train_fraction=0.5,
                                 async_buffer=2))
    with pytest.raises(RuntimeError, match="buffered-async mode"):
        fed.server.run_round(b)
    assert fed.comm_summary()["total_uplink_bytes"] == 0.0


def test_flush_arg_specs_match_reference(toy_setup):
    p, assign, _ = toy_setup
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    fl_kw = dict(n_clients=C, train_fraction=0.5, async_buffer=3)
    got = async_agg.flush_arg_specs(assign, p, FLConfig(**fl_kw))
    want = rasync.flush_arg_specs(r_toy_units(rp), rp, RFLConfig(**fl_kw))
    for g, w in zip(got, want):
        if isinstance(g, dict):
            w = flatten(w)
            assert set(g) == set(w)
            assert all(tuple(g[k].shape) == tuple(w[k].shape) for k in g)
        else:
            assert tuple(g.shape) == tuple(w.shape)
