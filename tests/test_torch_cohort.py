"""The port's chunk-streamed cohort engine (``repro_torch.core.cohort``)
against the reference's.

The reference seeds its samplers with a threefry key's raw words and
draws Gumbel rows from that key; the port takes the words as an input
and draws its Gumbel rows through ``ClientSampler.gumbel``, so the tests
inject the reference's words and rows: the Floyd draw and the scored
draw are then **exact**.  Crash resampling (numpy ``SeedSequence``
draws) and the fleet-EMA update are held exact on the same inputs.  One
chunked run of two rounds (R = 10 registered clients, a cohort of 4 in
chunks of 2, qint8, ``loss_proportional`` sampling, so round 2 samples
against round 1's fleet EMAs) is held against the reference's with its
words, Gumbel rows, selections and rounding uniforms injected:
parameters within 2e-5 (SGD, one local step), cohorts and bytes exact.
Inside the port, bitwise: any chunking equals single-shot (qint8
included: each cohort position has its own uniform stream), and R == C
equals the synchronous packed round.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import Federation as RFederation
from repro.core import cohort as rcohort
from repro.core import faults as rfaults
from repro.core.codecs import CODEC_KEY_TAG
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.ckpt import restore_server_state, save_server_state
from repro_torch.convert import from_reference
from repro_torch.core import (FLConfig, Federation, Replay, cohort, faults)
from repro_torch.models import toy

C = 4
PARAM_TOL = 2e-5       # engine parameters, port vs reference
EMA_TOL = 1e-5         # fleet loss EMAs (float32 losses of two frameworks)
tloss = functools.partial(toy.toy_loss, device="cpu")


def _words(key):
    return [int(w) for w in np.asarray(jax.random.key_data(key),
                                       np.uint32).ravel()]


# -- samplers: exact on the reference's words and Gumbel rows -----------------

def test_sampler_registry_matches_reference():
    assert cohort.registered_client_samplers() == \
        rcohort.registered_client_samplers()
    for name in cohort.registered_client_samplers():
        assert cohort.get_client_sampler(name).needs_norms == \
            rcohort.get_client_sampler(name).needs_norms
    with pytest.raises(cohort.UnknownClientSamplerError) as got:
        cohort.get_client_sampler("round_robin")
    with pytest.raises(rcohort.UnknownClientSamplerError) as want:
        rcohort.get_client_sampler("round_robin")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("r_reg,c", [(10, 4), (1000, 8), (100_000, 16),
                                     (8, 8), (5, 9)])
def test_floyd_draw_exact_on_reference_words(r_reg, c):
    for seed in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
        got = cohort._uniform_draw(_words(key), r_reg, c)
        want = rcohort._uniform_draw(key, r_reg, c)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
        assert len(set(got.tolist())) == min(c, r_reg)


@pytest.mark.parametrize("seen_frac", [0.0, 0.3, 1.0])
def test_scored_draw_exact_with_reference_gumbel(seen_frac):
    rng = np.random.default_rng(1)
    r_reg, c = 40, 6
    signal = rng.uniform(0, 3, r_reg).astype(np.float32)
    seen = rng.uniform(size=r_reg) < seen_frac
    for seed in range(3):
        key = jax.random.PRNGKey(seed + 11)

        def gumbel(words, n, _key=key):
            assert words == _words(_key)
            return np.asarray(jax.random.gumbel(_key, (n,)), np.float64)

        got = cohort._scored_draw(_words(key), signal, seen, c, gumbel)
        want = rcohort._scored_draw(key, signal, seen, c)
        assert np.array_equal(got, want)


def test_port_samplers_keep_the_contract():
    """The port's own draws: sorted unique ids, the identity at R == C."""
    fleet = cohort.fleet_init(50)
    fleet.counts[:10] = 1
    fleet.loss_ema[:10] = np.linspace(0, 1, 10)
    for name in cohort.registered_client_samplers():
        s = cohort.get_client_sampler(name)
        ids = s.sample(cohort._seed_words(0, 1), cohort.CohortContext(
            50, 7, fleet))
        assert ids.dtype == np.int32 and len(set(ids.tolist())) == 7
        assert np.array_equal(ids, np.sort(ids))
        ident = s.sample(cohort._seed_words(0, 1), cohort.CohortContext(
            7, 7, cohort.fleet_init(7)))
        assert np.array_equal(ident, np.arange(7))


# -- host-side engine pieces: exact -------------------------------------------

def _fake_engine(mod, spec, n_reg, retries=3):
    return types.SimpleNamespace(
        server=types.SimpleNamespace(
            fault_injector=mod.FaultInjector(spec, seed=4)),
        fl=types.SimpleNamespace(fault_retries=retries, sampler_ema=0.9),
        n_registered=n_reg)


@pytest.mark.parametrize("spec,n_reg,retries", [
    ("crash:0.3", 40, 3), ("crash:0.8", 12, 2), ("crash:1.0", 9, 3)])
def test_crash_resample_equals_reference(spec, n_reg, retries):
    a = _fake_engine(faults, spec, n_reg, retries)
    b = _fake_engine(rfaults, spec, n_reg, retries)
    for r in range(5):
        ids = np.sort(np.random.default_rng(r).choice(n_reg, 6,
                                                      replace=False))
        got = cohort.CohortEngine._resample_crashed(a, r, ids.astype(
            np.int32))
        want = rcohort.CohortEngine._resample_crashed(b, r, ids.astype(
            np.int32))
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_fleet_update_equals_reference():
    fleets = []
    for mod in (cohort, rcohort):
        eng = types.SimpleNamespace(fleet=mod.fleet_init(20),
                                    fl=types.SimpleNamespace(sampler_ema=0.8))
        for r in range(3):
            rr = np.random.default_rng(r)
            p = {"ids": np.sort(rr.choice(20, 5, replace=False)),
                 "eff_w": [1.0, 0.0, 2.0, 1.0, 1.0]}
            m = {"loss_per_client": rr.uniform(0, 2, 5).astype(np.float32),
                 "unit_sqnorm": rr.uniform(0, 1, (5, 3)).astype(np.float32),
                 "quarantined": np.asarray([0, 0, 0, 1, 0], np.float32)}
            mod.CohortEngine._update_fleet(eng, p, m if r != 1 else None)
        fleets.append(eng.fleet)
    a, b = fleets
    assert a.round == b.round == 3
    for f in ("loss_ema", "norm_ema", "counts"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# -- one chunked run against the reference's ----------------------------------

R_REG, CHUNK, SEED, ROUNDS = 10, 2, 6, 2
_RUN = dict(n_clients=C, train_fraction=0.5, packed=True, codec="qint8",
            optimizer="sgd", n_registered=R_REG, cohort_chunk=CHUNK,
            client_sampler="loss_proportional")


@pytest.fixture(scope="module")
def ref_cohort_run():
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    rb = r_toy_batches(jax.random.PRNGKey(2), n_clients=R_REG, steps=1,
                       batch=4, d=16, out=4)
    fed = RFederation(loss_fn=r_toy_loss, params=rp, assign=r_toy_units(rp),
                      fl=RFLConfig(fused_agg="off", **_RUN), seed=SEED)
    eng = fed.server.cohort_engine
    sels, select = [], eng.programs.select

    def recording_select(*args):
        sel = select(*args)
        sels.append(np.asarray(sel))
        return sel

    eng.programs.select = recording_select
    fed.server.run(ROUNDS, lambda r, ids: jax.tree_util.tree_map(
        lambda x: x[np.asarray(ids)], rb))
    return {"rp": rp, "rb": rb, "fed": fed, "sels": sels,
            "params": jax.tree_util.tree_map(np.asarray, fed.server.params)}


def test_chunked_run_equals_reference(ref_cohort_run):
    ref = ref_cohort_run
    reng = ref["fed"].server.cohort_engine
    tp = from_reference(ref["rp"])
    fed = Federation(loss_fn=tloss, params=tp, assign=toy.toy_units(tp),
                     fl=FLConfig(**_RUN), seed=SEED, device="cpu",
                     strategy=Replay(ref["sels"]))
    eng = fed.server.cohort_engine
    # the reference's draws: sampler words and Gumbel rows of round r,
    # and chunk j's rounding uniforms
    keys = {r: jax.random.fold_in(reng._sampler_base, r)
            for r in range(ROUNDS)}
    by_words = {tuple(_words(k)): k for k in keys.values()}
    eng.sampler_words = lambda r: _words(keys[r])
    sampler = type(eng.programs.sampler)()
    sampler.gumbel = lambda words, n: np.asarray(
        jax.random.gumbel(by_words[tuple(words)], (n,)), np.float64)
    eng.programs.sampler = sampler
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), CODEC_KEY_TAG)

    def codec_draw(r, positions, i, shape):
        ck = jax.random.fold_in(jax.random.fold_in(base, r),
                                positions[0] // CHUNK)
        return torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(ck, i), shape, jnp.float32)))

    eng.codec_draw = codec_draw
    tb = {k: torch.as_tensor(np.array(v)) for k, v in ref["rb"].items()}
    fed.server.run(ROUNDS, lambda r, ids: {
        k: v[torch.as_tensor(np.asarray(ids))] for k, v in tb.items()})
    assert eng.fleet.round == reng.fleet.round == ROUNDS
    assert np.array_equal(eng.fleet.counts, reng.fleet.counts)
    assert eng.fleet.counts.sum() == ROUNDS * C
    np.testing.assert_allclose(eng.fleet.loss_ema, reng.fleet.loss_ema,
                               rtol=0, atol=EMA_TOL)
    for a, b in zip(fed.history, ref["fed"].history):
        assert (a.uplink_bytes, a.trained_params, a.n_participants) == \
            (b.uplink_bytes, b.trained_params, b.n_participants)
        assert abs(a.loss - b.loss) < 1e-5
    assert fed.comm_summary() == ref["fed"].comm_summary()
    want = from_reference(ref["params"])
    err = max(float((fed.params[p] - want[p]).abs().max()) for p in want)
    assert err <= PARAM_TOL, err


# -- inside the port: chunking and R == C, bitwise ----------------------------

@pytest.fixture(scope="module")
def toy_setup():
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=6,
                         d=16, hidden=32, out=4)
    return p, toy.toy_units(p), toy.toy_batches(
        torch.Generator().manual_seed(1), n_clients=8, steps=2, batch=2,
        d=16, out=4)


def _bf(b):
    return lambda r, ids: {k: v[torch.as_tensor(np.asarray(ids))]
                           for k, v in b.items()}


def _runs_equal(a, b):
    assert all(torch.equal(a.params[p], b.params[p]) for p in a.params)
    assert len(a.server.sel_history) == len(b.server.sel_history)
    assert all(np.array_equal(x, y) for x, y in
               zip(a.server.sel_history, b.server.sel_history))
    for ra, rb in zip(a.history, b.history):
        assert (ra.loss, ra.uplink_bytes, ra.n_participants, ra.skipped) == \
            (rb.loss, rb.uplink_bytes, rb.n_participants, rb.skipped)
    assert a.comm_summary() == b.comm_summary()


@pytest.mark.parametrize("topology,sampler", [("hub", "uniform"),
                                              ("hierarchical",
                                               "loss_proportional")])
def test_any_chunking_bitwise_equals_single_shot(toy_setup, topology,
                                                 sampler):
    """A cohort of 4 out of 8 registered clients, qint8, straggler
    dropout: chunks of 1, 2 and 4 give bitwise the same run."""
    p, assign, b = toy_setup
    runs = []
    for chunk in (4, 2, 1):
        fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True,
                      codec="qint8", topology=topology, n_edges=2,
                      n_registered=8, cohort_chunk=chunk,
                      client_sampler=sampler)
        fed = Federation(loss_fn=tloss, params=p, assign=assign, fl=fl,
                         seed=3, dropout_rate=0.3, device="cpu")
        fed.server.run(3, _bf(b))
        runs.append(fed)
    for other in runs[1:]:
        _runs_equal(runs[0], other)
        assert np.array_equal(runs[0].server.cohort_engine.fleet.loss_ema,
                              other.server.cohort_engine.fleet.loss_ema)


@pytest.mark.parametrize("topology,strategy,chunk", [
    ("hub", "uniform", 1), ("hierarchical", "score_weighted", 2),
    ("hub", "synchronized", 4)])
def test_r_equals_c_bitwise_equals_sync(toy_setup, topology, strategy, chunk):
    """With R == C the cohort is the identity and the engine's rounds
    are the plain synchronous packed loop's, bit for bit."""
    p, assign, b = toy_setup
    b4 = {k: v[:C] for k, v in b.items()}
    fl0 = FLConfig(n_clients=C, train_fraction=0.5, strategy=strategy,
                   topology=topology, packed=True)
    ref = Federation(loss_fn=tloss, params=p, assign=assign, fl=fl0, seed=3,
                     dropout_rate=0.3, device="cpu")
    ref.server.run(3, lambda r: b4)
    eng = Federation(loss_fn=tloss, params=p, assign=assign, seed=3,
                     fl=dataclasses.replace(fl0, cohort_chunk=chunk,
                                            n_registered=C),
                     dropout_rate=0.3, device="cpu")
    eng.server.run(3, _bf(b4))
    _runs_equal(ref, eng)


def test_midround_restore_at_chunk_boundary(tmp_path, toy_setup):
    """Save after streaming 1 of 2 chunks, restore into a fresh
    Federation, finish the fit: bitwise the uninterrupted run."""
    p, assign, b = toy_setup
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True,
                  codec="qint8", cohort_chunk=2, n_registered=8)

    def fresh():
        return Federation(loss_fn=tloss, params=p, assign=assign, fl=fl,
                          seed=7, dropout_rate=0.3, device="cpu")

    ref = fresh()
    ref.server.run(3, _bf(b))
    one = fresh()
    one.server.run(1, _bf(b))
    eng = one.server.cohort_engine
    eng.begin_round()
    eng.step_chunk(_bf(b))
    path = str(tmp_path / "mid")
    save_server_state(path, one.server)
    two = fresh()
    restore_server_state(path, two.server)
    assert two.server.cohort_engine._partial["chunk"] == 1
    two.server.run(2, _bf(b))
    _runs_equal(ref, two)


def test_all_crashed_round_degrades_to_dropped(toy_setup):
    p, assign, b = toy_setup
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True,
                  n_registered=C, cohort_chunk=2, faults="crash:1.0")
    fed = Federation(loss_fn=tloss, params=p, assign=assign, fl=fl, seed=1,
                     device="cpu")
    (rec,) = fed.server.run(1, _bf(b))
    assert rec.skipped and rec.dropped and rec.loss == 0.0
    assert all(torch.equal(fed.params[k], p[k]) for k in p)


def test_engine_refusals_match_reference(toy_setup):
    p, assign, b = toy_setup
    fl = FLConfig(n_clients=C, train_fraction=0.5, n_registered=8)
    fed = Federation(loss_fn=tloss, params=p, assign=assign, fl=fl,
                     device="cpu")
    with pytest.raises(RuntimeError, match="cohort-engine mode"):
        fed.server.run_round(b)
    with pytest.raises(ValueError, match="n_clients=4 .cohort. or "
                                         "n_registered=8"):
        fed.server.run(1, _bf(b), weights=torch.ones(5))
    eng = fed.server.cohort_engine
    eng._partial = None
    eng.begin_round()
    with pytest.raises(RuntimeError, match="already in flight"):
        eng.begin_round()
    with pytest.raises(RuntimeError, match="step_chunk the rest"):
        eng.finish_round()
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=2, d=4, hidden=4, out=2)
    with pytest.raises(ValueError) as want:
        rcohort.build_cohort_programs(
            r_toy_loss, r_toy_units(rp),
            RFLConfig(n_clients=C, strategy="full", n_registered=8))
    with pytest.raises(ValueError) as got:
        cohort.build_cohort_programs(
            tloss, assign, FLConfig(n_clients=C, strategy="full",
                                    n_registered=8))
    assert str(got.value) == str(want.value)
