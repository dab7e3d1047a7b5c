"""The port's fault axis (``repro_torch.core.faults``) and its defenses
against the reference's.

The reference's fault draws are numpy ``SeedSequence`` draws, ported
verbatim, so every fault plan, crash mask, resample, kill, duplicate
and torn delivery is held **array-equal** to the reference's.  The
corruption transform (``chaos_inject``, ``_bitflip_leaf``) and the
async path's ``perturb_update`` are held **bitwise**; the validation
gate (``gate_packed_updates``) within 2e-5 on its cleaned deltas with
its gated weights and quarantine vector **exact**; ``Backoff`` delays
exactly.  The engine-level properties — zero-rate chaos == clean,
quarantined == injected, kill+resume == uninterrupted — are held inside
the port (bitwise where they say so), on the toy MLP of the reference's
own fault tests.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import retry as rretry
from repro.core import FLConfig as RFLConfig
from repro.core import aggregation as ragg
from repro.core import async_agg as rasync
from repro.core import faults as rfaults
from repro.core.masking import slot_plan as r_slot_plan
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten, retry, unflatten
from repro_torch.convert import from_reference
from repro_torch.core import (Checkpointer, FLConfig, Federation, ServerHook,
                              aggregation, async_agg, faults,
                              run_with_restarts)
from repro_torch.data import FederatedLoader, iid_partition
from repro_torch.models import toy

C = 4
GATE_TOL = 2e-5        # the gate's cleaned deltas, port vs reference
tloss = functools.partial(toy.toy_loss, device="cpu")
SPEC = "crash:0.3,nan:0.2,inf:0.1,bitflip:0.2,scale:0.2:512,duplicate:0.3," \
       "torn:0.25,kill:0.3"


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _bits(x):
    """Raw bits of a float array (NaN payloads included)."""
    a = _np(x)
    return a.view({8: np.int64, 4: np.int32, 2: np.int16}[a.itemsize])


# -- registry, parser, config validation -------------------------------------

def test_registry_and_parser_match_reference():
    assert faults.registered_faults() == rfaults.registered_faults()
    for name in faults.registered_faults():
        a, b = faults.get_fault(name), rfaults.get_fault(name)
        assert (a.seam, a.mode, a.default_param) == \
            (b.seam, b.mode, b.default_param)
    got = faults.parse_faults(SPEC + ", nan:0.05:3")
    want = rfaults.parse_faults(SPEC + ", nan:0.05:3")
    assert [(f.name, f.prob, f.param) for f in got] == \
        [(f.name, f.prob, f.param) for f in want]


@pytest.mark.parametrize("spec", ["crash", "nan:x", "nan:0.1:2:3",
                                  "meteor:0.1", "nan:1.5"])
def test_bad_fault_specs_raise_the_reference_errors(spec):
    with pytest.raises(ValueError) as want:
        rfaults.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_faults(spec)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {"faults": "nan:0.1"},
    {"faults": "nan:0.1", "packed": True, "topology": "gossip"},
    {"faults": "duplicate:0.1", "packed": True},
    {"faults": "torn:0.1", "async_buffer": 2},
    {"max_delta_norm": 1.0},
    {"max_delta_norm": -1.0, "packed": True},
    {"fault_retries": -1},
])
def test_flconfig_fault_validators_match_reference(kw):
    with pytest.raises(ValueError) as want:
        RFLConfig(n_clients=C, **kw)
    with pytest.raises(ValueError) as got:
        FLConfig(n_clients=C, **kw)
    assert str(got.value) == str(want.value)


# -- the injector's draws: array-equal ---------------------------------------

@pytest.mark.parametrize("seed,inc", [(0, 0), (7, 2)])
def test_injector_draws_equal_reference(seed, inc):
    a = faults.FaultInjector(SPEC, seed=seed, incarnation=inc)
    b = rfaults.FaultInjector(SPEC, seed=seed, incarnation=inc)
    assert a.has_delta == b.has_delta and a.crash_prob == b.crash_prob
    clients = list(range(12))
    for r in range(6):
        assert np.array_equal(a.crash_mask(r, clients),
                              b.crash_mask(r, clients))
        pa, pb = a.corrupt_plan(r, clients), b.corrupt_plan(r, clients)
        assert pa["mode"].dtype == pb["mode"].dtype == np.int32
        assert np.array_equal(pa["mode"], pb["mode"])
        assert np.array_equal(pa["scale"], pb["scale"])
        assert a.kill(r) == b.kill(r)
        for pos in range(4):
            for k in range(3):
                ex = frozenset({1, 3, pos})
                assert a.resample(r, pos, k, 9, ex) == \
                    b.resample(r, pos, k, 9, ex)
    grid = [(c, s) for c in range(6) for s in range(10)]
    for name in ("crashed_async", "corrupt_async", "duplicated", "torn"):
        assert [getattr(a, name)(c, s) for c, s in grid] == \
            [getattr(b, name)(c, s) for c, s in grid], name
    assert a.resample(0, 0, 0, 3, frozenset({0, 1, 2})) is None
    # every seam fired somewhere on this grid, so the equality is not
    # a comparison of all-clean plans
    assert any(a.crashed_async(c, s) for c, s in grid)
    assert any(a.torn(c, s) for c, s in grid)
    assert {a.corrupt_async(c, s)[0] for c, s in grid} == {0, 1, 2, 3, 4}


def test_zero_rate_injector_never_fires():
    inj = faults.FaultInjector("crash:0,nan:0,kill:0,duplicate:0,torn:0")
    assert inj.has_delta and inj.crash_prob == 0.0
    assert not inj.crash_mask(0, range(8)).any()
    assert not (inj.corrupt_plan(3, range(8))["mode"]).any()
    assert not any(inj.kill(r) or inj.torn(0, r) or inj.duplicated(0, r)
                   for r in range(20))


# -- the corruption transform: bitwise ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_bitflip_leaf_bitwise(dtype):
    x = np.random.default_rng(0).normal(0, 1e-2, (5, 7)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 3.5]
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    want = np.asarray(rfaults._bitflip_leaf(jx)).view(
        np.int32 if dtype == "float32" else np.int16)
    got = faults._bitflip_leaf(tx).view(
        torch.int32 if dtype == "float32" else torch.int16).numpy()
    assert np.array_equal(got, want)


def _packed_like():
    """Client-stacked packed deltas: a stacked (C, L, d) leaf, a scalar
    (C, d, d) leaf and an int leaf that passes through."""
    rng = np.random.default_rng(1)
    return {"blocks/w": rng.normal(0, 1e-2, (C, 3, 6)).astype(np.float32),
            "head/w": rng.normal(0, 1e-2, (C, 6, 4)).astype(np.float32),
            "idx": rng.integers(0, 9, (C, 2)).astype(np.int32)}


@pytest.mark.parametrize("mode", [[0, 0, 0, 0], [0, 1, 2, 3], [4, 3, 1, 0]])
def test_chaos_inject_bitwise(mode):
    d = _packed_like()
    mode = np.asarray(mode, np.int32)
    scale = np.asarray([1.0, 3.0, 0.5, 1024.0], np.float32)
    want = rfaults.chaos_inject({k: jnp.asarray(v) for k, v in d.items()},
                                jnp.asarray(mode), jnp.asarray(scale))
    got = faults.chaos_inject({k: torch.as_tensor(v) for k, v in d.items()},
                              torch.as_tensor(mode), torch.as_tensor(scale))
    for k in d:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    if not mode.any():              # mode 0: the very bits that went in
        assert all(np.array_equal(_bits(got[k]), _bits(d[k])) for k in d)


def test_perturb_update_bitwise():
    """The async path's host-side corruption and torn delivery of one
    buffered update, over a grid of (client, seq) draws."""
    a = faults.FaultInjector(SPEC, seed=3)
    b = rfaults.FaultInjector(SPEC, seed=3)
    d = {k: v[0] for k, v in _packed_like().items()}
    kinds = set()
    for c in range(4):
        for s in range(8):
            tu = async_agg.BufferedUpdate(
                client=c, seq=s, version=0, t_done=0.0, weight=1.0,
                loss=0.0, sel_row=np.ones(3, np.float32),
                pdelta={k: torch.as_tensor(v) for k, v in d.items()},
                rows={}, valid={})
            ru = rasync.BufferedUpdate(
                client=c, seq=s, version=0, t_done=0.0, weight=1.0,
                loss=0.0, sel_row=np.ones(3, np.float32),
                pdelta={k: np.asarray(v) for k, v in d.items()},
                rows={}, valid={})
            got, want = a.perturb_update(tu), b.perturb_update(ru)
            assert (got is tu) == (want is ru)
            kinds.add((a.corrupt_async(c, s)[0], a.torn(c, s)))
            for k in d:
                assert np.array_equal(_bits(got.pdelta[k]),
                                      _bits(want.pdelta[k])), (c, s, k)
    assert len(kinds) >= 5, kinds          # clean, torn and several modes


# -- the validation gate -----------------------------------------------------

@pytest.fixture(scope="module")
def gate_inputs():
    """Toy-MLP packed deltas of C clients with their slot plans: client 1
    NaN in a trained row, client 2 NaN only in a pad row (and a scalar
    leaf it does not train), client 3 scaled by 1e3."""
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    ra = r_toy_units(rp)
    rng = np.random.default_rng(2)
    sel = np.zeros((C, ra.n_units), np.float32)
    for c in range(C):
        sel[c, rng.permutation(ra.n_units)[:ra.n_units // 2]] = 1.0
    plans = [r_slot_plan(ra, jnp.asarray(s), ra.n_units // 2, rp)
             for s in sel]
    rows = {p: np.stack([np.asarray(flatten(pl[0])[p]) for pl in plans])
            for p in flatten(rp)}
    valid = {p: np.stack([np.asarray(flatten(pl[1])[p]) for pl in plans])
             for p in flatten(rp)}
    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    ta = toy.toy_units(tp)
    deltas = {}
    for p, x in tp.items():
        shape = (C,) + tuple(x.shape) if ta.leaf_units[p].kind == "scalar" \
            else (C, rows[p].shape[1]) + tuple(x.shape[1:])
        deltas[p] = rng.normal(0, 1e-2, shape).astype(np.float32)
    stacked = [p for p in deltas if ta.leaf_units[p].kind == "stacked"]
    scalar = [p for p in deltas if ta.leaf_units[p].kind == "scalar"]
    p0 = stacked[0]
    v1 = int(np.argmax(valid[p0][1]))
    deltas[p0][1, v1, 0] = np.nan                        # a trained row
    pad = [i for i in range(valid[p0].shape[1]) if valid[p0][2, i] == 0]
    deltas[p0][2, pad[0], 0] = np.nan                    # a pad row only
    untrained = [p for p in scalar if valid[p][2] == 0]
    if untrained:
        deltas[untrained[0]][2].flat[0] = np.inf
    deltas[p0][3] *= 1e3
    weights = np.asarray([1.0, 2.0, 0.5, 3.0], np.float32)
    return ra, ta, deltas, rows, valid, weights


@pytest.mark.parametrize("max_norm", [0.0, 5.0])
def test_gate_matches_reference(gate_inputs, max_norm):
    ra, ta, deltas, rows, valid, weights = gate_inputs
    def rtree(t):
        return jax.tree_util.tree_map(jnp.asarray, unflatten(t))

    w_clean, w_w, w_q = ragg.gate_packed_updates(
        ra, rtree(deltas), rtree(valid), jnp.asarray(weights), max_norm)
    g_clean, g_w, g_q = aggregation.gate_packed_updates(
        ta, {k: torch.as_tensor(v) for k, v in deltas.items()},
        {k: torch.as_tensor(v) for k, v in valid.items()},
        torch.as_tensor(weights), max_norm)
    want_q = np.asarray(w_q)
    assert np.array_equal(_np(g_q), want_q)
    assert np.array_equal(_np(g_w), np.asarray(w_w))
    assert want_q[1] == 1.0 and want_q[2] == 0.0   # pad NaN: not the client
    assert want_q[3] == (1.0 if max_norm else 0.0)
    w_clean = flatten(jax.tree_util.tree_map(np.asarray, w_clean))
    for k in deltas:
        got = _np(g_clean[k])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, w_clean[k], rtol=0, atol=GATE_TOL)


def test_untripped_gate_is_bitwise_transparent(gate_inputs):
    _, ta, deltas, _, valid, weights = gate_inputs
    clean = {k: np.nan_to_num(v, nan=0.0, posinf=0.0) for k, v in
             deltas.items()}
    d = {k: torch.as_tensor(v) for k, v in clean.items()}
    out, w, q = aggregation.gate_packed_updates(
        ta, d, {k: torch.as_tensor(v) for k, v in valid.items()},
        torch.as_tensor(weights), 1e9)
    assert all(torch.equal(out[k], d[k]) for k in d)
    assert torch.equal(w, torch.as_tensor(weights)) and not q.any()


# -- retry -------------------------------------------------------------------

def test_backoff_matches_reference():
    for kw in ({}, {"seed": 5, "jitter": 0.0}, {"seed": 9, "base": 0.2,
                                                 "factor": 3.0}):
        a, b = retry.Backoff(**kw), rretry.Backoff(**kw)
        for attempt in range(6):
            for token in (0, 7, (2, 3)):
                assert a.delay(attempt, token) == b.delay(attempt, token)
    for bad in ({"attempts": -1}, {"jitter": 1.5}):
        with pytest.raises(ValueError) as want:
            rretry.Backoff(**bad)
        with pytest.raises(ValueError) as got:
            retry.Backoff(**bad)
        assert str(got.value) == str(want.value)


def test_retry_call_matches_reference():
    def run(mod, fail_until):
        sleeps, calls = [], []

        def fn(attempt):
            calls.append(attempt)
            if attempt < fail_until:
                raise KeyError(attempt)
            return attempt

        try:
            out = mod.retry_call(fn, backoff=mod.Backoff(attempts=4, seed=1),
                                 retry_on=(KeyError,), token=(1, 2),
                                 sleep=sleeps.append)
        except KeyError as e:
            out = ("raised", e.args)
        return out, calls, sleeps

    for fail_until in (0, 2, 9):
        assert run(retry, fail_until) == run(rretry, fail_until)
    with pytest.raises(TypeError):                   # not retried
        retry.retry_call(lambda a: (_ for _ in ()).throw(TypeError()),
                         backoff=retry.Backoff(), retry_on=(KeyError,),
                         sleep=None)


# -- the engines under chaos, inside the port --------------------------------

SYNC = FLConfig(n_clients=C, train_fraction=0.5, packed=True)
COHORT = dataclasses.replace(SYNC, cohort_chunk=2, n_registered=C)
ASYNC = dataclasses.replace(SYNC, async_buffer=C, staleness="constant",
                            client_delay_dist="none")


@pytest.fixture(scope="module")
def toy_setup():
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=6,
                         d=16, hidden=32, out=4)
    return p, toy.toy_units(p), toy.toy_batches(
        torch.Generator().manual_seed(1), n_clients=C, steps=2, batch=2,
        d=16, out=4)


def _fed(fl, setup, **kw):
    p, assign, _ = setup
    return Federation(loss_fn=tloss, params=p, assign=assign, fl=fl, seed=3,
                      device="cpu", **kw)


def _run(fed, setup, rounds=3):
    b = setup[2]
    if fed.fl.uses_cohort_engine():
        return fed.server.run(rounds, lambda r, ids: {
            k: v[torch.as_tensor(np.asarray(ids))] for k, v in b.items()})
    return fed.server.run(rounds, lambda r: b)


def _same(a, b):
    return all(torch.equal(a.params[p], b.params[p]) for p in a.params)


@pytest.mark.parametrize("fl", [SYNC, COHORT, ASYNC],
                         ids=["sync", "cohort", "async"])
def test_zero_rate_faults_bitwise_noop(toy_setup, fl):
    """Every rate 0: the corruption transform and the gate run and are
    exact identities, so the run is bitwise the fault-free one."""
    ref = _fed(fl, toy_setup)
    _run(ref, toy_setup)
    spec = "crash:0,nan:0,kill:0" if not fl.async_buffer \
        else "crash:0,nan:0,kill:0,duplicate:0,torn:0"
    z = _fed(dataclasses.replace(fl, faults=spec), toy_setup)
    _run(z, toy_setup)
    assert _same(ref, z)
    for ra, rb in zip(ref.history, z.history):
        assert ra.loss == rb.loss and rb.wasted_bytes == 0.0
    assert ref.comm_summary() == z.comm_summary()


class _Capture(ServerHook):
    def __init__(self):
        self.quars = []

    def on_round_end(self, server, record, metrics):
        q = None if metrics is None else metrics.get("quarantined")
        self.quars.append(None if q is None else np.asarray(q, np.float32))


@pytest.mark.parametrize("fl,spec", [
    (SYNC, "nan:0.4"), (COHORT, "nan:0.4"),
    (dataclasses.replace(SYNC, max_delta_norm=100.0), "scale:0.4:4096")],
    ids=["sync-nan", "cohort-nan", "sync-norm"])
def test_quarantined_equals_injected(toy_setup, fl, spec):
    """Every corrupted upload, and only those, is quarantined: the
    quarantine vector equals the injector's plan recomputed from the
    seed, the params stay finite and the waste is billed."""
    cap = _Capture()
    fed = _fed(dataclasses.replace(fl, faults=spec), toy_setup, hooks=[cap])
    _run(fed, toy_setup, rounds=4)
    inj = fed.server.fault_injector
    hit = 0
    for r, q in enumerate(cap.quars):
        want = inj.corrupt_plan(r, range(C))["mode"] != 0
        assert np.array_equal(q > 0, want), f"round {r}"
        hit += int(want.sum())
    assert hit > 0
    assert all(bool(torch.isfinite(x).all()) for x in fed.params.values())
    assert sum(r.wasted_bytes for r in fed.history) > 0.0


def test_sync_crash_hook_matches_reference():
    """``ChaosHook`` on the synchronous path zeroes crashed clients'
    weights, as the reference's does; it stands down under an engine."""
    class Srv:
        cohort_engine = async_engine = None
    spec = "crash:0.4"
    a = faults.ChaosHook(faults.FaultInjector(spec, seed=2))
    b = rfaults.ChaosHook(rfaults.FaultInjector(spec, seed=2))
    w = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    zeroed = 0
    for r in range(6):
        got = a.on_round_start(Srv(), r, torch.as_tensor(w))
        want = b.on_round_start(Srv(), r, jnp.asarray(w))
        assert np.array_equal(_np(got), np.asarray(want))
        zeroed += int((_np(got) == 0).sum())
    assert zeroed > 0
    eng = Srv()
    eng.cohort_engine = object()
    assert a.on_round_start(eng, 0, torch.as_tensor(w)) is None


def test_async_chaos_completes_and_accounts_waste(toy_setup):
    fl = dataclasses.replace(ASYNC, client_drop_prob=0.2,
                             faults="duplicate:0.3,torn:0.2,crash:0.1")
    fed = _fed(fl, toy_setup)
    hist = _run(fed, toy_setup, rounds=5)
    assert len(hist) == 5
    assert all(bool(torch.isfinite(x).all()) for x in fed.params.values())
    total = fed.comm_summary()["total_wasted_bytes"]
    assert total > 0.0
    assert total == pytest.approx(sum(r.wasted_bytes for r in hist))


def test_buffered_aggregator_rejects_duplicate_seq():
    agg = async_agg.BufferedAggregator(8, "constant", 0.5, lambda *a: a[0])
    upd = async_agg.BufferedUpdate(
        client=1, seq=3, version=0, t_done=0.0, weight=1.0, loss=0.0,
        sel_row=np.zeros((2,), np.float32), pdelta={}, rows={}, valid={})
    assert agg.push(upd)
    assert not agg.push(upd)                       # exact redelivery
    assert not agg.push(dataclasses.replace(upd, seq=2))   # stale seq
    assert agg.push(dataclasses.replace(upd, seq=4))
    assert agg.push(dataclasses.replace(upd, client=2, seq=3))


def _loader():
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(0, 1, (64, 16)).astype(np.float32),
            "y": rng.normal(0, 1, (64, 4)).astype(np.float32)}
    shards = iid_partition(64, C, key=1)
    return FederatedLoader([{k: v[s] for k, v in data.items()}
                            for s in shards], batch_size=2,
                           steps_per_round=2, key=5)


@pytest.mark.parametrize("fl", [
    SYNC, COHORT, ASYNC,
    dataclasses.replace(SYNC, history_cap=2, codec="qint8")],
    ids=["sync", "cohort", "async", "history_cap"])
def test_kill_and_resume_bitwise_equals_uninterrupted(tmp_path, toy_setup,
                                                      fl):
    """Server kills between end-of-round hooks, auto-resume from the last
    checkpoint (``run_with_restarts``): the stitched run equals the
    uninterrupted fit bitwise — params, losses, history and the bill."""
    rounds = 5
    p, assign, _ = toy_setup
    ref = Federation(loss_fn=tloss, params=p, assign=assign,
                     fl=fl, loader=_loader(), seed=3, device="cpu")
    ref.fit(rounds)
    path = str(tmp_path / "ck")

    def make(inc):
        return Federation(loss_fn=tloss, params=p, assign=assign,
                          fl=dataclasses.replace(fl, faults="kill:0.5"),
                          loader=_loader(), seed=3, incarnation=inc,
                          hooks=[Checkpointer(path, every=1)], device="cpu")

    fed = run_with_restarts(make, rounds, path)
    assert fed.server.fault_injector.incarnation > 0
    assert _same(ref, fed)
    assert len(fed.history) == rounds
    for ra, rb in zip(ref.history, fed.history):
        assert ra.round == rb.round and ra.loss == rb.loss
    assert ref.comm_summary() == fed.comm_summary()
