"""The port's checkpoints: the reference's store cases on the port
(roundtrip, manifest, shape check, adversarial files), checkpoints
crossing the packages both ways (VGG16's conv2d, IMDB's conv1d,
gossip's client-stacked replicas, the ``topk_ef`` residual, the scored
``SelectionState``; every array exact), kill+resume bitwise equal to an
uninterrupted run inside the port, and the reference's mismatch errors;
for the zoo, a reduced qwen3-1.7b ``Federation.from_config`` run crosses
both ways and resumes bitwise (hub and packed qint8).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_server_state as r_restore
from repro.ckpt import save_server_state as r_save
from repro.core import FLConfig as RFLConfig
from repro.core import RoundRecord as RRoundRecord
from repro.core import Server as RServer
from repro.core import build_round_step as r_build_round_step
from repro.core.masking import build_units_flat as r_build_units
from repro.models import paper_models as rpm
from repro_torch.ckpt import (FORMAT_VERSION, CheckpointVersionError,
                              CorruptCheckpointError, load_metadata,
                              load_pytree, restore_server_state,
                              save_pytree, save_server_state)
from repro_torch.common import flatten, unflatten
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, to_reference_flat
from repro_torch.core import (Checkpointer, FLConfig, Federation,
                              RoundRecord, Server, SelectionState,
                              build_round_step, build_units_flat)
from repro_torch.models import paper_models as pm
from repro_torch.models import toy
from repro_torch.models.transformer import init_params

C = 4
tloss = functools.partial(toy.toy_loss, device="cpu")


def _equal(a, b):
    return all(torch.equal(a[p], b[p]) for p in a) and set(a) == set(b)


# -- the store (the reference's cases, on the port) ----------------------------

def test_roundtrip_model_params(tmp_path):
    p = init_params(get_config("gemma3-12b").reduced(),
                    torch.Generator().manual_seed(0))
    path = str(tmp_path / "ck")
    save_pytree(path, p, metadata={"round": 7})
    p2 = load_pytree(path, p)
    assert _equal(p, p2)
    assert all(p2[k].dtype == p[k].dtype for k in p)
    assert load_metadata(path)["round"] == 7


def test_manifest_contents(tmp_path):
    p = {"a": torch.ones((2, 3)),
         "b": {"c": torch.zeros((4,), dtype=torch.int32)}}
    path = str(tmp_path / "x")
    save_pytree(path, p)
    with open(path + ".json") as f:
        man = json.load(f)
    assert set(man["paths"]) == {"a", "b/c"}
    assert man["shapes"]["a"] == [2, 3]
    assert man["dtypes"]["b/c"] == "int32"
    assert man["format_version"] == FORMAT_VERSION
    back = load_pytree(path, p)
    assert torch.equal(back["b"]["c"], p["b"]["c"])


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "x")
    save_pytree(path, {"a": torch.ones((2, 3))})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"a": torch.ones((3, 2))})


@pytest.fixture(scope="module")
def toy_setup():
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=4, d=8,
                         hidden=16, out=4)
    return {"p": p, "assign": toy.toy_units(p),
            "b": toy.toy_batches(torch.Generator().manual_seed(1),
                                 n_clients=C, steps=1, batch=2, d=8, out=4)}


def test_scored_server_state_manifest_carries_sel_state(tmp_path, toy_setup):
    for strategy, scored in (("score_weighted", True), ("uniform", False)):
        fl = FLConfig(n_clients=C, train_fraction=0.5, strategy=strategy)
        fed = Federation(loss_fn=tloss, params=toy_setup["p"],
                         assign=toy_setup["assign"], fl=fl, seed=0,
                         device="cpu")
        fed.server.run(1, lambda r: toy_setup["b"])
        path = str(tmp_path / strategy)
        save_server_state(path, fed.server)
        with open(path + ".json") as f:
            man = json.load(f)
        assert any(k.startswith("sel_state/") for k in man["paths"]) == scored
        assert man["metadata"].get("sel_state", False) == scored
        assert "key" not in man["metadata"]
        if scored:
            assert {"sel_state/scores", "sel_state/counts",
                    "sel_state/round"} <= set(man["paths"])
            assert man["dtypes"]["sel_state/round"] == "int32"
        else:
            assert "inp/w" in man["paths"]         # the plain flat layout


def test_server_state_roundtrip(tmp_path):
    p = pm.init_vgg16(torch.Generator().manual_seed(0), width_mult=0.125)
    assign = build_units_flat(p, pm.vgg16_units(p))
    loss = functools.partial(pm.vgg16_loss, device="cpu")
    fl = FLConfig(n_clients=2, n_train_units=3, lr=1e-3)
    srv = Server(build_round_step(loss, assign, fl, device="cpu"), assign,
                 fl, p, device="cpu")
    batch = {"x": torch.zeros((2, 1, 2, 32, 32, 3)),
             "y": torch.zeros((2, 1, 2), dtype=torch.int64)}
    srv.run_round(batch)
    path = str(tmp_path / "srv")
    save_server_state(path, srv)
    srv2 = Server(build_round_step(loss, assign, fl, device="cpu"), assign,
                  fl, pm.init_vgg16(torch.Generator().manual_seed(1),
                                    width_mult=0.125), device="cpu")
    meta = restore_server_state(path, srv2)
    assert meta["round"] == 1
    assert _equal(srv.params, srv2.params)
    assert [vars(r) for r in srv2.history] == [vars(r) for r in srv.history]


# -- adversarial files -------------------------------------------------------------

def _save_small(tmp_path, name="adv"):
    p = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    path = str(tmp_path / name)
    save_pytree(path, p, metadata={"round": 3})
    return path, p


def _same(a, b):
    fa, fb = flatten(a), flatten(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_truncated_npz_raises_typed_error(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".npz", "rb") as f:
        data = f.read()
    with open(path + ".npz", "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(CorruptCheckpointError, match="truncated|CRC32"):
        load_pytree(path, p)


def test_bitflipped_npz_raises_typed_error(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".npz", "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0x40
    with open(path + ".npz", "wb") as f:
        f.write(bytes(data))
    with pytest.raises(CorruptCheckpointError, match="CRC32"):
        load_pytree(path, p)


def test_version_mismatch_raises_typed_error(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".json") as f:
        man = json.load(f)
    man["format_version"] = FORMAT_VERSION + 1
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    with pytest.raises(CheckpointVersionError, match="format version"):
        load_pytree(path, p)
    with pytest.raises(CheckpointVersionError):
        load_metadata(path)


def test_torn_manifest_raises_typed_error(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".json") as f:
        text = f.read()
    with open(path + ".json", "w") as f:
        f.write(text[:len(text) // 2])
    with pytest.raises(CorruptCheckpointError, match="JSON"):
        load_pytree(path, p)


def test_legacy_manifest_without_checksum_still_loads(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".json") as f:
        man = json.load(f)
    del man["format_version"], man["checksum"]
    with open(path + ".json", "w") as f:
        json.dump(man, f)
    assert _same(p, load_pytree(path, p))
    assert load_metadata(path)["round"] == 3


def test_atomic_overwrite_keeps_last_good(tmp_path):
    path, p = _save_small(tmp_path)
    with open(path + ".npz.tmp", "wb") as f:
        f.write(b"torn partial bytes")
    assert _same(p, load_pytree(path, p))
    save_pytree(path, p, metadata={"round": 4})
    assert load_metadata(path)["round"] == 4
    assert _same(p, load_pytree(path, p))


# -- across the packages ---------------------------------------------------------

CROSS = ["vgg16", "vgg16-scored", "imdb", "vgg16-gossip", "vgg16-topk_ef"]


def _cross_case(case):
    """(reference params, port params, units fn, conv rank, FLConfig kw),
    one model drawn in the reference and converted."""
    if case.startswith("imdb"):
        rp = rpm.init_imdb(jax.random.PRNGKey(0), vocab=64)
        units, cs = pm.imdb_units, 1
    else:
        rp = rpm.init_vgg16(jax.random.PRNGKey(0), width_mult=0.125)
        units, cs = pm.vgg16_units, 2
    rp = jax.tree_util.tree_map(np.asarray, rp)
    kw = dict(n_clients=C, n_train_units=2)
    if case.endswith("scored"):
        kw["strategy"] = "score_weighted"
    if case.endswith("gossip"):
        kw["topology"] = "gossip"
    if case.endswith("topk_ef"):
        kw.update(packed=True, codec="topk_ef")
    return rp, from_reference(rp, conv_spatial=cs), units, cs, kw


def _ref_server(rp, units, kw):
    fl = RFLConfig(**kw)
    ra = r_build_units(rp, units(rp))
    step = r_build_round_step(lambda p, b: (0.0, {}), ra, fl)
    return RServer(step, ra, fl, jax.tree_util.tree_map(jnp.asarray, rp),
                   seed=3)


def _port_server(tp, units, cs, kw, seed=3):
    fl = FLConfig(**kw)
    ta = build_units_flat(tp, units(tp))
    step = build_round_step(lambda p, b: (0.0, {}), ta, fl, device="cpu")
    return Server(step, ta, fl, tp, seed=seed, conv_spatial=cs,
                  device="cpu")


def _fill_ref(srv, rng):
    """Random state in every slot a checkpoint carries."""
    srv.params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        srv.params)
    if srv.codec_state is not None:
        srv.codec_state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
            srv.codec_state)
    if srv.sel_state is not None:
        u = srv.sel_state.scores.shape[0]
        srv.sel_state = type(srv.sel_state)(
            jnp.asarray(rng.random(u), jnp.float32),
            jnp.asarray(rng.integers(0, 9, u), jnp.float32),
            jnp.asarray(7, jnp.int32))
    u = srv.assign.n_units
    srv.sel_history = [rng.integers(0, 2, (C, u)).astype(np.float32)
                       for _ in range(2)]
    return [dict(round=r, loss=float(rng.random()), eval_metric=None,
                 seconds=0.5, uplink_bytes=1e3 * r, trained_params=7.0,
                 n_participants=C, effective_weights=[1.0] * C)
            for r in range(2)]


@pytest.mark.parametrize("case", CROSS)
def test_reference_checkpoint_restores_into_port(tmp_path, case):
    rp, tp, units, cs, kw = _cross_case(case)
    ref = _ref_server(rp, units, kw)
    ref.history = [RRoundRecord(**r) for r in
                   _fill_ref(ref, np.random.default_rng(0))]
    path = str(tmp_path / "ref")
    r_save(path, ref)
    port = _port_server(tp, units, cs, kw)
    gen_before = port.generator.get_state()
    meta = restore_server_state(path, port)
    assert meta["round"] == 2 and "key" in meta
    want = from_reference(_np_flat(ref.params), conv_spatial=cs)
    assert _equal(port.params, want)
    if kw.get("topology") == "gossip":
        assert all(x.shape[0] == C for x in port.params.values())
    if ref.codec_state is not None:
        assert _equal(port.codec_state, from_reference(
            _np_flat(ref.codec_state), conv_spatial=cs))
    if ref.sel_state is not None:
        for a, b in zip(port.sel_state, ref.sel_state):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [vars(r) for r in port.history] == \
        [vars(r) for r in ref.history]
    assert all(np.array_equal(a, b) for a, b in
               zip(port.sel_history, ref.sel_history))
    # no torch generator state in a reference file: the caller's stays
    assert torch.equal(port.generator.get_state(), gen_before)


@pytest.mark.parametrize("case", CROSS)
def test_port_checkpoint_restores_into_reference(tmp_path, case):
    rp, tp, units, cs, kw = _cross_case(case)
    port = _port_server(tp, units, cs, kw)
    rng = np.random.default_rng(1)
    port.params = {p: torch.as_tensor(rng.standard_normal(tuple(x.shape)),
                                      dtype=x.dtype)
                   for p, x in port.params.items()}
    if port.codec_state is not None:
        port.codec_state = {p: torch.as_tensor(
            rng.standard_normal(tuple(x.shape)), dtype=x.dtype)
            for p, x in port.codec_state.items()}
    if port.sel_state is not None:
        u = port.sel_state.scores.shape[0]
        port.sel_state = SelectionState(
            torch.as_tensor(rng.random(u), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 9, u), dtype=torch.float32),
            torch.tensor(5, dtype=torch.int32))
    port.sel_history = [rng.integers(0, 2, (C, port.assign.n_units))
                        .astype(np.float32) for _ in range(3)]
    port.history = [RoundRecord(r, 0.25 * r, None, 0.1, 10.0, 3.0, C)
                    for r in range(3)]
    path = str(tmp_path / "port")
    save_server_state(path, port)
    ref = _ref_server(rp, units, kw)
    key_before = np.asarray(ref.key)
    meta = r_restore(path, ref)
    assert meta["round"] == 3 and "key" not in meta
    want = to_reference_flat(port.params, conv_spatial=cs)
    got = _np_flat(ref.params)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    if port.codec_state is not None:
        want = to_reference_flat(port.codec_state, conv_spatial=cs)
        got = _np_flat(ref.codec_state)
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    if port.sel_state is not None:
        for a, b in zip(port.sel_state, ref.sel_state):
            np.testing.assert_array_equal(np.asarray(b), a.numpy())
            assert np.asarray(b).dtype == a.numpy().dtype
    assert [vars(r) for r in ref.history] == [vars(r) for r in port.history]
    assert all(np.array_equal(a, b) for a, b in
               zip(ref.sel_history, port.sel_history))
    # the port writes no threefry key: the reference keeps its caller's
    np.testing.assert_array_equal(np.asarray(ref.key), key_before)


def _np_flat(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


# -- kill + resume inside the port (bitwise) -------------------------------------

RESUME = {"scored-hub": dict(strategy="score_weighted"),
          "scored-hierarchical-packed": dict(strategy="depth_dropout",
                                             topology="hierarchical",
                                             n_edges=2, packed=True),
          "qint8": dict(packed=True, codec="qint8"),
          "topk_ef": dict(packed=True, codec="topk_ef",
                          strategy="score_weighted"),
          "gossip": dict(topology="gossip", strategy="successive")}


def _fed(toy_setup, kw, seed, hooks=()):
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=1e-2, **kw)
    return Federation(loss_fn=tloss, params=toy_setup["p"],
                      assign=toy_setup["assign"], fl=fl, seed=seed,
                      hooks=hooks, device="cpu")


def _assert_same_run(a, b):
    assert _equal(a.state, b.state)
    if a.server.sel_state is not None:
        assert all(torch.equal(x, y) for x, y in
                   zip(a.server.sel_state, b.server.sel_state))
    if a.server.codec_state is not None:
        assert _equal(a.server.codec_state, b.server.codec_state)
    assert len(a.server.sel_history) == len(b.server.sel_history)
    assert all(np.array_equal(x, y) for x, y in
               zip(a.server.sel_history, b.server.sel_history))
    assert a.comm_summary() == b.comm_summary()
    assert [r.loss for r in a.history] == [r.loss for r in b.history]


@pytest.mark.parametrize("case", list(RESUME))
def test_kill_resume_bitwise_equals_uninterrupted(tmp_path, toy_setup, case):
    """4 rounds straight against 2, save, a fresh Federation of another
    seed restored, 2 more: bitwise equal (the generators' states ride
    in the checkpoint)."""
    kw, weights = RESUME[case], torch.as_tensor([1.0, 0.0, 2.0, 1.0])
    batch = toy_setup["b"]
    full = _fed(toy_setup, kw, seed=4)
    full.server.run(4, lambda r: batch, weights=weights)
    first = _fed(toy_setup, kw, seed=4)
    first.server.run(2, lambda r: batch, weights=weights)
    path = str(tmp_path / case)
    first.save(path)
    resumed = _fed(toy_setup, kw, seed=99)
    meta = resumed.restore(path)
    assert meta["round"] == 2 and len(resumed.history) == 2
    assert ("torch_codec_generator" in meta) == (kw.get("codec") == "qint8")
    resumed.server.run(2, lambda r: batch, weights=weights)
    _assert_same_run(full, resumed)


def test_checkpointer_hook_saves_the_pending_round(tmp_path, toy_setup):
    kw = RESUME["scored-hub"]
    path = str(tmp_path / "hook")
    full = _fed(toy_setup, kw, seed=6)
    full.server.run(4, lambda r: toy_setup["b"])
    killed = _fed(toy_setup, kw, seed=6, hooks=(Checkpointer(path, every=3),))
    for _ in range(3):                 # killed after round 2, before fit end
        killed.run_round(toy_setup["b"])
    assert load_metadata(path)["round"] == 3
    resumed = _fed(toy_setup, kw, seed=0)
    resumed.restore(path)
    resumed.run_round(toy_setup["b"])
    _assert_same_run(full, resumed)


# -- the zoo: reduced qwen3-1.7b through Federation.from_config -------------------

ZOO_KW = dict(n_clients=2, train_fraction=0.5, lr=2e-3)


def _zoo_fed(seed, kw=ZOO_KW):
    from repro_torch.data import FederatedLoader as TLoader
    from repro_torch.data import iid_partition, lm_batch
    cfg = get_config("qwen3-1.7b").reduced()
    data = lm_batch(16, 16, cfg.vocab, key=seed)
    shards = iid_partition(16, 2, key=seed + 1)
    loader = TLoader([{k: v[i] for k, v in data.items()} for i in shards],
                     batch_size=2, steps_per_round=1, key=seed)
    return Federation.from_config(cfg, FLConfig(**kw), data=loader,
                                  seed=seed, device="cpu")


def _zoo_ref_server():
    from repro.configs.base import get_config as r_get_config
    from repro.core.masking import build_units_zoo as r_build_units_zoo
    from repro.models import get_model as r_get_model
    rcfg = r_get_config("qwen3-1.7b").reduced()
    rp = r_get_model(rcfg).init_params(jax.random.PRNGKey(1))
    fl = RFLConfig(**ZOO_KW)
    ra = r_build_units_zoo(rcfg, rp)
    step = r_build_round_step(lambda p, b: (0.0, {}), ra, fl)
    return RServer(step, ra, fl, rp, seed=3)


def test_zoo_checkpoint_crosses_both_ways(tmp_path):
    """A trained reduced-qwen3 Federation's checkpoint restores into the
    reference's server and the reference's back into a fresh port
    Federation: params and selection history bitwise."""
    port = _zoo_fed(seed=0)
    port.fit(2)
    path = str(tmp_path / "port")
    port.save(path)
    ref = _zoo_ref_server()
    assert r_restore(path, ref)["round"] == 2
    want = to_reference_flat(port.params)
    got = _np_flat(ref.params)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert all(np.array_equal(a, b) for a, b in
               zip(ref.sel_history, port.server.sel_history))
    back = str(tmp_path / "ref")
    r_save(back, ref)
    fresh = _zoo_fed(seed=5)
    assert fresh.restore(back)["round"] == 2
    assert _equal(fresh.params, from_reference(_np_flat(ref.params)))
    assert _equal(fresh.params, port.params)
    assert len(fresh.server.sel_history) == 2
    assert all(np.array_equal(a, b) for a, b in
               zip(fresh.server.sel_history, port.server.sel_history))


@pytest.mark.parametrize("kw", [ZOO_KW, dict(ZOO_KW, packed=True,
                                              codec="qint8")],
                         ids=["hub", "packed-qint8"])
def test_zoo_kill_resume_bitwise_equals_uninterrupted(tmp_path, kw):
    full = _zoo_fed(seed=2, kw=kw)
    full.fit(4)
    first = _zoo_fed(seed=2, kw=kw)
    first.fit(2)
    path = str(tmp_path / "zoo")
    first.save(path)
    resumed = _zoo_fed(seed=2, kw=kw)
    resumed.server.generator.manual_seed(99)
    if resumed.server.codec_generator is not None:
        resumed.server.codec_generator.manual_seed(99)
    assert resumed.restore(path)["round"] == 2
    resumed.fit(2)
    _assert_same_run(full, resumed)


# -- mismatches -------------------------------------------------------------------

@pytest.mark.parametrize("saved,into,match", [
    (dict(strategy="score_weighted"), {}, "stateful strategy"),
    ({}, dict(strategy="score_weighted"), "no selection state"),
    (dict(packed=True, codec="topk_ef"), dict(packed=True),
     "codec error-feedback state"),
    (dict(packed=True), dict(packed=True, codec="topk_ef"), "no codec state")])
def test_mismatch_raises_reference_errors(tmp_path, toy_setup, saved, into,
                                          match):
    """The port's restore raises the reference's ValueError, word for
    word, on a strategy or codec mismatch."""
    src = _fed(toy_setup, saved, seed=0)
    src.server.run(1, lambda r: toy_setup["b"])
    path = str(tmp_path / "m")
    src.save(path)
    with pytest.raises(ValueError, match=match) as got:
        _fed(toy_setup, into, seed=0).restore(path)
    # the reference's restore on the same manifest flags
    rp = jax.tree_util.tree_map(jnp.asarray, unflatten(
        {p: x.numpy() for p, x in toy_setup["p"].items()}))
    from repro.models.toy import toy_units as r_toy_units
    rfl = RFLConfig(n_clients=C, train_fraction=0.5, **into)
    rsrv = RServer(r_build_round_step(lambda p, b: (0.0, {}),
                                      r_toy_units(rp), rfl),
                   r_toy_units(rp), rfl, rp)
    with pytest.raises(ValueError) as want:
        r_restore(path, rsrv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field", ["async", "cohort", "sel_base"])
def test_unported_engine_state_is_refused(tmp_path, toy_setup, field):
    """Engine state restores only into a Federation running that engine:
    the reference's ValueError, word for word, otherwise.  ``history_cap``
    totals (``sel_base``) need no engine and restore into any server."""
    fed = _fed(toy_setup, {}, seed=0)
    path = str(tmp_path / field)
    totals = {"uplink": 123.5, "trained": 77.0, "rounds": 3}
    extra = {field: {"anything": 1}} if field != "sel_base" else \
        {"sel_base": 3, "comm_totals": totals}
    fed.save(path, extra=extra)
    into = _fed(toy_setup, {}, seed=0)
    if field == "sel_base":
        into.restore(path)
        assert into.server._sel_base == 3
        assert into.server._comm_totals == totals
        return
    with pytest.raises(ValueError) as got:
        into.restore(path)
    rp = jax.tree_util.tree_map(jnp.asarray, unflatten(
        {p: x.numpy() for p, x in toy_setup["p"].items()}))
    from repro.models.toy import toy_units as r_toy_units
    rfl = RFLConfig(n_clients=C, train_fraction=0.5)
    rsrv = RServer(r_build_round_step(lambda p, b: (0.0, {}),
                                      r_toy_units(rp), rfl),
                   r_toy_units(rp), rfl, rp)
    with pytest.raises(ValueError) as want:
        r_restore(path, rsrv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("task,rank", [("imdb", 1), ("casa", 2)])
def test_paper_task_federation_carries_its_conv_rank(task, rank):
    from repro_torch import paper_tasks
    fed = paper_tasks.build(task, "cpu", evaluate=False)
    assert fed.server.conv_spatial == rank


# -- the round engines' state and history_cap, across the packages ------------

ENGINES = {
    "async": dict(async_buffer=2, client_delay_dist="pareto:1.5"),
    "async-qint8-hierarchical": dict(async_buffer=3, packed=True,
                                     codec="qint8", topology="hierarchical",
                                     n_edges=2,
                                     client_delay_dist="exponential"),
    "async-topk_ef-scored": dict(async_buffer=2, packed=True,
                                 codec="topk_ef", strategy="score_weighted",
                                 client_delay_dist="pareto:1.5"),
    "cohort-midround": dict(n_registered=8, cohort_chunk=2, packed=True,
                            codec="qint8"),
    "cohort-hierarchical-scored": dict(n_registered=8, cohort_chunk=2,
                                       topology="hierarchical", n_edges=2,
                                       strategy="score_weighted"),
    "history_cap": dict(history_cap=2, packed=True),
}


def _engine_run(fed, kw, batches, ids_of):
    """Two rounds (flushes), and for a cohort run one more chunk, so the
    checkpoint holds a mid-round partial aggregate."""
    srv = fed.server
    if srv.cohort_engine is not None:
        bf = lambda r, ids: ids_of(batches, ids)          # noqa: E731
        srv.run(2, bf)
        srv.cohort_engine.begin_round()
        srv.cohort_engine.step_chunk(bf)
    else:
        srv.run(4 if kw.get("history_cap") else 2, lambda r: ids_of(
            batches, np.arange(C)))


def _engine_view(srv, ref: bool, cs: int = 2):
    """A server's engine and history_cap state as flat numpy arrays in
    the reference's layout, plus the engines' metadata."""
    from repro.common.pytree import flatten_with_paths as r_flat
    from repro_torch.ckpt import store
    out = {"sel_base": srv._sel_base, "totals": dict(srv._comm_totals),
           "summary": srv.comm_summary()}
    for name, conv in (("async_engine", store._async_to_ref),
                       ("cohort_engine", store._cohort_to_ref)):
        eng = getattr(srv, name)
        if eng is None:
            continue
        meta, arrays = eng.checkpoint_state()
        flat = {p: np.asarray(x) for p, x in r_flat(arrays)} if ref else \
            {p: np.asarray(x) for p, x in flatten(conv(arrays, cs)).items()}
        out[name] = (meta, flat)
    return out


def _assert_same_view(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith("_engine"):
            (ma, fa), (mb, fb) = a[k], b[k]
            assert json.loads(json.dumps(ma)) == json.loads(json.dumps(mb))
            assert fa.keys() == fb.keys() and fa
            for p in fa:
                assert np.array_equal(fa[p], fb[p]), (k, p)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def toy8():
    rp = jax.tree_util.tree_map(np.asarray, __import__(
        "repro.models.toy", fromlist=["x"]).init_toy_mlp(
            jax.random.PRNGKey(0), n_blocks=4, d=8, hidden=16, out=4))
    rng = np.random.default_rng(3)
    batches = {"x": rng.normal(size=(8, 1, 2, 8)).astype(np.float32),
               "y": rng.normal(size=(8, 1, 2, 4)).astype(np.float32)}
    return rp, batches


def _ref_fed(rp, kw, seed=3):
    from repro.core import Federation as RFederation
    from repro.models.toy import toy_loss as r_toy_loss
    from repro.models.toy import toy_units as r_toy_units
    return RFederation(loss_fn=r_toy_loss, params=jax.tree_util.tree_map(
        jnp.asarray, rp), assign=r_toy_units(rp), seed=seed,
        fl=RFLConfig(n_clients=C, train_fraction=0.5, fused_agg="off", **kw))


def _port_fed(rp, kw, seed=3):
    tp = from_reference(rp)
    return Federation(loss_fn=tloss, params=tp, assign=toy.toy_units(tp),
                      fl=FLConfig(n_clients=C, train_fraction=0.5, **kw),
                      seed=seed, device="cpu")


@pytest.mark.parametrize("case", list(ENGINES))
def test_reference_engine_checkpoint_restores_into_port(tmp_path, toy8,
                                                        case):
    rp, batches = toy8
    kw = ENGINES[case]
    ref = _ref_fed(rp, kw)
    _engine_run(ref, kw, {k: jnp.asarray(v) for k, v in batches.items()},
                lambda b, ids: jax.tree_util.tree_map(
                    lambda x: x[np.asarray(ids)], b))
    path = str(tmp_path / "ref")
    r_save(path, ref.server)
    port = _port_fed(rp, kw, seed=0)
    meta = restore_server_state(path, port.server)
    assert ("async" in meta) == ("async_buffer" in kw)
    assert ("cohort" in meta) == ("n_registered" in kw)
    assert ("sel_base" in meta) == ("history_cap" in kw)
    _assert_same_view(_engine_view(port.server, ref=False),
                      _engine_view(ref.server, ref=True))


@pytest.mark.parametrize("case", list(ENGINES))
def test_port_engine_checkpoint_restores_into_reference(tmp_path, toy8,
                                                        case):
    rp, batches = toy8
    kw = ENGINES[case]
    port = _port_fed(rp, kw)
    _engine_run(port, kw, {k: torch.as_tensor(v) for k, v in
                           batches.items()},
                lambda b, ids: {k: v[torch.as_tensor(np.asarray(ids))]
                                for k, v in b.items()})
    path = str(tmp_path / "port")
    save_server_state(path, port.server)
    ref = _ref_fed(rp, kw, seed=0)
    meta = r_restore(path, ref.server)
    assert "key" not in meta
    _assert_same_view(_engine_view(port.server, ref=False),
                      _engine_view(ref.server, ref=True))


@pytest.mark.parametrize("kw", [
    dict(async_buffer=2, client_delay_dist="pareto:1.5"),
    dict(n_registered=6, cohort_chunk=2, packed=True)],
    ids=["async", "cohort-midround"])
def test_vgg16_engine_checkpoint_converts_conv_kernels(tmp_path, kw):
    """VGG16's conv kernels inside buffered slot deltas and a partial
    aggregate are written channels-last (the reference's layout) and
    restore into the reference exactly."""
    rp, tp, units, cs, _ = _cross_case("vgg16")
    fl_kw = dict(n_clients=C, n_train_units=3, **kw)
    ta = build_units_flat(tp, units(tp))
    fed = Federation(loss_fn=functools.partial(pm.vgg16_loss, device="cpu"),
                     params=tp, assign=ta, fl=FLConfig(**fl_kw), seed=2,
                     device="cpu")
    rng = np.random.default_rng(0)
    b = {"x": torch.as_tensor(rng.normal(size=(6, 1, 2, 32, 32, 3))
                              .astype(np.float32)),
         "y": torch.as_tensor(rng.integers(0, 10, (6, 1, 2)))}
    _engine_run(fed, kw, b, lambda bb, ids: {
        k: v[torch.as_tensor(np.asarray(ids))] for k, v in bb.items()})
    path = str(tmp_path / "vgg")
    save_server_state(path, fed.server)
    with open(path + ".json") as f:
        shapes = json.load(f)["shapes"]
    conv = [k for k in shapes if k.endswith(("pdelta/conv0/w", "acc/conv0/w"))]
    assert conv and all(shapes[k][-4:] == list(rp["conv0"]["w"].shape)
                        for k in conv)
    from repro.core import Federation as RFederation
    ref = RFederation(loss_fn=lambda p, bb: (0.0, {}),
                      params=jax.tree_util.tree_map(jnp.asarray, rp),
                      assign=r_build_units(rp, rpm.vgg16_units(rp)),
                      fl=RFLConfig(fused_agg="off", **fl_kw), seed=0)
    r_restore(path, ref.server)
    _assert_same_view(_engine_view(fed.server, ref=False, cs=cs),
                      _engine_view(ref.server, ref=True))
