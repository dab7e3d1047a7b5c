"""The port's hierarchical and gossip topologies against the reference:
byte formulas (exact), the ring mixing matrix (exact), the two-stage
aggregation (2e-5), one round of each topology on the toy MLP with the
reference's selection replayed, and the port's Table 4 script.

The toy MLP (6 stacked blocks, d 16, hidden 32, 4 clients, 2 edges of
2) carries both leaf kinds, so the per-edge packed accumulate runs its
stacked and scalar branches.  Rounds use Adam at lr 1e-2 with a
zero-weight client; every leaf is held at 2e-5 (measured up to 3.0e-8).
The reference rounds run once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import aggregation as ragg
from repro.core import build_round_step as r_build_round_step
from repro.core import codecs as rcodecs
from repro.core import comm as rcomm
from repro.core import topology as rtopo
from repro.core.codecs import CODEC_KEY_TAG
from repro.core.freezing import select_clients
from repro.core.masking import build_units_flat as r_build_units
from repro.core.masking import slot_plan as r_slot_plan
from repro.models import paper_models as rpm
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch import comm_table
from repro_torch.common import flatten, unflatten
from repro_torch.convert import from_reference
from repro_torch.core import (Federation, FLConfig, Replay, aggregation,
                              build_round_step, comm, masking, topology)
from repro_torch.models import paper_models as pm
from repro_torch.models import toy

C, E, LR = 4, 2, 1e-2
TOL = 2e-5
W = np.asarray([1.0, 0.0, 1.5, 0.5], np.float32)     # a zero-weight client
tloss = functools.partial(toy.toy_loss, device="cpu")


def _np_flat(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


def _t(tree):
    return {p: torch.as_tensor(np.array(x)) for p, x in _np_flat(tree).items()}


def _nested(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


def _close(got, want, tol, what=""):
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), w, atol=tol,
                                   rtol=tol, err_msg=f"{what} {path}")


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
                   for k, v in batches.items()},
            "mem": rcomm.edge_membership(C, E)}


# -- byte math and the mixing matrix (exact) ---------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_ring_mixing_matrix_exact(n):
    got = topology.ring_mixing_matrix(n)
    np.testing.assert_array_equal(got, rtopo.ring_mixing_matrix(n))
    assert got.dtype == np.float32


@pytest.mark.parametrize("c,e,downlink", [(6, 2, "full"), (7, 3, "selected"),
                                          (10, 2, "full"), (4, 4, "full")])
def test_hierarchical_round_bytes_exact(c, e, downlink):
    rng = np.random.default_rng(c * 10 + e)
    sel = rng.integers(0, 2, (c, 14)).astype(np.float32)
    ub = (rng.integers(1, 10_000, 14) * 4).astype(np.float64)
    mem = comm.edge_membership(c, e)
    assert comm.hierarchical_round_bytes(sel, ub, mem, True, downlink) == \
        rcomm.hierarchical_round_bytes(sel, ub, mem, True, downlink)
    with pytest.raises(ValueError, match="downlink"):
        comm.hierarchical_round_bytes(sel, ub, mem, downlink="some")


def test_hierarchical_bytes_closed_form():
    """The reference's hand-built case (tests/test_topology.py)."""
    ub = np.array([10.0, 20.0, 40.0])
    mem = comm.edge_membership(4, 2)                 # edges {0,1} {2,3}
    sel = np.array([[1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    d = comm.hierarchical_round_bytes(sel, ub, mem)
    assert d["client_edge_uplink"] == 10 + 20 + 20 + 40
    assert d["edge_hub_uplink"] == d["uplink"] == (10 + 20) + (20 + 40)
    assert d["uplink_frac"] == pytest.approx(90 / (70 * 2))
    assert d["downlink"] == 70 * (2 + 4)
    sel2 = np.array([[1, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0]], np.float32)
    d2 = comm.hierarchical_round_bytes(sel2, ub, mem)
    assert d2["client_edge_uplink"] == 20 and d2["edge_hub_uplink"] == 10
    assert d == rcomm.hierarchical_round_bytes(sel, ub, mem)


@pytest.mark.parametrize("c,degree", [(1, None), (2, None), (6, None),
                                      (6, 1), (10, 3)])
def test_gossip_round_bytes_exact(c, degree):
    sel = np.random.default_rng(c).integers(0, 2, (c, 5)).astype(np.float32)
    ub = np.asarray([4.0, 8.0, 400.0, 12.0, 44.0])
    assert comm.gossip_round_bytes(sel, ub, degree) == \
        rcomm.gossip_round_bytes(sel, ub, degree)


@pytest.mark.parametrize("c,e", [(10, None), (8, None), (3, None), (5, 2),
                                 (4, 9), (4, 0)])
def test_resolve_n_edges_matches_reference(c, e):
    ref, got = RFLConfig(n_clients=c, n_edges=e), FLConfig(n_clients=c,
                                                           n_edges=e)
    if e is not None and not 1 <= e <= c:
        with pytest.raises(ValueError) as want:
            ref.resolve_n_edges()
        with pytest.raises(ValueError) as have:
            got.resolve_n_edges()
        assert str(have.value) == str(want.value)
    else:
        assert got.resolve_n_edges() == ref.resolve_n_edges()


@pytest.mark.parametrize("name,wire", [("hierarchical", False),
                                       ("hierarchical", True),
                                       ("gossip", False)])
def test_topology_summary_equals_reference(toy_setup, name, wire):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    hist = np.random.default_rng(3).integers(0, 2, (5, C, ta.n_units)) \
        .astype(np.float32)
    kw = {}
    if wire:
        kw["wire_ubytes"] = comm.unit_bytes(ta, tp) // 4 + 7
    fl, rfl = FLConfig(n_clients=C, n_edges=E), RFLConfig(n_clients=C,
                                                          n_edges=E)
    got = topology.get_topology(name).summary(ta, tp, hist, fl, **kw)
    want = rtopo.get_topology(name).summary(ra, rp, hist, rfl, **kw)
    assert got == want


# -- the two-stage aggregation (2e-5) ----------------------------------------

@pytest.fixture(scope="module")
def agg_case(toy_setup):
    """A selection, packed slot plan and random packed/dense deltas."""
    rp, ra, tp, ta = (toy_setup[k] for k in ("rp", "r_assign", "tp",
                                              "assign"))
    rng = np.random.default_rng(0)
    n_slots = 3
    sel = np.zeros((C, ta.n_units), np.float32)
    for c in range(C):
        sel[c, rng.choice(ta.n_units, n_slots, replace=False)] = 1.0
    r_rows, r_valid = jax.vmap(lambda s: r_slot_plan(ra, s, n_slots, rp))(
        jnp.asarray(sel))
    rows, valid = _t(r_rows), _t(r_valid)
    packed, dense = {}, {}
    for path, x in tp.items():
        if ta.leaf_units[path].kind == "scalar":
            d = rng.standard_normal((C,) + tuple(x.shape)).astype(np.float32)
            d *= sel[:, ta.leaf_units[path].base].reshape(
                (C,) + (1,) * x.ndim)
            packed[path] = dense[path] = d
            continue
        v = valid[path].numpy()
        d = rng.standard_normal((C, n_slots) + tuple(x.shape[1:])) \
            .astype(np.float32) * v.reshape(v.shape + (1,) * (x.ndim - 1))
        full = np.zeros((C,) + tuple(x.shape), np.float32)
        for c in range(C):
            full[c, rows[path][c].numpy()] += d[c]
        packed[path], dense[path] = d, full
    return {"sel": sel, "r_rows": r_rows, "r_valid": r_valid, "rows": rows,
            "valid": valid, "packed": packed, "dense": dense}


def test_hierarchical_edge_partials_equal_reference(toy_setup, agg_case):
    ta, ra, mem = toy_setup["assign"], toy_setup["r_assign"], toy_setup["mem"]
    r_means, r_den = ragg.hierarchical_edge_partials(
        _nested(agg_case["dense"]), jnp.asarray(agg_case["sel"]),
        jnp.asarray(W), ra, jnp.asarray(mem))
    means, e_den = aggregation.hierarchical_edge_partials(
        {p: torch.as_tensor(d) for p, d in agg_case["dense"].items()},
        torch.as_tensor(agg_case["sel"]), torch.as_tensor(W), ta,
        torch.as_tensor(mem))
    np.testing.assert_array_equal(e_den.numpy(), np.asarray(r_den))
    _close(means, _np_flat(r_means), TOL)


def test_hierarchical_masked_fedavg_equal_reference(toy_setup, agg_case):
    tp, ta, mem = toy_setup["tp"], toy_setup["assign"], toy_setup["mem"]
    want = ragg.hierarchical_masked_fedavg(
        toy_setup["rp"], _nested(agg_case["dense"]),
        jnp.asarray(agg_case["sel"]), jnp.asarray(W), toy_setup["r_assign"],
        jnp.asarray(mem))
    sel, w, m = (torch.as_tensor(x) for x in (agg_case["sel"], W, mem))
    dense = {p: torch.as_tensor(d) for p, d in agg_case["dense"].items()}
    got = aggregation.hierarchical_masked_fedavg(tp, dense, sel, w, ta, m)
    _close(got, _np_flat(want), TOL)
    # the fused hub combine (K1's plain version on CPU tensors) and the
    # flat hub average agree with it
    fused = topology._fused_hier_aggregate(ta, m)(tp, dense, sel, w)
    flat = aggregation.masked_fedavg(tp, dense, sel, w, ta)
    for path in got:
        torch.testing.assert_close(fused[path], got[path], atol=TOL,
                                   rtol=TOL)
        torch.testing.assert_close(flat[path], got[path], atol=TOL, rtol=TOL)


def test_hierarchical_packed_equal_reference(toy_setup, agg_case):
    tp, ta, mem = toy_setup["tp"], toy_setup["assign"], toy_setup["mem"]
    want = ragg.hierarchical_masked_fedavg_packed(
        toy_setup["rp"], _nested(agg_case["packed"]), agg_case["r_rows"],
        agg_case["r_valid"], jnp.asarray(agg_case["sel"]), jnp.asarray(W),
        toy_setup["r_assign"], jnp.asarray(mem))
    sel, w, m = (torch.as_tensor(x) for x in (agg_case["sel"], W, mem))
    packed = {p: torch.as_tensor(d) for p, d in agg_case["packed"].items()}
    got = aggregation.hierarchical_masked_fedavg_packed(
        tp, packed, agg_case["rows"], agg_case["valid"], sel, w, ta, m)
    _close(got, _np_flat(want), TOL)
    dense = aggregation.hierarchical_masked_fedavg(
        tp, {p: torch.as_tensor(d) for p, d in agg_case["dense"].items()},
        sel, w, ta, m)
    for path in got:
        torch.testing.assert_close(got[path], dense[path], atol=TOL,
                                   rtol=TOL)
    # clients streamed into the per-edge carry in two chunks, in order,
    # give the single-shot accumulate bitwise
    edge_of = m.argmax(0)
    acc = aggregation.packed_acc_init(ta, tp, n_edges=E)
    for part in (slice(0, 1), slice(1, C)):
        aggregation.packed_accumulate(
            ta, acc, {p: d[part] for p, d in packed.items()},
            {p: r[part] for p, r in agg_case["rows"].items()},
            {p: v[part] for p, v in agg_case["valid"].items()}, w[part],
            edge_idx=edge_of[part])
    chunked = aggregation.packed_finalize(ta, tp, acc, sel, w, membership=m)
    assert all(torch.equal(chunked[p], got[p]) for p in got)


# -- one round of each topology against the reference ------------------------

MODES = ("plain", "fused", "packed", "packed-qint8", "gossip")


def _fl_kw(mode):
    kw = dict(n_clients=C, train_fraction=0.4, lr=LR)
    if mode == "gossip":
        return dict(kw, topology="gossip")
    kw.update(topology="hierarchical", n_edges=E)
    if mode.startswith("packed"):
        kw["packed"] = True
    if mode == "packed-qint8":
        kw["codec"] = "qint8"
    return kw


@pytest.fixture(scope="module")
def ref_rounds(toy_setup):
    out = {}
    key = jax.random.PRNGKey(7)
    for mode in MODES:
        rfl = RFLConfig(fused_agg="off", **_fl_kw(mode))
        topo = rtopo.get_topology(rfl.topology)
        step = jax.jit(topo.build_round_step(r_toy_loss,
                                             toy_setup["r_assign"], rfl))
        state = topo.init_state(toy_setup["rp"], rfl)
        new, m = step(state, toy_setup["batches"], jnp.asarray(W), key)
        out[mode] = (_np_flat(new), _np_flat(topo.global_params(new, rfl)),
                     np.asarray(m["sel"]), float(m["loss_mean"]))
    return out, key


@pytest.mark.parametrize("mode", MODES)
def test_round_equals_reference(toy_setup, ref_rounds, mode, monkeypatch):
    rounds, key = ref_rounds
    want, want_global, sel, loss = rounds[mode]
    fl = FLConfig(fused_agg="on" if mode == "fused" else "off",
                  **_fl_kw(mode))
    topo = topology.get_topology(fl.topology)
    seen = []
    kw = {}
    if mode == "packed-qint8":
        ck = jax.random.fold_in(key, CODEC_KEY_TAG)

        def uniform(i, shape):
            return torch.as_tensor(np.asarray(jax.random.uniform(
                jax.random.fold_in(ck, i), shape, jnp.float32)))

        build = topology._codecs.build_codec_transform

        def recording(codec, assign, fl_):
            fn = build(codec, assign, fl_)

            def transform(pdeltas, rows, valid, weights, *a, **k):
                out = fn(pdeltas, rows, valid, weights, *a, **k)
                seen.append((pdeltas, rows, valid, weights, out[0]))
                return out
            return transform

        monkeypatch.setattr(topology._codecs, "build_codec_transform",
                            recording)
        kw["uniform"] = uniform
    step = build_round_step(tloss, toy_setup["assign"], fl,
                            strategy=Replay([sel]), device="cpu")
    state = topo.init_state(dict(toy_setup["tp"]), fl)
    new, m = step(state, toy_setup["tb"], torch.as_tensor(W), None, **kw)
    np.testing.assert_array_equal(m["sel"].numpy(), sel)
    assert abs(float(m["loss_mean"]) - loss) < 1e-6
    _close(new, want, TOL, mode)
    _close(topo.global_params(new, fl), want_global, TOL, mode)
    if mode == "packed-qint8":
        # the round's quantized codes are the reference's: its codec on
        # the round's own packed deltas decodes to the same bits
        (pd, rows, valid, weights, decoded), = seen
        rfl = RFLConfig(fused_agg="off", **_fl_kw(mode))
        r_dec, _ = rcodecs.build_codec_transform(
            rcodecs.get_codec("qint8"), toy_setup["r_assign"], rfl)(
            _nested({p: x.numpy() for p, x in pd.items()}),
            _nested({p: x.numpy() for p, x in rows.items()}),
            _nested({p: x.numpy() for p, x in valid.items()}),
            jnp.asarray(weights.numpy()), ck, None,
            jnp.ones((C,), jnp.float32))
        for path, x in _np_flat(r_dec).items():
            np.testing.assert_array_equal(decoded[path].numpy(), x,
                                          err_msg=path)


def test_gossip_mixing_preserves_the_replica_mean(toy_setup, ref_rounds):
    """The new replicas are the ring mix of the trained ones (the
    zero-weight client's update not applied), and their fp32 mean is
    the trained replicas' mean within 1e-6 relative."""
    _, _, sel, _ = ref_rounds[0]["gossip"]
    fl = FLConfig(**_fl_kw("gossip"))
    topo = topology.get_topology("gossip")
    state = topo.init_state(dict(toy_setup["tp"]), fl)
    step = build_round_step(tloss, toy_setup["assign"], fl,
                            strategy=Replay([sel]), device="cpu")
    new, m = step(state, toy_setup["tb"], torch.as_tensor(W), None)
    mix = torch.as_tensor(topology.ring_mixing_matrix(C))
    keep = torch.as_tensor(W > 0)
    for path, x in state.items():
        trained = torch.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)),
                              x + m["deltas"][path], x)
        torch.testing.assert_close(
            new[path], torch.tensordot(mix, trained, dims=([1], [0])),
            atol=1e-6, rtol=1e-6)
        mean = trained.double().mean(0)
        scale = max(float(mean.abs().max()), 1.0)
        assert float((new[path].double().mean(0) - mean).abs().max()) \
            <= 1e-6 * scale, path


def _nan_for(client_x):
    """A loss that is NaN on the batch whose inputs are ``client_x`` (one
    client's) and the toy loss elsewhere, for either package."""
    def make(base, xp):
        def loss(params, batch, **kw):
            val, aux = base(params, batch, **kw)
            hit = xp.all(batch["x"] == xp.asarray(client_x))
            # times NaN, so the gradients are NaN too (a where() would
            # leave them zero)
            return val * xp.where(hit, xp.asarray(float("nan")),
                                  xp.asarray(1.0)), aux
        return loss
    return make


@pytest.mark.parametrize("delta", ["finite", "nan"])
def test_gossip_zero_weight_update_is_withheld(toy_setup, delta):
    """Gossip with a client of weight 0 (client 1).  Finite deltas: the
    port's replicas equal the reference's within TOL.  A NaN delta on
    the zero-weight client (its loss is NaN): the port keeps that
    replica as it was, so every replica stays finite after the mix; the
    reference adds ``delta * 0`` = NaN to it and the ring mix spreads
    it.  The parity limit is pinned here; the reference is unchanged."""
    rfl = RFLConfig(fused_agg="off", **_fl_kw("gossip"))
    fl = FLConfig(**_fl_kw("gossip"))
    key = jax.random.PRNGKey(11)
    r_loss, t_loss = r_toy_loss, tloss
    if delta == "nan":
        make = _nan_for(np.asarray(toy_setup["batches"]["x"])[1, 0])
        r_loss = make(r_toy_loss, jnp)
        t_loss = make(tloss, torch)
    rtopo_g = rtopo.get_topology("gossip")
    rstep = rtopo_g.build_round_step(r_loss, toy_setup["r_assign"], rfl)
    rnew, rm = rstep(rtopo_g.init_state(toy_setup["rp"], rfl),
                     toy_setup["batches"], jnp.asarray(W), key)
    want = _np_flat(rnew)
    topo = topology.get_topology("gossip")
    step = build_round_step(t_loss, toy_setup["assign"], fl,
                            strategy=Replay([np.asarray(rm["sel"])]),
                            device="cpu")
    new, m = step(topo.init_state(dict(toy_setup["tp"]), fl), toy_setup["tb"],
                  torch.as_tensor(W), None)
    assert W[1] == 0.0
    if delta == "finite":
        _close(new, want, TOL, "gossip")
        return
    # the zero-weight client trained to NaN in both packages
    assert np.isnan(float(m["loss_per_client"][1]))
    assert any(bool(torch.isnan(d[1]).any()) for d in m["deltas"].values())
    assert all(bool(torch.isfinite(x).all()) for x in new.values())
    assert any(not np.isfinite(w).all() for w in want.values())
    # the finite clients' replicas are the reference's finite round:
    # rerun the reference without the NaN loss for the comparison
    fnew, _ = rtopo_g.build_round_step(
        r_toy_loss, toy_setup["r_assign"], rfl)(
        rtopo_g.init_state(toy_setup["rp"], rfl), toy_setup["batches"],
        jnp.asarray(W), key)
    _close(new, _np_flat(fnew), TOL, "gossip nan")


def test_gossip_rejects_packed_rounds(toy_setup):
    fl = FLConfig(n_clients=C, topology="gossip", packed=True)
    with pytest.raises(ValueError, match="nothing to pack") as got:
        build_round_step(tloss, toy_setup["assign"], fl, device="cpu")
    with pytest.raises(ValueError) as want:
        rtopo.get_topology("gossip").build_round_step(
            r_toy_loss, toy_setup["r_assign"],
            RFLConfig(n_clients=C, topology="gossip", packed=True))
    assert str(got.value) == str(want.value)


def test_gossip_rejects_codecs():
    kw = dict(n_clients=C, topology="gossip", packed=True, codec="qint8")
    with pytest.raises(ValueError) as want:
        RFLConfig(**kw)
    with pytest.raises(ValueError) as got:
        FLConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["hierarchical", "gossip"])
def test_federation_fit_bills_the_topology(toy_setup, name):
    """Port only: two rounds through ``Federation``; the bill is the
    topology's formula on the recorded selections, ``params`` is the
    single-model view of the state."""
    fl = FLConfig(n_clients=C, train_fraction=0.4, lr=LR, topology=name,
                  n_edges=E)
    fed = Federation(loss_fn=tloss, params=toy_setup["tp"],
                     assign=toy_setup["assign"], fl=fl, seed=2, device="cpu")
    fed.server.run(2, lambda r: toy_setup["tb"])
    ub = fed.server.unit_bytes()
    for rec, sel in zip(fed.history, fed.server.sel_history):
        assert rec.uplink_bytes == fed.topology.round_bytes(sel, ub,
                                                            fl)["uplink"]
    state = fed.server.params
    if name == "gossip":
        assert all(state[p].shape == (C,) + tuple(x.shape)
                   for p, x in toy_setup["tp"].items())
        assert all(torch.equal(fed.params[p], state[p].mean(0))
                   for p in state)
    else:
        assert fed.params is state
    rfl = RFLConfig(n_clients=C, n_edges=E, topology=name)
    assert fed.comm_summary() == dict(
        rtopo.get_topology(name).summary(
            toy_setup["r_assign"], toy_setup["rp"],
            np.stack(fed.server.sel_history), rfl),
        total_wasted_bytes=0.0, avg_wasted_bytes=0.0)


# -- the port's Table 4 ------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_tables():
    rp = jax.eval_shape(lambda k: rpm.init_vgg16(k), jax.random.PRNGKey(0))
    rp = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), rp)
    ra = r_build_units(rp, rpm.vgg16_units(rp))
    counts, ub = comm_table.unit_tables()
    np.testing.assert_array_equal(ub, rcomm.unit_bytes(ra, rp))
    np.testing.assert_array_equal(counts, rcomm.unit_param_counts(ra, rp))
    return counts, ub


@pytest.mark.parametrize("n", [4, 7, 14])
def test_comm_table_rows_equal_reference_on_injected_selections(vgg_tables,
                                                                n):
    counts, ub = vgg_tables
    sels = [np.asarray(select_clients(jax.random.PRNGKey(1000 * n + r),
                                      comm_table.CLIENTS, len(ub), n))
            for r in range(4)]
    mem = rcomm.edge_membership(comm_table.CLIENTS, comm_table.N_EDGES)
    flat = [rcomm.hub_round_bytes(s, ub)["uplink"] for s in sels]
    hub = comm_table.hub_row(sels, counts, ub)
    assert hub["uplink"] == float(np.mean(flat))
    assert hub["trained_params"] == float(np.mean(
        [(s @ counts).sum() for s in sels]))
    hier = comm_table.hierarchical_row(sels, ub)
    rows = [rcomm.hierarchical_round_bytes(s, ub, mem) for s in sels]
    assert hier["edge_hub_uplink"] == float(np.mean(
        [r["edge_hub_uplink"] for r in rows]))
    assert hier["client_edge_uplink"] == float(np.mean(
        [r["client_edge_uplink"] for r in rows]))
    assert hier["flat_hub_uplink"] == hub["uplink"]
    assert hier["wan_vs_flat"] < 1.0          # 2 edges ship < 10 clients
    gossip = comm_table.gossip_row(sels, ub)
    assert gossip["peer_bytes"] == float(np.mean(
        [rcomm.gossip_round_bytes(s, ub)["peer_bytes"] for s in sels]))


def test_comm_table_draws_uniform_selections():
    sels = comm_table.draw_selections(7, 3, 14)
    assert len(sels) == 3
    for s in sels:
        assert s.shape == (comm_table.CLIENTS, 14)
        assert (s.sum(1) == 7).all()
    again = comm_table.draw_selections(7, 3, 14)
    assert all(np.array_equal(a, b) for a, b in zip(sels, again))
