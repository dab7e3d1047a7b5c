"""The port's packed round path (DESIGN.md §7) against the reference's
packed round, and against the port's own dense round.

JAX's threefry keys have no torch twin, so the port trains exactly the
units the reference's round drew: the reference's ``sel`` is replayed
through a ``Replay`` strategy, and under a stochastic codec the
reference's rounding uniforms are injected through ``uniform=``.  One
local step, for the reasons in ROADMAP.md queue 3.  Tolerances: every
leaf within 1e-5 under SGD (the parameter moves by lr·g, and fp32
gradients of the two frameworks agree to ~1e-6 relative) and within
2e-4 under Adam (its first step is lr·g/(|g|+eps), so an element whose
gradient is near rounding noise takes a sizeable share of a ±lr step).

The toy MLP (6 blocks, d 16, hidden 32) carries the stacked-leaf
branches: every VGG16 leaf is a scalar unit, so at full width on the
card the stacked branches are not exercised.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core.aggregation import masked_fedavg_packed as r_fedavg_packed
from repro.core.client import local_update_packed as r_local_update_packed
from repro.core.codecs import CODEC_KEY_TAG
from repro.core.masking import build_units_flat as r_build_units
from repro.core.masking import slot_plan as r_slot_plan
from repro.data import cifar_like
from repro.models import paper_models as rpm
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_apply as r_toy_apply
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten, unflatten
from repro_torch.convert import from_reference
from repro_torch.core import (Federation, FLConfig, Replay, build_round_step,
                              build_units_flat, codecs, masking)
from repro_torch.core import aggregation, client
from repro_torch.kernels.masked_agg import ops as agg_ops
from repro_torch.models import paper_models as pm
from repro_torch.models import toy

C, LR = 4, 1e-2
TOL = {"sgd": 1e-5, "adam": 2e-4}
tloss = functools.partial(toy.toy_loss, device="cpu")


def _np_flat(tree):
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


def _t(tree):
    return {p: torch.as_tensor(np.array(x)) for p, x in _np_flat(tree).items()}


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


def test_toy_model_equals_reference(toy_setup):
    rp, tp, ta = toy_setup["rp"], toy_setup["tp"], toy_setup["assign"]
    ra = toy_setup["r_assign"]
    assert ta.n_units == ra.n_units and ta.unit_names == ra.unit_names
    assert {p: tuple(lu) for p, lu in ta.leaf_units.items()} == \
        {p: tuple(lu) for p, lu in flatten(ra.leaf_units).items()}
    x = toy_setup["batches"]["x"][0, 0]
    np.testing.assert_allclose(
        toy.toy_apply(tp, torch.as_tensor(np.asarray(x)), device="cpu")
        .numpy(), np.asarray(r_toy_apply(rp, x)), atol=1e-5, rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    params = toy.init_toy_mlp(gen, n_blocks=6, d=16, hidden=32, out=4)
    assert {p: tuple(v.shape) for p, v in params.items()} == \
        {p: tuple(v.shape) for p, v in tp.items()}
    assert list(params) == list(tp)                  # JAX leaf order


def _sel(assign, n_train, seed, zero_client=None):
    rng = np.random.default_rng(seed)
    sel = np.zeros((C, assign.n_units), np.float32)
    for c in range(C):
        sel[c, rng.choice(assign.n_units, n_train, replace=False)] = 1.0
    if zero_client is not None:
        sel[zero_client] = 0.0
    return sel


def _assert_close(got, want, tol, what=""):
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, atol=tol, rtol=0,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_local_update_packed_equals_reference(toy_setup, opt):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    sel = _sel(ta, 3, 1)[0]
    r_rows, r_valid = r_slot_plan(ra, jnp.asarray(sel), 3, rp)
    b = jax.tree_util.tree_map(lambda v: v[0], toy_setup["batches"])
    want, wm = r_local_update_packed(r_toy_loss, rp, ra, r_rows, r_valid, b,
                                     lr=LR, optimizer=opt)
    rows, valid = masking.slot_plan(ta, torch.as_tensor(sel), 3, tp)
    got, m = client.local_update_packed(
        tloss, tp, ta, rows, valid,
        {k: v[0] for k, v in toy_setup["tb"].items()}, lr=LR, optimizer=opt)
    assert abs(float(m["loss_mean"]) - float(wm["loss_mean"])) < 1e-6
    _assert_close(got, _np_flat(want), TOL[opt])
    for path, v in valid.items():                    # pads / frozen: exact 0
        d = got[path]
        v = v.reshape(tuple(v.shape) + (1,) * (d.ndim - v.ndim))
        assert torch.equal(d * (v == 0), torch.zeros_like(d)), path


def test_masked_fedavg_packed_equals_reference(toy_setup):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    sel = _sel(ta, 3, 2, zero_client=2)
    r_rows, r_valid = jax.vmap(lambda s: r_slot_plan(ra, s, 3, rp))(
        jnp.asarray(sel))
    rng = np.random.default_rng(0)
    rows, valid = _t(r_rows), _t(r_valid)
    deltas = {}
    for path, x in tp.items():
        shape = (C,) + (tuple(x.shape) if ta.leaf_units[path].kind ==
                        "scalar" else (3,) + tuple(x.shape[1:]))
        v = valid[path].reshape(tuple(valid[path].shape) +
                                (1,) * (len(shape) - valid[path].ndim))
        deltas[path] = rng.standard_normal(shape).astype(np.float32) * \
            v.numpy()
    w = np.asarray([1.0, 0.0, 2.0, 0.5], np.float32)   # a zero-weight client
    want = r_fedavg_packed(rp, jax.tree_util.tree_map(
        jnp.asarray, _nested(deltas)), r_rows, r_valid, jnp.asarray(sel),
        jnp.asarray(w), ra)
    got = aggregation.masked_fedavg_packed(
        tp, {p: torch.as_tensor(d) for p, d in deltas.items()}, rows, valid,
        torch.as_tensor(sel), torch.as_tensor(w), ta)
    _assert_close(got, _np_flat(want), 1e-6)
    # the dense aggregation of the same deltas, scattered to full width
    dense = {}
    for path, d in deltas.items():
        if ta.leaf_units[path].kind == "scalar":
            dense[path] = torch.as_tensor(d)
            continue
        full = torch.zeros((C,) + tuple(tp[path].shape))
        for c in range(C):
            full[c, rows[path][c]] = torch.as_tensor(d[c])
        dense[path] = full
    ref = aggregation.masked_fedavg(tp, dense, torch.as_tensor(sel),
                                    torch.as_tensor(w), ta)
    for path in ref:
        torch.testing.assert_close(got[path], ref[path], atol=2e-5,
                                   rtol=2e-5)


def _nested(flat):
    return unflatten(flat)


_CASES = [("uniform", "sgd", False), ("uniform", "adam", False),
          ("fixed_last", "sgd", False), ("synchronized", "adam", False),
          ("uniform", "sgd", True), ("synchronized", "sgd", True)]


@pytest.fixture(scope="module")
def ref_packed_rounds(toy_setup):
    """One reference packed round per case (weights with a zero-weight
    client; the last flag sets always_train_head)."""
    out = {}
    w = np.asarray([1.0, 0.0, 1.5, 0.5], np.float32)
    for strategy, opt, head in _CASES:
        fl = RFLConfig(n_clients=C, train_fraction=0.4, strategy=strategy,
                       lr=LR, optimizer=opt, packed=True,
                       always_train_head=head)
        step = jax.jit(r_build_round_step(r_toy_loss, toy_setup["r_assign"],
                                          fl))
        new, m = step(toy_setup["rp"], toy_setup["batches"], jnp.asarray(w),
                      jax.random.PRNGKey(7))
        out[(strategy, opt, head)] = (_np_flat(new), np.asarray(m["sel"]),
                                      float(m["loss_mean"]), w)
    return out


def _port_round(toy_setup, sel, w, opt, head, packed=True, **kw):
    fl = FLConfig(n_clients=C, train_fraction=0.4, lr=LR, optimizer=opt,
                  packed=packed, always_train_head=head, **kw)
    step = build_round_step(tloss, toy_setup["assign"], fl,
                            strategy=Replay([sel]), device="cpu")
    return step(dict(toy_setup["tp"]), toy_setup["tb"], torch.as_tensor(w),
                None)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(
    [c[0], c[1]] + (["head"] if c[2] else [])))
def test_packed_round_equals_reference(toy_setup, ref_packed_rounds, case):
    want, sel, loss, w = ref_packed_rounds[case]
    _, opt, head = case
    if case[0] == "synchronized":
        assert (sel == sel[:1]).all()
    if head:
        assert (sel[:, -1] == 1.0).all()
    new, m = _port_round(toy_setup, sel, w, opt, head)
    np.testing.assert_array_equal(m["sel"].numpy(), sel)
    assert abs(float(m["loss_mean"]) - loss) < 1e-6
    _assert_close(new, want, TOL[opt])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_packed_round_equals_port_dense_round(toy_setup, ref_packed_rounds,
                                              opt):
    _, sel, _, w = ref_packed_rounds[("uniform", opt, False)]
    packed, mp = _port_round(toy_setup, sel, w, opt, False)
    dense, md = _port_round(toy_setup, sel, w, opt, False, packed=False,
                            fused_agg="off")
    assert float(mp["loss_mean"]) == float(md["loss_mean"])
    for path in dense:
        torch.testing.assert_close(packed[path], dense[path], atol=2e-5,
                                   rtol=2e-5)


def test_packed_round_ignores_fused_agg(toy_setup, ref_packed_rounds,
                                        monkeypatch):
    _, sel, _, w = ref_packed_rounds[("uniform", "adam", False)]

    def refuse(*a, **k):
        raise AssertionError("the packed round called the K1 path")

    monkeypatch.setattr(agg_ops, "masked_combine_packed", refuse)
    monkeypatch.setattr(agg_ops, "masked_agg", refuse)
    on, _ = _port_round(toy_setup, sel, w, "adam", False, fused_agg="on")
    off, _ = _port_round(toy_setup, sel, w, "adam", False, fused_agg="off")
    assert all(torch.equal(on[p], off[p]) for p in on)


@pytest.mark.parametrize("name", ["qint8", "topk_ef"])
def test_codec_fit_bills_encoded_bytes_and_threads_state(toy_setup, name):
    """Port-only: three rounds of a codec federation bill exactly the
    encoded wire bytes of each round's slot plan, frozen decoded deltas
    are exactly zero, and a stateful codec's residual is threaded."""
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    fl = FLConfig(n_clients=C, train_fraction=0.4, lr=LR, packed=True,
                  codec=name, codec_topk=0.25)
    fed = Federation(loss_fn=tloss, params=tp, assign=ta, fl=fl, seed=3,
                     device="cpu")
    seen = []

    class Grab:
        def on_round_start(self, server, r, weights):
            return None

        def on_round_end(self, server, record, metrics):
            seen.append(metrics["deltas"])

        def on_fit_end(self, server, history):
            pass

    fed.server.add_hook(Grab())
    fed.server.run(3, lambda r: toy_setup["tb"])
    codec = codecs.get_codec(name)
    n_slots = fl.resolve_n_slots(ta.n_units)
    wub = fed.server.wire_unit_bytes()
    for rec, sel, dec in zip(fed.history, fed.server.sel_history, seen):
        plans = [masking.slot_plan(ta, torch.as_tensor(s), n_slots, tp)
                 for s in sel]
        valid = {p: torch.stack([pl[1][p] for pl in plans]) for p in tp}
        enc = codecs.encoded_wire_bytes(codec, ta, tp, valid, fl)
        assert rec.uplink_bytes == enc == float((sel @ wub).sum())
        for path, v in valid.items():
            d = dec[path]
            v = v.reshape(tuple(v.shape) + (1,) * (d.ndim - v.ndim))
            assert torch.equal(d * (v == 0), torch.zeros_like(d)), path
    state = fed.server.codec_state
    if name == "qint8":
        assert state is None and fed.server.codec_generator is not None
    else:
        assert set(state) == set(tp)
        assert all(state[p].shape == (C,) + tuple(tp[p].shape) for p in tp)
        assert any(bool(state[p].abs().sum() > 0) for p in tp)


def test_vgg16_packed_qint8_round_equals_reference():
    """VGG16 at width 0.125, 3 clients, one packed qint8 round under
    Adam, with the reference's selection and rounding uniforms.  Every
    leaf is a scalar unit.  A delta that differs from the reference's in
    its last bits can round to the neighbouring code, which moves the
    decoded element by one scale step (absmax/127 of its row), so each
    element is held to 2e-4 plus one step of its leaf's coarsest row;
    the conv biases, whose Adam step has a noisy sign (ROADMAP queue 3),
    to 2·lr per step."""
    c = 3
    rp = rpm.init_vgg16(jax.random.PRNGKey(0), width_mult=0.125)
    ra = r_build_units(rp, rpm.vgg16_units(rp))
    x, y = cifar_like(c * 4, key=3)
    batches = {"x": x.reshape(c, 1, 4, 32, 32, 3), "y": y.reshape(c, 1, 4)}
    fl_kw = dict(n_clients=c, n_train_units=7, lr=LR, packed=True,
                 codec="qint8")

    def rloss(p, b):
        return rpm.xent_loss(rpm.vgg16_apply(p, b["x"]), b["y"]), {}

    key = jax.random.PRNGKey(5)
    step = jax.jit(r_build_round_step(rloss, ra, RFLConfig(**fl_kw)))
    new, m = step(rp, jax.tree_util.tree_map(jnp.asarray, batches),
                  jnp.ones(c), key)
    want = from_reference(jax.tree_util.tree_map(np.asarray, new))
    sel = np.asarray(m["sel"])
    ck = jax.random.fold_in(key, CODEC_KEY_TAG)

    def uniform(i, shape):
        return torch.as_tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(ck, i), shape, jnp.float32)))

    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    assign = build_units_flat(tp, pm.vgg16_units(tp))
    tstep = build_round_step(functools.partial(pm.vgg16_loss, device="cpu"),
                             assign, FLConfig(**fl_kw),
                             strategy=Replay([sel]), device="cpu")
    got, tm = tstep(dict(tp), {k: torch.as_tensor(v)
                               for k, v in batches.items()},
                    torch.ones(c), None, uniform=uniform)
    assert abs(float(tm["loss_mean"]) - float(m["loss_mean"])) < 1e-5
    for path in want:
        dec = tm["deltas"][path].reshape(c, -1)
        step_ = float(dec.abs().amax()) / 127.0
        tol = 2 * LR if path.startswith("conv") and path.endswith("/b") \
            else 2e-4 + step_
        err = float((got[path] - want[path]).abs().max())
        assert err <= tol, (path, err, tol)
