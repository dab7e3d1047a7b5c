"""The port's hub round and Federation.fit against the reference on the
same params, batches and (replayed) selections.

JAX's threefry keys have no torch twin, so the port trains exactly the
units the reference's round drew: the reference's ``sel`` rows are fed
back through a ``Replay`` strategy.  VGG16 at width 0.125, 3 clients,
batch 4, one local step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import Federation as RFederation
from repro.core import ModelSpec as RModelSpec
from repro.core import build_round_step as r_build_round_step
from repro.core.masking import build_units_flat as r_build_units
from repro.data import FederatedLoader, cifar_like, iid_partition
from repro.models import paper_models as rpm
from repro_torch import paper_round
from repro_torch.convert import from_reference
from repro_torch.core import (FLConfig, Federation, ModelSpec, Replay,
                              Server, build_round_step, build_units_flat)
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.models import paper_models as pm

C, STEPS, LR, WIDTH = 3, 1, 1e-2, 0.125
tloss = functools.partial(pm.vgg16_loss, device="cpu")


def rloss(p, b):
    return rpm.xent_loss(rpm.vgg16_apply(p, b["x"]), b["y"]), {}


@pytest.fixture(scope="module")
def base():
    rp = rpm.init_vgg16(jax.random.PRNGKey(0), width_mult=WIDTH)
    np_params = jax.tree_util.tree_map(np.array, rp)
    x, y = cifar_like(C * STEPS * 4, key=3)
    batches = {"x": x.reshape(C, STEPS, 4, 32, 32, 3),
               "y": y.reshape(C, STEPS, 4)}
    tp = from_reference(np_params)
    return {"rp": rp, "np_params": np_params, "batches": batches, "tp": tp,
            "assign": build_units_flat(tp, pm.vgg16_units(tp)),
            "r_assign": r_build_units(rp, rpm.vgg16_units(rp))}


@pytest.fixture(scope="module")
def ref_rounds(base):
    """One reference round per optimizer (fused_agg off)."""
    out = {}
    for opt in ("adam", "sgd"):
        fl = RFLConfig(n_clients=C, n_train_units=7, lr=LR, optimizer=opt,
                       fused_agg="off")
        step = jax.jit(r_build_round_step(rloss, base["r_assign"], fl))
        new, m = step(base["rp"], jax.tree_util.tree_map(
            jnp.asarray, base["batches"]), jnp.ones(C),
            jax.random.PRNGKey(5))
        out[opt] = (from_reference(jax.tree_util.tree_map(np.asarray, new)),
                    np.asarray(m["sel"]), float(m["loss_mean"]))
    return out


def _port_round(base, sel, opt, fused_agg="off"):
    fl = FLConfig(n_clients=C, n_train_units=7, lr=LR, optimizer=opt,
                  fused_agg=fused_agg)
    step = build_round_step(tloss, base["assign"], fl,
                            strategy=Replay([sel]), device="cpu")
    return step(dict(base["tp"]), {k: torch.as_tensor(v) for k, v in
                                   base["batches"].items()},
                torch.ones(C), None)


def _is_conv_bias(path):
    return path.startswith("conv") and path.endswith("/b")


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_one_round_matches_reference(base, ref_rounds, opt):
    ref, sel, ref_loss = ref_rounds[opt]
    new, m = _port_round(base, sel, opt)
    assert abs(float(m["loss_mean"]) - ref_loss) < 1e-5
    np.testing.assert_array_equal(m["sel"].numpy(), sel)
    for path in ref:
        if opt == "adam" and _is_conv_bias(path):
            # the conv bias sits before batch-stat BN: its gradient is 0
            # up to rounding noise of either sign, and Adam's first step
            # is ~lr*sign(g) — so it may differ by up to 2*lr*steps
            tol = 2 * LR * STEPS
            assert float((new[path] - ref[path]).abs().max()) <= tol, path
            continue
        # Adam: fp32 grads agree to ~1e-5 relative; an element whose
        # gradient is near its rounding noise still takes a sizeable
        # share of a +-lr step (measured <= 8.4e-5).  SGD moves by lr*g:
        # the same relative agreement, times lr.
        tol = 2e-4 if opt == "adam" else 1e-5
        np.testing.assert_allclose(new[path].numpy(), ref[path].numpy(),
                                   atol=tol, rtol=0, err_msg=path)


def test_fused_wrapper_path_matches_plain_round(base, ref_rounds):
    _, sel, _ = ref_rounds["adam"]
    plain, _ = _port_round(base, sel, "adam", fused_agg="off")
    fused, m = _port_round(base, sel, "adam", fused_agg="on")
    for path in plain:
        torch.testing.assert_close(fused[path], plain[path], atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("fused_agg", ["off", "on"])
def test_frozen_unit_deltas_exactly_zero(base, ref_rounds, fused_agg):
    _, sel, _ = ref_rounds["adam"]
    _, m = _port_round(base, sel, "adam", fused_agg=fused_agg)
    assign = base["assign"]
    n_frozen = 0
    for path, lu in assign.leaf_units.items():
        d = m["deltas"][path]
        assert d.shape == (C,) + tuple(base["tp"][path].shape)
        for c in range(C):
            if sel[c, lu.base] == 0:
                assert int(torch.count_nonzero(d[c])) == 0, (path, c)
                n_frozen += 1
    assert n_frozen > 0


@pytest.fixture(scope="module")
def ref_fit(base):
    """A 3-round reference Federation.fit (hub, uniform, fused off)."""
    x, y = cifar_like(48, key=0)
    shards = iid_partition(48, C, key=1)
    data = [{"x": x[s], "y": y[s]} for s in shards]
    spec = RModelSpec("vgg16", functools.partial(rpm.init_vgg16,
                                                 width_mult=WIDTH),
                      rloss, rpm.vgg16_units)
    fed = RFederation.from_config(
        spec, RFLConfig(n_clients=C, n_train_units=7, lr=LR),
        data=FederatedLoader(data, batch_size=4, steps_per_round=STEPS))
    fed.fit(3)
    return data, fed


def test_fit_comm_summary_equal(base, ref_fit):
    data, rfed = ref_fit
    fed = Federation(loss_fn=tloss, params=base["tp"], assign=base["assign"],
                     fl=FLConfig(n_clients=C, n_train_units=7, lr=LR),
                     loader=TLoader(data, batch_size=4,
                                    steps_per_round=STEPS),
                     strategy=Replay(rfed.server.sel_history), device="cpu")
    hist = fed.fit(3)
    assert fed.comm_summary() == rfed.comm_summary()
    for r, rr in zip(hist, rfed.history):
        assert (r.uplink_bytes, r.trained_params, r.n_participants) == \
            (rr.uplink_bytes, rr.trained_params, rr.n_participants)
        # round 1 starts from the same params; rounds 2-3 start from
        # params that already differ by the Adam rounding-noise steps
        # above (up to 2*lr per element per round), so they track the
        # reference loosely
        tol = 1e-5 if r.round == 0 else 1e-2 * abs(rr.loss)
        assert abs(r.loss - rr.loss) < tol, r.round
    np.testing.assert_array_equal(np.stack(fed.server.sel_history),
                                  np.stack(rfed.server.sel_history))


def test_skipped_round_keeps_params(base):
    fl = FLConfig(n_clients=C, n_train_units=7, lr=LR)
    step = build_round_step(tloss, base["assign"], fl, device="cpu")
    server = Server(step, base["assign"], fl, base["tp"], device="cpu")
    before = {k: v.clone() for k, v in server.params.items()}
    rec = server.run_round({k: torch.as_tensor(v) for k, v in
                            base["batches"].items()}, torch.zeros(C))
    assert rec.skipped and rec.dropped and rec.n_participants == 0
    assert all(torch.equal(before[k], server.params[k]) for k in before)
    assert server.comm_summary()["avg_uplink_bytes"] == 0.0


def test_straggler_dropout_bills_only_uploads(base):
    fl = FLConfig(n_clients=C, n_train_units=7, lr=LR)
    fed = Federation(loss_fn=tloss, params=base["tp"], assign=base["assign"],
                     fl=fl, dropout_rate=0.5, seed=3, device="cpu")
    batches = {k: torch.as_tensor(v) for k, v in base["batches"].items()}
    for _ in range(3):
        rec = fed.run_round(batches)
        sel = fed.server.sel_history[-1]
        keep = np.asarray(rec.effective_weights) > 0
        ub = fed.server.unit_bytes()
        assert rec.uplink_bytes == float((sel[keep] @ ub).sum())


def _entry_points(base):
    fl = FLConfig(n_clients=C, n_train_units=7)
    spec = ModelSpec("vgg16", functools.partial(pm.init_vgg16,
                                                width_mult=WIDTH),
                     tloss, pm.vgg16_units)
    return {
        "Federation.from_config": lambda **kw: Federation.from_config(
            spec, fl, **kw),
        "build_round_step": lambda **kw: build_round_step(
            tloss, base["assign"], fl, **kw),
        "Server": lambda **kw: Server(lambda *a: None, base["assign"], fl,
                                      base["tp"], **kw),
        "vgg16_apply": lambda **kw: pm.vgg16_apply(
            base["tp"], base["batches"]["x"][0, 0], **kw),
        "paper_round.build": paper_round.build,
    }


@pytest.mark.parametrize("name", ["Federation.from_config",
                                  "build_round_step", "Server",
                                  "vgg16_apply", "paper_round.build"])
def test_entry_points_need_gpu_unless_cpu(base, name):
    fn = _entry_points(base)[name]
    fn(device="cpu")                                  # the explicit opt-in
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
