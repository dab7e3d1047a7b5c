"""The port's IMDB CNN-LSTM and CASA LSTM, the conv1d converter,
``dirichlet_partition`` and ``paper_tasks`` against the reference.

IMDB runs with its vocabulary cut to 512 (every other width full), CASA
at full width.  Logits and gradients are held at atol = rtol = 2e-5
(the LSTM sums in PyTorch's order, the reference's in a scan of jnp
matmuls).  One hub round of each against the reference's, with the
reference's selection replayed; the reference side is computed once per
module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core.masking import build_units_flat as r_build_units
from repro.data import casa_like, imdb_like
from repro.data import partition as rpart
from repro.models import paper_models as rpm
from repro_torch import paper_tasks
from repro_torch.common import param_count
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import FLConfig, Replay, build_round_step
from repro_torch.core import build_units_flat
from repro_torch.data import partition as tpart
from repro_torch.models import paper_models as pm

TOL = 2e-5
VOCAB = 512
C, BATCH, LR = 3, 4, 3e-3

# task -> (reference init, reference apply, port apply, port loss,
#          unit order, conv spatial rank, init kwargs)
TASKS = {
    "imdb": (rpm.init_imdb, rpm.imdb_apply, pm.imdb_apply, pm.imdb_loss,
             pm.imdb_units, 1, {"vocab": VOCAB}),
    "casa": (rpm.init_casa, rpm.casa_apply, pm.casa_apply, pm.casa_loss,
             pm.casa_units, 2, {}),
}


def _batch(task, n, key):
    if task == "imdb":
        return imdb_like(n, key=key, vocab=VOCAB)
    (x, y), = casa_like(1, key=key, min_samples=n, max_samples=n + 1)
    return x[:n], y[:n]


@pytest.fixture(scope="module")
def models():
    out = {}
    for task, (rinit, *_, spatial, kw) in TASKS.items():
        rp = rinit(jax.random.PRNGKey(0), **kw)
        out[task] = (rp, from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                        conv_spatial=spatial))
    return out


@pytest.mark.parametrize("task", TASKS)
def test_logits_match(models, task):
    rp, tp = models[task]
    _, rapply, tapply, *_ = TASKS[task]
    x, _ = _batch(task, 8, 3)
    ref = np.asarray(rapply(rp, jnp.asarray(x)))
    got = tapply(tp, x, device="cpu").detach().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("task", TASKS)
def test_grads_match(models, task):
    rp, tp = models[task]
    _, rapply, tapply, tloss, _, spatial, _ = TASKS[task]
    x, y = _batch(task, 16, 4)

    def rloss(p):
        return rpm.xent_loss(rapply(p, jnp.asarray(x)), jnp.asarray(y))

    rloss_v, rgrads = jax.value_and_grad(rloss)(rp)
    ref = from_reference(jax.tree_util.tree_map(np.asarray, rgrads),
                         conv_spatial=spatial)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = tloss(leaves, {"x": x, "y": y}, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(loss.item() - float(rloss_v)) < TOL
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), ref[path].numpy(), atol=TOL,
                                   rtol=TOL, err_msg=path)


@pytest.mark.parametrize("task,count,n_units", [("imdb", 2_638_966, 4),
                                                ("casa", 68_962, 6)])
def test_full_width_param_count_and_units(task, count, n_units):
    rinit, *_, units, spatial, _ = TASKS[task]
    tinit = {"imdb": pm.init_imdb, "casa": pm.init_casa}[task]
    p = tinit(torch.Generator().manual_seed(0))
    assert param_count(p) == count
    shapes = jax.eval_shape(rinit, jax.random.PRNGKey(0))
    ref = from_reference(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), conv_spatial=spatial)
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert list(p) == list(ref)                       # JAX leaf order
    assert units(p) == getattr(rpm, f"{task}_units")(shapes)
    assert len(units(p)) == n_units


def test_conv1d_converter_layout_and_roundtrip(models):
    rp, tp = models["imdb"]
    kernel = np.asarray(rp["conv0"]["w"])                      # WIO
    assert kernel.shape == (5, 128, 64)
    assert tuple(tp["conv0/w"].shape) == (64, 128, 5)          # OIW
    np.testing.assert_array_equal(tp["conv0/w"].numpy(),
                                  kernel.transpose(2, 1, 0))
    # a client-stacked delta has a conv2d kernel's rank: the layout comes
    # from the stated spatial rank, the client axis stays in front
    stacked = np.random.default_rng(0).standard_normal(
        (C, 5, 128, 64)).astype(np.float32)
    got = from_reference({"conv0": {"w": stacked}}, conv_spatial=1)
    assert tuple(got["conv0/w"].shape) == (C, 64, 128, 5)
    for c in range(C):
        np.testing.assert_array_equal(got["conv0/w"][c].numpy(),
                                      stacked[c].transpose(2, 1, 0))
    back = to_reference(got, conv_spatial=1)["conv0"]["w"]
    np.testing.assert_array_equal(back, stacked)
    ref_back = to_reference(tp, conv_spatial=1)
    for path, leaf in from_reference(ref_back, conv_spatial=1).items():
        assert torch.equal(leaf, tp[path]), path
    with pytest.raises(ValueError, match="spatial rank 2"):
        from_reference({"conv0": {"w": kernel}})
    with pytest.raises(ValueError, match="conv_spatial"):
        from_reference({"conv0": {"w": kernel}}, conv_spatial=3)


@pytest.mark.parametrize("n_clients,alpha,key,min_per", [
    (4, 0.5, 0, 8), (10, 0.1, 3, 8), (6, 0.05, 1, 40)])
def test_dirichlet_partition_equal(n_clients, alpha, key, min_per):
    labels = np.random.default_rng(key).integers(0, 10, 300)
    ref = rpart.dirichlet_partition(labels, n_clients, alpha=alpha, key=key,
                                    min_per_client=min_per)
    got = tpart.dirichlet_partition(labels, n_clients, alpha=alpha, key=key,
                                    min_per_client=min_per)
    assert len(ref) == len(got) == n_clients
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    if min_per == 40:                     # the top-up branch was taken
        assert any(len(s) == min_per for s in got)


@pytest.fixture(scope="module")
def ref_rounds(models):
    """One reference hub round of each task (Adam, fused_agg off)."""
    out = {}
    for task, (rp, _) in models.items():
        _, rapply, *_ = TASKS[task]
        x, y = _batch(task, C * BATCH, 5)
        batches = {"x": x.reshape((C, 1, BATCH) + x.shape[1:]),
                   "y": y.reshape(C, 1, BATCH)}

        def rloss(p, b, rapply=rapply):
            return rpm.xent_loss(rapply(p, b["x"]), b["y"]), {}

        fl = RFLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                       fused_agg="off")
        step = jax.jit(r_build_round_step(
            rloss, r_build_units(rp, getattr(rpm, f"{task}_units")(rp)), fl))
        new, m = step(rp, jax.tree_util.tree_map(jnp.asarray, batches),
                      jnp.ones(C), jax.random.PRNGKey(7))
        out[task] = (jax.tree_util.tree_map(np.asarray, new),
                     np.asarray(m["sel"]), float(m["loss_mean"]), batches)
    return out


@pytest.mark.parametrize("fused_agg", ["off", "on"])
@pytest.mark.parametrize("task", TASKS)
def test_hub_round_matches_reference(models, ref_rounds, task, fused_agg):
    """One round, Adam at lr 3e-3, the reference's selection replayed.
    Every leaf within 2e-5 (measured up to 3.0e-6, on IMDB's conv0/w);
    with ``fused_agg="on"`` the round goes through K1's wrapper (its
    plain version on the CPU).  Frozen units' deltas are exact zeros."""
    _, tp = models[task]
    *_, tloss, units, spatial, _ = TASKS[task]
    want, sel, loss, batches = ref_rounds[task]
    assign = build_units_flat(tp, units(tp))
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR,
                  fused_agg=fused_agg)
    step = build_round_step(functools.partial(tloss, device="cpu"), assign,
                            fl, strategy=Replay([sel]), device="cpu")
    new, m = step(dict(tp), {k: torch.as_tensor(v)
                             for k, v in batches.items()}, torch.ones(C),
                  None)
    assert abs(float(m["loss_mean"]) - loss) < TOL
    np.testing.assert_array_equal(m["sel"].numpy(), sel)
    want = from_reference(want, conv_spatial=spatial)
    for path in want:
        np.testing.assert_allclose(new[path].numpy(), want[path].numpy(),
                                   atol=TOL, rtol=0, err_msg=path)
        frozen = sel[:, assign.leaf_units[path].base] == 0
        d = m["deltas"][path][torch.as_tensor(frozen)]
        assert torch.equal(d, torch.zeros_like(d)), path


@pytest.mark.parametrize("task", paper_tasks.TASKS)
def test_paper_task_federation_on_cpu(task):
    fed = paper_tasks.build(task, "cpu")
    assert fed.fl.n_clients == paper_tasks.N_CLIENTS
    assert fed.fl.lr == paper_tasks.LR
    assert fed.fl.n_train_units == paper_tasks.N_TRAIN[task]
    assert fed.assign.n_units == {"imdb": 4, "casa": 6}[task]
    assert param_count(fed.params) == {"imdb": 2_638_966,
                                       "casa": 68_962}[task]
    assert not fed.fl.resolve_fused_agg(fed.device)
    (rec,) = fed.fit(1)
    assert np.isfinite(rec.loss) and 0.0 <= rec.eval_metric <= 1.0
    sel = fed.server.sel_history[0]
    assert (sel.sum(1) == paper_tasks.N_TRAIN[task]).all()
    assert rec.uplink_bytes == float((sel @ fed.server.unit_bytes()).sum())


def test_paper_tasks_need_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_tasks.build("casa")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.casa_apply(pm.init_casa(torch.Generator().manual_seed(0)),
                      np.zeros((1, 100, 36), np.float32))
