"""The expert-parallel MoE dispatch (``models.moe.apply_moe_sharded``) on
meshes ``(data 2, model 2)`` and ``(data 1, model 4)`` of 4 gloo ranks
on the CPU (``torch_ranks.spawn``; no process group in this process).

The reference's three cases (``tests/test_moe_sharded.py``: 8 experts
top 2, 8 top 1, 4 top 4; d 32, expert width 16, x (4, 8, 32)) with
decisive routing (every token's router probabilities apart by 100x the
bar or more, checked on the reference's own logits): on every rank ``y``
within 1e-5 and ``aux`` within 1e-6 of the reference's ``apply_moe``, as
its test holds the sharded dispatch, and the gradients of ``(y * g).sum()
+ aux`` w.r.t. the router, the three expert leaves and x within 1e-5 of
the port's ``apply_moe``'s, relative to each one's largest entry (a
world-size multiple would be off by 100%).  Dropped copies summed over
the ranks equal ``apply_moe``'s.  A planted fault (ranks past model index
0 running the expert one further on) fails the ``y`` bar.  A 2-layer
granite-moe-1b-a400m cut with decisive routing: ``forward(moe_mesh=...)``
within 1e-5 of ``forward``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro_torch.models import get_model, moe

import torch_ranks

MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {m: torch_ranks.spawn("moe_ep_cases", 4,
                                 tmp_path_factory.mktemp(m), shape=shape,
                                 names=["data", "model"])
            for m, shape in MESHES.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's apply_moe on the case's inputs, its least gap
    between the k-th and (k+1)-th router probability, and the port's
    apply_moe with its gradients and dropped copies."""
    e, k = torch_ranks.MOE_CASES[name]
    p, x, g, mcfg = torch_ranks.moe_inputs(e, k, seed=10 * e + k)
    rp = {n: jnp.asarray(v.numpy()) for n, v in p.items()}
    rx = jnp.asarray(x.numpy())
    ry, raux = r_moe.apply_moe(rp, rx, mcfg)
    probs = np.asarray(jax.nn.softmax(rx.reshape(-1, rx.shape[-1]) @
                                      rp["router"], axis=-1))
    top = -np.sort(-probs, axis=-1)
    gap = np.inf if k == e else float((top[:, k - 1] - top[:, k]).min())
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"], x]
    for t in leaves:
        t.requires_grad_(True)
    moe.reset_dropped()
    y, aux = moe.apply_moe(p, x, mcfg)
    grads = torch.autograd.grad((y * g).sum() + aux, leaves)
    return (np.asarray(ry), float(raux), gap, [t.detach() for t in grads],
            moe.dropped_copies())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(torch_ranks.MOE_CASES))
def test_sharded_matches_reference(runs, mesh, name):
    ry, raux, gap, grads, dropped = _reference(name)
    assert gap >= 100 * Y_TOL, f"{name}: routing gap {gap}"
    got = [r[name] for r in runs[mesh]]
    for y, aux, _, _ in got:
        assert float(np.abs(y.numpy() - ry).max()) < Y_TOL
        assert abs(float(aux) - raux) < AUX_TOL
    assert sum(r[3] for r in got) == dropped


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(torch_ranks.MOE_CASES))
def test_sharded_grads_match_apply_moe(runs, mesh, name):
    _, _, _, want, _ = _reference(name)
    for _, _, grads, _ in (r[name] for r in runs[mesh]):
        for leaf, g, w in zip(("router", "w_gate", "w_up", "w_down", "x"),
                              grads, want):
            err = float((g - w).abs().max() / w.abs().max())
            assert err < GRAD_TOL, (leaf, err)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_planted_fault_fails_the_bar(runs, mesh):
    ry, _, _, _, _ = _reference("top2")
    errs = [float(np.abs(r["top2 fault"][0].numpy() - ry).max())
            for r in runs[mesh]]
    assert min(errs) > 100 * Y_TOL, errs


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_forward_with_moe_mesh(runs, mesh):
    cfg, params, tokens = torch_ranks.granite_cut()
    with torch.no_grad():
        logits, aux, _ = get_model(cfg).forward(params, tokens)
    for got, got_aux in (r["granite forward"] for r in runs[mesh]):
        assert float((got - logits).abs().max()) < Y_TOL
        assert abs(float(got_aux - aux)) < AUX_TOL
