"""Masked Adam/SGD against repro.optim.masked on fixed gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import masked as rmasked
from repro_torch.optim import masked as tmasked

SHAPES = {"a/w": (4, 3, 3, 3), "a/b": (4,), "stack/w": (3, 5)}
# scalar masks for whole leaves, a per-row mask for the stacked leaf
MASKS = {"a/w": np.float32(1.0), "a/b": np.float32(0.0),
         "stack/w": np.asarray([1.0, 0.0, 1.0], np.float32)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _frozen(path, shape):
    m = MASKS[path]
    return np.broadcast_to(np.reshape(m, np.shape(m) + (1,) * (
        len(shape) - np.ndim(m))), shape) == 0


def _run(opt, masked, **kw):
    params, grads = _trees(0)
    mask = MASKS if masked else None
    r_init, r_step = ((rmasked.adam_init, rmasked.adam_step)
                      if opt == "adam" else
                      (rmasked.sgd_init, rmasked.sgd_step))
    t_init, t_step = ((tmasked.adam_init, tmasked.adam_step)
                      if opt == "adam" else
                      (tmasked.sgd_init, tmasked.sgd_step))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    rs, ts = r_init(rp), t_init(tp)
    for g in grads:
        rp, rs = r_step({k: jnp.asarray(v) for k, v in g.items()}, rs, rp,
                        lr=1e-2, mask=None if mask is None else
                        {k: jnp.asarray(v) for k, v in mask.items()}, **kw)
        tp, ts = t_step({k: torch.as_tensor(v) for k, v in g.items()}, ts,
                        tp, lr=1e-2, mask=None if mask is None else
                        {k: torch.as_tensor(v) for k, v in mask.items()},
                        **kw)
    return params, rp, rs, tp, ts


@pytest.mark.parametrize("masked", [False, True])
def test_adam_matches_reference(masked):
    _, rp, rs, tp, ts = _run("adam", masked)
    assert ts.count == int(rs.count) == 3
    for k in SHAPES:
        # float32 elementwise math; sqrt/pow may round in the last ulp
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(rs.mu[k]),
                                   atol=1e-7, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(rs.nu[k]),
                                   atol=1e-7, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("masked", [False, True])
def test_sgd_matches_reference(masked, momentum):
    _, rp, rs, tp, ts = _run("sgd", masked, momentum=momentum)
    assert ts.count == int(rs.count) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(ts.momentum[k].numpy(),
                                   np.asarray(rs.momentum[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_frozen_entries_bit_unchanged(opt):
    params, _, _, tp, ts = _run(opt, masked=True)
    moments = [ts.mu, ts.nu] if opt == "adam" else [ts.momentum]
    for k, shape in SHAPES.items():
        frozen = torch.as_tensor(_frozen(k, shape).copy())
        assert torch.equal(tp[k][frozen], torch.as_tensor(params[k])[frozen])
        for m in moments:
            assert torch.equal(m[k][frozen], torch.zeros_like(m[k][frozen]))
        # and the trained entries did move
        if (~frozen).any():
            assert not torch.equal(tp[k][~frozen],
                                   torch.as_tensor(params[k])[~frozen])
