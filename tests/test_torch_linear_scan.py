"""The port's linear-recurrence substrate (``repro_torch.models.
linear_scan``) against ``repro.models.linear_scan`` on the same numpy
inputs: the chunked form in both decay modes, with and without the RWKV
bonus and an initial state, at lengths where the chunk falls below 16;
the one-token step; the per-token oracle.

Tolerance: 1e-5, absolute on values of order 1 and scaled by the largest
reference value above that: ``atol = 1e-5 * max(1, max|want|)``.  The
outputs reach ~50 at 64 tokens of N(0, 1) inputs, where float32's
spacing is 3.8e-6 and the reference's own chunked form lies 1.9e-5 from
its exact per-token oracle, so a flat 1e-5 would sit below what either
package resolves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as R
from repro_torch.kernels.rwkv6_scan import ref as kref
from repro_torch.models import linear_scan as P

TOL = 1e-5
B, H, DK, DV = 2, 3, 16, 24


def _inputs(s, seed=0, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, DK)).astype(np.float32)
    k = rng.standard_normal((B, s, H, DK)).astype(np.float32)
    v = rng.standard_normal((B, s, H, DV)).astype(np.float32)
    ld = {m: (-np.abs(rng.standard_normal((B, s, H, w))) * decay_scale
              ).astype(np.float32) for m, w in (("k", DK), ("v", DV))}
    bonus = (0.3 * rng.standard_normal((H, DK))).astype(np.float32)
    state0 = (0.5 * rng.standard_normal((B, H, DK, DV))).astype(np.float32)
    return q, k, v, ld, bonus, state0


def _close(got, want, what):
    want = np.asarray(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0,
                               err_msg=what)


def _t(*xs):
    return tuple(None if x is None else torch.as_tensor(x) for x in xs)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 8), (21, 16), (17, 16),
                                     (5, 16)])
@pytest.mark.parametrize("decay_on", ["k", "v"])
@pytest.mark.parametrize("with_bonus,with_state", [(False, False),
                                                   (True, False),
                                                   (True, True),
                                                   (False, True)])
def test_chunked_matches_reference(s, chunk, decay_on, with_bonus,
                                   with_state):
    q, k, v, ld, bonus, state0 = _inputs(s)
    bonus = bonus if with_bonus else None
    state0 = state0 if with_state else None
    kw = dict(decay_on=decay_on, chunk=chunk)
    o_r, st_r = R.chunked_linear_scan(
        *(jnp.asarray(x) for x in (q, k, v, ld[decay_on])),
        bonus=None if bonus is None else jnp.asarray(bonus),
        state0=None if state0 is None else jnp.asarray(state0), **kw)
    tq, tk, tv, tld, tb, ts = _t(q, k, v, ld[decay_on], bonus, state0)
    o_p, st_p = P.chunked_linear_scan(tq, tk, tv, tld, bonus=tb, state0=ts,
                                      **kw)
    _close(o_p, o_r, "outputs")
    _close(st_p, st_r, "final state")
    assert o_p.dtype == torch.float32 and st_p.dtype == torch.float32


@pytest.mark.parametrize("decay_on", ["k", "v"])
@pytest.mark.parametrize("with_bonus", [False, True])
def test_decode_step_matches_reference(decay_on, with_bonus):
    q, k, v, ld, bonus, state0 = _inputs(1, seed=3)
    bonus = bonus if with_bonus else None
    args = (q[:, 0], k[:, 0], v[:, 0], ld[decay_on][:, 0])
    o_r, st_r = R.linear_scan_decode(
        *(jnp.asarray(x) for x in args), jnp.asarray(state0),
        decay_on=decay_on,
        bonus=None if bonus is None else jnp.asarray(bonus))
    o_p, st_p = P.linear_scan_decode(*_t(*args), torch.as_tensor(state0),
                                     decay_on=decay_on,
                                     bonus=_t(bonus)[0])
    _close(o_p, o_r, "output")
    _close(st_p, st_r, "state")


@pytest.mark.parametrize("decay_on", ["k", "v"])
def test_per_token_oracle_matches_reference(decay_on):
    q, k, v, ld, bonus, state0 = _inputs(13, seed=4)
    bonus = bonus if decay_on == "k" else None
    o_r, st_r = R.reference_linear_scan(
        *(jnp.asarray(x) for x in (q, k, v, ld[decay_on])),
        decay_on=decay_on,
        bonus=None if bonus is None else jnp.asarray(bonus),
        state0=jnp.asarray(state0))
    o_p, st_p = P.reference_linear_scan(*_t(q, k, v, ld[decay_on]),
                                        decay_on=decay_on,
                                        bonus=_t(bonus)[0],
                                        state0=torch.as_tensor(state0))
    _close(o_p, o_r, "outputs")
    _close(st_p, st_r, "final state")
    # and the chunked form against its own oracle inside the port
    o_c, st_c = P.chunked_linear_scan(*_t(q, k, v, ld[decay_on]),
                                      decay_on=decay_on, bonus=_t(bonus)[0],
                                      state0=torch.as_tensor(state0))
    torch.testing.assert_close(o_c, o_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(st_c, st_p, atol=1e-4, rtol=0)


def test_chunk_rule_and_floor():
    """The largest divisor of S that is <= chunk (the reference's rule,
    ``linear_scan.py`` chunked_linear_scan); both floors are the
    reference's."""
    for s in range(1, 70):
        c = P.chunk_len(s, 16)
        assert s % c == 0 and c <= 16
        assert all(s % d for d in range(c + 1, min(s, 16) + 1))
    assert (P.chunk_len(145, 16), P.chunk_len(127, 16)) == (5, 1)
    assert P.LOG_DECAY_FLOOR == kref.LOG_DECAY_FLOOR == R.LOG_DECAY_FLOOR


def test_strong_decay_and_gradient():
    """Decays far below the floor stay finite, and the chunked form is
    differentiable (the training forward's path)."""
    q, k, v, ld, bonus, _ = _inputs(32, seed=5, decay_scale=50.0)
    tq, tk, tv, tld, tb = _t(q, k, v, ld["k"], bonus)
    tq.requires_grad_()
    o, st = P.chunked_linear_scan(tq, tk, tv, tld, decay_on="k", bonus=tb)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st).all())
    (g,) = torch.autograd.grad(o.sum() + st.sum(), tq)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
