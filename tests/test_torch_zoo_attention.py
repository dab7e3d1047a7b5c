"""The port's chunked and windowed attention against the reference's.

``attend_chunked`` and ``attend_windowed`` (plain PyTorch, what CPU
tensors run) against ``repro.models.attention`` on the same numpy
inputs: B=2, H=4 query heads over Hkv=2, head dim 32, q/kv chunks of 64,
at S=256 and S=200 (``_fit_chunk`` cuts the chunk to 50), windows of 48
and 64 (S > window, where a slab that is one position off shows) and
``q_offset`` 0 and 16.  Outputs and the gradients of ``sum(o * g)``
with respect to q, k and v (``jax.vjp`` on the reference) are held to
1e-5: fp32 sums in another order, measured ~1e-7.  The reference side
is computed once for the module.

``attend``'s dispatch is held to the reference's branch at S = 128, 129,
512 and 600, and the card route's padding (``_attend_kernel``, whose
``flash_attention`` takes its plain version on CPU tensors) to the plain
chunked version at S = 200.  The non-causal route (``pad_noncausal``:
zero rows to whole blocks, the padded keys masked by ``kv_len``, the
output sliced back) is held, forward and gradients, to the reference's
``attend_reference(causal=False)`` at Sq = Sk = 150 and at Sq = 256 over
Sk = 150, with the plain ``kv_len`` version in the kernel's place.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch.models import attention as tattn

TOL = 1e-5
B, H, HKV, HD, CHUNK = 2, 4, 2, 32, 64
CHUNKED = list(itertools.product((256, 200), (0, 48), (0, 16)))
WINDOWED = list(itertools.product((256, 200), (48, 64), (0, 16)))


def _inputs(s, seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, s, H, HD)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, s, HKV, HD)).astype(np.float32)
            for _ in range(2))
    return q, k, v, g


def _ref_case(fn, q, k, v, g):
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(o),) + tuple(np.asarray(x)
                                    for x in vjp(jnp.asarray(g)))


@pytest.fixture(scope="module")
def ref():
    out = {}
    for s, window, off in CHUNKED:
        q, k, v, g = _inputs(s, s + window + off)
        out["chunked", s, window, off] = _ref_case(
            lambda q, k, v: rattn.attend_chunked(
                q, k, v, causal=True, window=window, q_chunk=CHUNK,
                kv_chunk=CHUNK, q_offset=off), q, k, v, g)
    for s, window, off in WINDOWED:
        q, k, v, g = _inputs(s, s + window + off)
        out["windowed", s, window, off] = _ref_case(
            lambda q, k, v: rattn.attend_windowed(
                q, k, v, window=window, q_chunk=CHUNK, q_offset=off),
            q, k, v, g)
    return out


def _port_case(fn, q, k, v, g):
    qs, ks, vs = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fn(qs, ks, vs)
    grads = torch.autograd.grad((o * torch.as_tensor(g)).sum(), (qs, ks, vs))
    return (o.detach().numpy(),) + tuple(x.numpy() for x in grads)


def _close(got, want, what):
    for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=0,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("s,window,off", CHUNKED)
def test_chunked_matches_reference(ref, s, window, off):
    q, k, v, g = _inputs(s, s + window + off)
    got = _port_case(lambda q, k, v: tattn.attend_chunked(
        q, k, v, causal=True, window=window, q_chunk=CHUNK, kv_chunk=CHUNK,
        q_offset=off), q, k, v, g)
    _close(got, ref["chunked", s, window, off], f"chunked S={s}")


@pytest.mark.parametrize("s,window,off", WINDOWED)
def test_windowed_matches_reference(ref, s, window, off):
    q, k, v, g = _inputs(s, s + window + off)
    got = _port_case(lambda q, k, v: tattn.attend_windowed(
        q, k, v, window=window, q_chunk=CHUNK, q_offset=off), q, k, v, g)
    _close(got, ref["windowed", s, window, off], f"windowed S={s}")


def test_fit_chunk_matches_reference():
    for s in (1, 50, 200, 256, 1500, 4096):
        for c in (1, 64, 1024):
            assert tattn._fit_chunk(s, c) == rattn._fit_chunk(s, c)


@pytest.mark.parametrize("s", [128, 129, 512, 600])
@pytest.mark.parametrize("impl,window", [("chunked", 0), ("chunked", 64),
                                         ("reference", 64)])
def test_attend_dispatch_matches_reference(monkeypatch, s, impl, window):
    """The branch each package's ``attend`` takes (q_chunk 1024: the
    reference path up to 512 positions)."""
    seen = {}
    for mod, tag in ((rattn, "r"), (tattn, "t")):
        for name in ("attend_reference", "attend_chunked",
                     "attend_windowed"):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _t=tag,
                                **kw: seen.setdefault(_t, _n))
    q = np.zeros((1, s, 2, 32), np.float32)
    rattn.attend(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), impl=impl,
                 window=window)
    tq = torch.as_tensor(q)
    tattn.attend(tq, tq, tq, impl=impl, window=window)
    assert seen["t"] == seen["r"]
    want = "attend_reference" if impl == "reference" or s <= 512 else \
        "attend_windowed" if window else "attend_chunked"
    assert seen["t"] == want


@pytest.mark.parametrize("window", [0, 48])
def test_kernel_route_padding_matches_plain(window):
    """The card route pads S=200 to 256 at the end, runs
    ``flash_attention`` (its plain version on CPU tensors) and slices
    back: forward and gradients equal the unpadded plain version."""
    q, k, v, g = _inputs(200, 7 + window)
    got = _port_case(lambda q, k, v: tattn._attend_kernel(
        q, k, v, causal=True, window=window, q_offset=0), q, k, v, g)
    want = _port_case(lambda q, k, v: tattn.attend_chunked(
        q, k, v, causal=True, window=window, q_chunk=CHUNK, kv_chunk=CHUNK),
        q, k, v, g)
    _close(got, want, f"padded window={window}")


def test_kernel_route_refuses_what_it_cannot_run():
    """A non-causal call at any lengths has a route (``pad_noncausal``);
    a causal one with Sq != Sk not a multiple of the block does not."""
    x, kx = torch.zeros(1, 200, 2, 32), torch.zeros(1, 100, 2, 32)
    with pytest.raises(ValueError, match="causal"):
        tattn._attend_kernel(x, kx, kx, causal=True, window=0, q_offset=0)
    y = torch.zeros(1, 256, 2, 32)
    with pytest.raises(ValueError, match="q_offset"):
        tattn._attend_kernel(y, y, y, causal=True, window=0, q_offset=16)
    with pytest.raises(ValueError, match="float64"):
        tattn._attend_kernel(y.double(), y.double(), y.double(), causal=True,
                             window=0, q_offset=0)


@pytest.mark.parametrize("sq,sk", [(150, 150), (256, 150)])
def test_noncausal_pad_route_matches_reference(sq, sk):
    """``pad_noncausal`` (``flash_attention``'s plain ``kv_len`` version
    on CPU tensors in the kernels' place) against the reference's dense
    non-causal attention: outputs and the gradients of ``sum(o * g)``."""
    rng = np.random.default_rng(sq + sk)
    q, g = (rng.normal(size=(B, sq, H, HD)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, sk, HKV, HD)).astype(np.float32)
            for _ in range(2))
    want = _ref_case(lambda q, k, v: rattn.attend_reference(
        q, k, v, causal=False), q, k, v, g)
    got = _port_case(tattn.pad_noncausal, q, k, v, g)
    _close(got, want, f"non-causal Sq={sq} Sk={sk}")
