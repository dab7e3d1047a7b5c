"""The port's flash attention (K5 forward, K6 backward; the wrappers'
CPU path, which runs the plain versions) against the reference's Pallas
kernels in interpret mode, on the same numpy inputs.

On CPU tensors ``ops.flash_attention`` / ``flash_attention_fwd`` /
``flash_attention_bwd`` run the plain versions (``ref.py``); the CUDA
kernels themselves are held to those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances are the
reference's own kernel-vs-oracle bars
(``tests/test_kernels_flash_attention.py``): 2e-5 on the forward in fp32
(softmax sums in another order), 3e-2 for bf16 inputs, 5e-4 on
gradients.  The JAX side runs once per module: interpret-mode Pallas is
slow on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (
    flash_attention_bwd as r_bwd, flash_attention_fwd as r_fwd)
from repro.kernels.flash_attention.ops import flash_attention as r_attn
from repro.kernels.flash_attention.ref import flash_attention_ref as r_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     flash_attention_ref,
                                                     rounding_error_ratio)
from repro_torch.models.attention import attend_reference

TOL, BF16_TOL, GRAD_TOL = 2e-5, 3e-2, 5e-4

CASES = {  # name: (B, S, H, Hkv, hd, blk, causal, window)
    "causal": (1, 128, 2, 2, 64, 64, True, 0),
    "noncausal": (1, 128, 2, 2, 64, 64, False, 0),
    "gqa": (2, 256, 4, 2, 64, 64, True, 0),
    "mqa": (1, 256, 8, 1, 32, 64, True, 0),
    "window": (2, 256, 4, 4, 64, 64, True, 64),
    "window_noncausal_hd128": (1, 128, 2, 1, 128, 64, False, 32),
}
GRAD_CASES = ("causal", "gqa", "mqa", "window")


def _inputs(name, dtype=np.float32):
    b, s, h, hkv, hd = CASES[name][:5]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                          (b, s, h, hd))]


def _kernel_layout(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.fixture(scope="module")
def jax_out():
    """The reference's outputs for every case, computed once."""
    out = {}
    for name, (b, s, h, hkv, hd, blk, causal, window) in CASES.items():
        q, k, v, g = (jnp.asarray(x) for x in _inputs(name))
        o = r_attn(q, k, v, causal, window, blk, blk, True)
        qk, kk, vk = (jnp.asarray(_kernel_layout(np.asarray(x)))
                      for x in (q, k, v))
        ok, lse = r_fwd(qk, kk, vk, causal=causal, window=window, blk_q=blk,
                        blk_k=blk, interpret=True)
        dok = jnp.asarray(_kernel_layout(np.asarray(g)))
        bwd = r_bwd(qk, kk, vk, ok, lse, dok, causal=causal, window=window,
                    blk_q=blk, blk_k=blk, interpret=True)
        grads = None
        if name in GRAD_CASES:
            grads = jax.grad(lambda q_, k_, v_: (r_attn(
                q_, k_, v_, causal, window, blk, blk, True) * g).sum(),
                argnums=(0, 1, 2))(q, k, v)
        out[name] = {"o": np.asarray(o), "ok": np.asarray(ok),
                     "lse": np.asarray(lse),
                     "bwd": [np.asarray(x) for x in bwd],
                     "grads": grads and [np.asarray(x) for x in grads]}
    return out


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_matches_reference(name, jax_out):
    _, _, _, _, _, blk, causal, window = CASES[name]
    q, k, v, _ = _inputs(name)
    tq, tk, tv = _t(q, k, v)
    o = ops.flash_attention(tq, tk, tv, causal, window, blk, blk)
    np.testing.assert_allclose(o.numpy(), jax_out[name]["o"], atol=TOL,
                               rtol=0)
    # the kernel layout, o and lse
    ok, lse = ops.flash_attention_fwd(
        *_t(*(_kernel_layout(x) for x in (q, k, v))), causal=causal,
        window=window, blk_q=blk, blk_k=blk)
    np.testing.assert_allclose(ok.numpy(), jax_out[name]["ok"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), jax_out[name]["lse"], atol=TOL,
                               rtol=0)
    # the wrapper's CPU path is the plain version itself
    want, _ = flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                      window=window)
    assert torch.equal(o, want)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_grads_match_reference(name, jax_out):
    _, _, _, _, _, blk, causal, window = CASES[name]
    q, k, v, g = _inputs(name)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = ops.flash_attention(tq, tk, tv, causal, window, blk, blk)
    got = torch.autograd.grad((o * torch.tensor(g)).sum(), (tq, tk, tv))
    for what, a, want in zip("qkv", got, jax_out[name]["grads"]):
        assert a.shape == want.shape, what
        np.testing.assert_allclose(a.numpy(), want, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{what}")


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_matches_reference_kernel(name, jax_out):
    """The kernel-layout backward (group-summed dK/dV) against the Pallas
    backward summed over each group, on the reference's own o and lse."""
    b, s, h, hkv, hd, blk, causal, window = CASES[name]
    q, k, v, g = (_kernel_layout(x) for x in _inputs(name))
    got = ops.flash_attention_bwd(
        *_t(q, k, v, jax_out[name]["ok"], jax_out[name]["lse"], g),
        causal=causal, window=window, blk_q=blk, blk_k=blk)
    dq, dk, dv = jax_out[name]["bwd"]
    n_rep = h // hkv
    want = (dq, dk.reshape(b * hkv, n_rep, s, hd).sum(1),
            dv.reshape(b * hkv, n_rep, s, hd).sum(1))
    for what, a, w in zip("qkv", got, want):
        assert a.shape == w.shape, what
        np.testing.assert_allclose(a.numpy(), w, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{what}")


def test_bwd_plain_is_not_autograd_but_agrees_with_it():
    """The plain backward (the kernels' formulas) equals autograd of the
    plain forward, and it is not computed by autograd (no graph)."""
    q, k, v, g = _inputs("gqa")
    tq, tk, tv = _t(q, k, v, grad=True)
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal=True)
    want = torch.autograd.grad((o * torch.tensor(g)).sum(), (tq, tk, tv))
    with torch.no_grad():
        got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.tensor(g),
                                      causal=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_fwd_bf16(name, jax_out):
    b, s, h, hkv, hd, blk, causal, window = CASES[name]
    q, k, v, _ = (torch.tensor(x).to(torch.bfloat16) for x in _inputs(name))
    o = ops.flash_attention(q, k, v, causal, window, blk, blk)
    assert o.dtype == torch.bfloat16
    want = np.asarray(r_attn(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                               for x in (q, k, v)),
                             causal, window, blk, blk, True)
                      .astype(jnp.float32))
    assert float(np.abs(o.float().numpy() - want).max()) < BF16_TOL
    ref = attend_reference(q.float(), k.float(), v.float(), causal=causal,
                           window=window)
    assert float((o.float() - ref).abs().max()) < BF16_TOL


def test_kernel_layout_oracle_matches_reference():
    q, k, v, _ = (_kernel_layout(x) for x in _inputs("gqa"))
    want = np.asarray(r_ref(*(jnp.asarray(x) for x in (q, k, v)),
                            causal=True, window=0))
    got = flash_attention_ref(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    o, _ = ops.flash_attention_fwd(*_t(q, k, v), causal=True, blk_q=64,
                                   blk_k=64)
    torch.testing.assert_close(o, got, atol=TOL, rtol=0)


def test_fully_masked_rows_give_mean_of_v():
    """Non-causal window with Sq > Sk + window - 1: rows with no allowed
    key get the mean of V (the dense reference softmax), lse -1e30, and
    no gradient."""
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((1, 128, 2, 32)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((1, 32, 2, 32)),
                         dtype=torch.float32) for _ in range(2))
    o, lse = ops.attention_fwd(q, k, v, causal=False, window=16)
    torch.testing.assert_close(
        o, attend_reference(q, k, v, causal=False, window=16), atol=TOL,
        rtol=0)
    torch.testing.assert_close(o[:, 64:], v.mean(1, keepdim=True).expand(
        1, 64, 2, 32), atol=TOL, rtol=0)
    assert bool((lse[:, :, 64:] == -1e30).all())
    dq, _, _ = ops.attention_bwd(q, k, v, o, lse, torch.ones_like(q),
                                 causal=False, window=16)
    assert bool((dq[:, 64:] == 0).all())


def test_once_differentiable():
    q, k, v, _ = _inputs("causal")
    tq, tk, tv = _t(q, k, v, grad=True)
    o = ops.flash_attention(tq, tk, tv, True, 0, 64, 64)
    (dq,) = torch.autograd.grad(o.sum(), (tq,), create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dq.sum(), (tq,))


@pytest.mark.parametrize("bad", ["sq_block", "sk_block", "kernel_block",
                                 "dtype", "head_dim", "groups", "lse_shape"])
def test_wrapper_validates_on_cpu(bad):
    q, k, v, g = _t(*_inputs("gqa"))
    if bad == "sq_block":                  # 256 rows in blocks of 96
        with pytest.raises(ValueError, match="Sq=256 is not a multiple"):
            ops.flash_attention(q, k, v, True, 0, 96, 64)
    elif bad == "sk_block":
        with pytest.raises(ValueError, match="Sk=200 is not a multiple"):
            ops.flash_attention(q[:, :128], k[:, :200], v[:, :200], True, 0,
                                128, 128)
    elif bad == "kernel_block":
        with pytest.raises(ValueError, match="flash_attention_fwd"):
            ops.flash_attention_fwd(*(x[0].transpose(0, 1).contiguous()
                                      for x in (q, k, v)), blk_q=100)
    elif bad == "dtype":
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.flash_attention(q.double(), k.double(), v.double())
    elif bad == "head_dim":
        with pytest.raises(ValueError, match="shapes disagree"):
            ops.flash_attention(q, k[..., :32], v[..., :32])
    elif bad == "groups":                  # 4 query heads over 3 KV heads
        with pytest.raises(ValueError, match="multiple of Hkv"):
            ops.flash_attention(q, torch.cat([k, k[:, :, :1]], 2),
                                torch.cat([v, v[:, :, :1]], 2))
    else:
        o, lse = ops.attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="lse has shape"):
            ops.attention_bwd(q, k, v, o, lse[:, :2], g)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_bf16_rounding_points_fit_the_bar(name):
    """The plain version rounding P and dS to bf16 where the bf16 kernels
    do (``round_to``), on bf16 inputs, against the reference's fp32
    oracle (its dense softmax and ``jax.vjp`` of it) on the same inputs,
    at the kernels' bf16 bars: 3e-2 on o, 3e-2 x max(1, max|ref|) on the
    gradients.  Rounding P and dS must move the result, or the argument
    does nothing."""
    b, s, h, hkv, hd, _, causal, window = CASES[name]
    q, k, v, g = (torch.tensor(x).to(torch.bfloat16).float()
                  for x in _inputs(name))
    o, lse = flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     round_to=torch.bfloat16)
    grads = flash_attention_bwd_ref(q, k, v, o, lse, g, causal=causal,
                                    window=window, round_to=torch.bfloat16)
    o32, lse32 = flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    assert not torch.equal(o, o32)
    assert torch.equal(lse, lse32)           # the row sums stay fp32
    assert not torch.equal(grads[0], flash_attention_bwd_ref(
        q, k, v, o32, lse32, g, causal=causal, window=window)[0])
    qk, kk, vk, gk = (jnp.asarray(_kernel_layout(x.numpy()))
                      for x in (q, k, v, g))
    want_o, vjp = jax.vjp(lambda q_, k_, v_: r_ref(
        q_, k_, v_, causal=causal, window=window), qk, kk, vk)
    assert float(np.abs(_kernel_layout(o.numpy()) - np.asarray(want_o))
                 .max()) < BF16_TOL
    for what, got, want in zip("qkv", grads, vjp(gk)):
        want = np.asarray(want)
        err = float(np.abs(_kernel_layout(got.numpy()) - want).max())
        assert err < BF16_TOL * max(1.0, float(np.abs(want).max())), what


@pytest.mark.parametrize("name", GRAD_CASES)
def test_rounding_bar_passes_rounding_noise_and_fails_a_wrong_tile(name):
    """``rounding_error_ratio``, the element-by-element bar that holds the
    bf16 kernels to the rounding plain version: the whole effect of
    rounding P and dS (the unrounded version) stays within it, while one
    query head whose rows lose their oldest 32 keys, or dK/dV of the last
    32 keys without one query head's share, fall outside it."""
    b, s, h, hkv, hd, _, causal, window = CASES[name]
    q, k, v, g = (torch.tensor(x).to(torch.bfloat16).float()
                  for x in _inputs(name))
    o, lse = flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     round_to=torch.bfloat16)
    want = [o] + list(flash_attention_bwd_ref(
        q, k, v, o, lse, g, causal=causal, window=window,
        round_to=torch.bfloat16))
    want = [x.to(torch.bfloat16) for x in want]
    o32, _ = flash_attention_fwd_ref(q, k, v, causal=causal, window=window)
    plain = [o32] + list(flash_attention_bwd_ref(
        q, k, v, o, lse, g, causal=causal, window=window))
    for got, ref in zip(plain, want):
        assert rounding_error_ratio(got, ref) <= 1.0
    last = h - 1                              # its KV head is the last one
    o_narrow, _ = flash_attention_fwd_ref(
        q[:, :, last:], k[:, :, -1:], v[:, :, -1:], causal=causal,
        window=(window or s) - 32)
    wrong = want[0].clone()
    wrong[:, :, last] = o_narrow[:, :, 0].to(torch.bfloat16)
    assert rounding_error_ratio(wrong, want[0]) > 1.0
    g0 = g.clone()
    g0[:, :, last] = 0
    _, dk0, dv0 = flash_attention_bwd_ref(q, k, v, o, lse, g0, causal=causal,
                                          window=window,
                                          round_to=torch.bfloat16)
    for i, part in ((2, dk0), (3, dv0)):
        wrong = want[i].clone()
        wrong[:, -32:] = part[:, -32:].to(torch.bfloat16)
        assert rounding_error_ratio(wrong, want[i]) > 1.0


def test_dtype_selects_the_source():
    """bf16 goes to the tensor-core source, fp32 to the SIMT one; both are
    among the sources the build compiles, each into its own library."""
    assert ops.SOURCES[torch.bfloat16].name == "flash_attention_sm90.cu"
    assert ops.SOURCES[torch.float32].name == "flash_attention.cu"
    assert set(ops.SOURCES) == set(ops._DTYPES)
    built = _build.kernel_sources()
    assert all(src in built for src in ops.SOURCES.values())
    assert len({_build.library_path(src) for src in ops.SOURCES.values()}) == 2
