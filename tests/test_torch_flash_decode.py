"""The port's paged flash decode (K3's plain version and its wrappers'
CPU path) against the reference's Pallas kernel in interpret mode and
its gather oracle, on the same numpy inputs.

On CPU tensors ``ops.flash_decode_paged`` / ``ops.paged_decode_attention``
run the plain version (``kernels/flash_decode/ref.py``); the CUDA kernel
itself is held to that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerance 2e-5, the
reference's own kernel-vs-oracle bar (fp32 softmax sums in another
order); 3e-2 for bf16 inputs against the fp32 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode_paged as r_kernel
from repro.kernels.flash_decode.ops import paged_decode_attention as r_paged
from repro.kernels.flash_decode.ref import flash_decode_paged_ref as r_ref
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import (flash_decode_paged_ref,
                                                  paged_decode_ref)
from repro_torch.models.attention import decode_attend, decode_attend_paged

TOL = 2e-5
# the reference test's table: scattered pages, entries past valid -> 0
PT = np.asarray([[5, 2, 9, 0], [11, 7, 0, 0], [3, 14, 8, 1]], np.int32)
VALID = np.asarray([40, 17, 64], np.int32)          # cuts mid-page


def _kernel_layout(h, hkv, hd=64, n_pages=16, ps=16, seed=0,
                   dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = PT.shape[0]
    q = rng.standard_normal((b * h, 1, hd)).astype(dtype)
    k = rng.standard_normal((hkv, n_pages, ps, hd)).astype(dtype)
    v = rng.standard_normal((hkv, n_pages, ps, hd)).astype(dtype)
    return q, k, v, np.repeat(VALID, h)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1)])
def test_plain_matches_reference_kernel(h, hkv):
    q, k, v, valid = _kernel_layout(h, hkv)
    want = np.asarray(r_kernel(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(PT),
                               jnp.asarray(valid), interpret=True))
    oracle = np.asarray(r_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(PT),
                              jnp.asarray(valid)))
    got = ops.flash_decode_paged(*_t(q, k, v, PT, valid)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)
    # the wrapper's CPU path is the plain version itself
    assert np.array_equal(got, flash_decode_paged_ref(
        *_t(q, k, v, PT, valid)).numpy())


def test_plain_per_head_valid_lengths():
    """The kernel layout carries one valid length per query head."""
    h, hkv = 4, 2
    q, k, v, valid = _kernel_layout(h, hkv, seed=1)
    valid = np.maximum(valid - np.arange(valid.size) % 5, 1).astype(np.int32)
    want = np.asarray(r_kernel(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(PT),
                               jnp.asarray(valid), interpret=True))
    got = ops.flash_decode_paged(*_t(q, k, v, PT, valid)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_plain_bf16_against_fp32_oracle():
    h, hkv = 4, 2
    q, k, v, valid = _kernel_layout(h, hkv, seed=2)
    qb, kb, vb = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_decode_paged(qb, kb, vb, *_t(PT, valid))
    assert got.dtype == torch.bfloat16
    want = np.asarray(r_kernel(*(jnp.asarray(x.float().numpy())
                                 for x in (qb, kb, vb)),
                               jnp.asarray(PT), jnp.asarray(valid),
                               interpret=True))
    assert float(np.abs(got.float().numpy() - want).max()) < 3e-2


@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1)])
def test_model_layout_matches_reference(h, hkv):
    """Model layout (B,1,H,hd) over pools (P,ps,Hkv,hd): the reference's
    ``paged_decode_attention`` (its CPU path) within 2e-5, and the port's
    own gather + dense decode bitwise."""
    rng = np.random.default_rng(3)
    b, hd, ps, n_pages = 3, 64, 16, 16
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    want = np.asarray(r_paged(*(jnp.asarray(x) for x in (q, kp, vp, PT,
                                                         VALID))))
    tq, tk, tv, tpt, tvl = _t(q, kp, vp, PT, VALID)
    got = ops.paged_decode_attention(tq, tk, tv, tpt, tvl)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert torch.equal(got, decode_attend_paged(tq, tk, tv, tpt, tvl))
    assert torch.equal(got, paged_decode_ref(tq, tk, tv, tpt, tvl))


def test_identity_table_bitwise_dense():
    """Contiguous per-sequence pages: the paged plain version equals the
    dense decode over the same positions bitwise."""
    rng = np.random.default_rng(4)
    b, h, hkv, hd, ps, mp = 2, 4, 2, 64, 16, 4
    q = torch.as_tensor(rng.standard_normal((b, 1, h, hd)), dtype=torch.float32)
    kd = torch.as_tensor(rng.standard_normal((b, mp * ps, hkv, hd)),
                         dtype=torch.float32)
    vd = torch.as_tensor(rng.standard_normal((b, mp * ps, hkv, hd)),
                         dtype=torch.float32)
    pool_k = torch.cat([torch.zeros(1, ps, hkv, hd),
                        kd.reshape(b * mp, ps, hkv, hd)])
    pool_v = torch.cat([torch.zeros(1, ps, hkv, hd),
                        vd.reshape(b * mp, ps, hkv, hd)])
    pt = (1 + torch.arange(b * mp, dtype=torch.int32)).reshape(b, mp)
    valid = torch.as_tensor([mp * ps, 37], dtype=torch.int32)
    assert torch.equal(ops.paged_decode_attention(q, pool_k, pool_v, pt, valid),
                       decode_attend(q, kd, vd, valid))


@pytest.mark.parametrize("bad", ["table_int64", "valid_int64", "pool_dtype",
                                 "valid_shape", "pool_shape"])
def test_wrapper_validates_on_cpu(bad):
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((3, 1, 4, 64)), dtype=torch.float32)
    kp = torch.as_tensor(rng.standard_normal((16, 16, 2, 64)),
                         dtype=torch.float32)
    vp, pt, valid = kp.clone(), torch.as_tensor(PT), torch.as_tensor(VALID)
    if bad == "table_int64":
        pt = pt.long()
    elif bad == "valid_int64":
        valid = valid.long()
    elif bad == "pool_dtype":
        vp = vp.double()
    elif bad == "valid_shape":
        valid = valid[:2]
    else:
        vp = vp[:8]
    with pytest.raises(ValueError, match="paged_decode_attention"):
        ops.paged_decode_attention(q, kp, vp, pt, valid)
