"""The port's flash decode, paged (K3's plain version and its wrappers'
CPU path) and dense (K4: ``decode_attention``, ``flash_decode``), against
the reference's Pallas kernels in interpret mode and its oracles, on the
same numpy inputs.

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

from repro.kernels.flash_decode.kernel import flash_decode as r_dense_kernel
from repro.kernels.flash_decode.kernel import flash_decode_paged as r_kernel
from repro.kernels.flash_decode.ops import decode_attention as r_dense
from repro.kernels.flash_decode.ops import paged_decode_attention as r_paged
from repro.kernels.flash_decode.ref import flash_decode_paged_ref as r_ref
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import (decode_attention_ref,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref,
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


# -- K4: the dense decode ------------------------------------------------------

def _dense(b, s, h, hkv, hd, seed, hi=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, hd)).astype(dtype)
    k = rng.standard_normal((b, s, hkv, hd)).astype(dtype)
    v = rng.standard_normal((b, s, hkv, hd)).astype(dtype)
    valid = rng.integers(1, (hi or s) + 1, b).astype(np.int32)
    valid[0] = hi or s
    return q, k, v, valid


@pytest.mark.parametrize("b,s,h,hkv,hd,blk,window,hi", [
    (2, 512, 4, 4, 64, 128, 0, None),
    (2, 512, 4, 2, 64, 256, 0, None),      # GQA
    (1, 1024, 8, 1, 32, 128, 0, None),     # MQA
    (2, 256, 4, 2, 64, 64, 256, 700),      # ring: valid beyond the window
    (3, 200, 4, 2, 64, 64, 0, None),       # S not a multiple of blk_k
    (3, 200, 4, 2, 64, 512, 0, None)])     # blk_k > S
def test_dense_decode_matches_reference(b, s, h, hkv, hd, blk, window, hi):
    q, k, v, valid = _dense(b, s, h, hkv, hd, seed=s + blk + window, hi=hi)
    want = np.asarray(r_dense(*(jnp.asarray(x) for x in (q, k, v, valid)),
                              window=window, blk_k=blk))
    tq, tk, tv, tvl = _t(q, k, v, valid)
    got = ops.decode_attention(tq, tk, tv, tvl, window=window, blk_k=blk)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert torch.equal(got, decode_attention_ref(tq, tk, tv, tvl,
                                                 window=window, blk_k=blk))


def test_dense_decode_reads_whole_blocks_only():
    """Positions at or past (S // blk_k)·blk_k are never read, as in the
    reference kernel (its grid has S // blk_k blocks): NaN there changes
    nothing, and the result is the decode of the truncated cache."""
    q, k, v, valid = _dense(3, 200, 4, 2, 64, seed=11)
    k[:, 192:] = np.nan
    v[:, 192:] = np.nan
    want = np.asarray(r_dense(*(jnp.asarray(x) for x in (q, k, v, valid)),
                              blk_k=64))
    tq, tk, tv, tvl = _t(q, k, v, valid)
    got = ops.decode_attention(tq, tk, tv, tvl, blk_k=64)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert torch.equal(got, decode_attend(tq, tk[:, :192], tv[:, :192],
                                          tvl.clamp(max=192)))


def test_dense_decode_ring_matches_ring_attend():
    """A full ring of ``window`` slots: the clamp valid -> min(valid,
    window) equals the model's ring decode."""
    from repro_torch.models.attention import decode_attend_ring
    q, k, v, _ = _dense(2, 256, 4, 4, 64, seed=12)
    step = torch.as_tensor([400, 90], dtype=torch.int32)
    tq, tk, tv = _t(q, k, v)
    got = ops.decode_attention(tq, tk, tv, step, window=256, blk_k=64)
    torch.testing.assert_close(
        got, decode_attend_ring(tq, tk, tv, step, window=256), atol=TOL,
        rtol=0)


@pytest.mark.parametrize("s,blk", [(512, 128), (200, 64)])
def test_flash_decode_kernel_layout_matches_reference(s, blk):
    """The reference kernel's layout with one valid length per query
    head, against its Pallas kernel and (on whole blocks) its oracle."""
    h, hkv, b, hd = 4, 2, 2, 64
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b * h, 1, hd)).astype(np.float32)
    k = rng.standard_normal((b * hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b * hkv, s, hd)).astype(np.float32)
    valid = rng.integers(1, s + 1, b * h).astype(np.int32)
    want = np.asarray(r_dense_kernel(*(jnp.asarray(x)
                                       for x in (q, k, v, valid)),
                                     blk_k=blk, interpret=True))
    got = ops.flash_decode(*_t(q, k, v, valid), blk_k=blk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    span = (s // blk) * blk
    oracle = flash_decode_ref(*_t(q, k[:, :span], v[:, :span],
                                  np.minimum(valid, span)))
    torch.testing.assert_close(got, oracle, atol=TOL, rtol=0)


def test_dense_decode_bf16_against_fp32_reference():
    q, k, v, valid = _dense(2, 512, 4, 2, 64, seed=13)
    qb, kb, vb = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.decode_attention(qb, kb, vb, torch.as_tensor(valid))
    assert got.dtype == torch.bfloat16
    want = np.asarray(r_dense(*(jnp.asarray(x.float().numpy())
                                for x in (qb, kb, vb)),
                              jnp.asarray(valid)))
    assert float(np.abs(got.float().numpy() - want).max()) < 3e-2


@pytest.mark.parametrize("bad", ["valid_int64", "cache_dtype", "valid_shape",
                                 "batch", "kernel_layout_groups"])
def test_dense_wrapper_validates_on_cpu(bad):
    q, k, v, valid = _t(*_dense(2, 128, 4, 2, 64, seed=14))
    name = "decode_attention"
    if bad == "valid_int64":
        valid = valid.long()
    elif bad == "cache_dtype":
        v = v.double()
    elif bad == "valid_shape":
        valid = valid[:1]
    elif bad == "batch":
        k, v = k[:1], v[:1]
    else:
        name = "flash_decode"
    with pytest.raises(ValueError, match=name):
        if bad == "kernel_layout_groups":      # 8 query heads over 3
            kv = torch.zeros(3, 128, 64)
            ops.flash_decode(q.reshape(8, 1, 64), kv, kv, valid.repeat(4))
        else:
            ops.decode_attention(q, k, v, valid)
