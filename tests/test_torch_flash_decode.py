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


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1), (10, 2), (12, 2)])
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


# -- the kernel's split-and-combine, written out plainly -----------------------

H_SPLIT, HKV_SPLIT = 4, 2
# per query head (B=3 x H=4): 0, 1 and the full capacity 64 among the rest
VALID_HEADS = np.asarray([40, 1, 33, 64, 17, 0, 9, 16, 64, 60, 1, 0],
                         np.int32)


@pytest.fixture(scope="module")
def split_case():
    """Kernel-layout inputs and the reference Pallas kernel's outputs
    (interpret mode), once per module: valid lengths per sequence
    (``VALID``) and per query head (``VALID_HEADS``)."""
    q, k, v, valid = _kernel_layout(H_SPLIT, HKV_SPLIT, seed=21)
    want = {}
    for tag, vl in (("seq", valid), ("heads", VALID_HEADS)):
        want[tag] = np.asarray(r_kernel(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(PT),
                                        jnp.asarray(vl), interpret=True))
    return q, k, v, valid, want


def _model_layout(q, k, v):
    """(BH,1,hd), (Hkv,P,ps,hd) -> (B,1,H,hd), (P,ps,Hkv,hd)."""
    b = PT.shape[0]
    tq = torch.as_tensor(q).reshape(b, 1, -1, q.shape[-1])
    return (tq, torch.as_tensor(k).permute(1, 2, 0, 3),
            torch.as_tensor(v).permute(1, 2, 0, 3))


# 1 split; 2; 3 and 5 do not divide the table's 64 positions; at 8, the
# splits past 17 and 40 are wholly past those sequences' lengths
@pytest.mark.parametrize("n_splits", [1, 2, 3, 5, 8])
def test_split_ref_matches_reference_kernel(split_case, n_splits):
    from repro_torch.kernels.flash_decode.ref import split_decode_ref
    q, k, v, valid, want = split_case
    tq, tk, tv = _model_layout(q, k, v)
    tpt, tvl = _t(PT, VALID)
    got = split_decode_ref(tq, tk, tv, tpt, tvl, n_splits)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(got.reshape(want["seq"].shape).numpy(),
                               want["seq"], atol=TOL, rtol=0)
    torch.testing.assert_close(got, paged_decode_ref(tq, tk, tv, tpt, tvl),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("n_splits", [1, 3, 8])
def test_split_ref_per_head_lengths(split_case, n_splits):
    """One valid length per query head (the kernel layout's), among them
    1, the full capacity and 0: zeros at 0, as the Pallas kernel gives."""
    from repro_torch.kernels.flash_decode.ref import split_decode_ref
    q, k, v, _, want = split_case
    tq, tk, tv = _model_layout(q, k, v)
    b = PT.shape[0]
    heads = torch.as_tensor(VALID_HEADS).reshape(b, H_SPLIT)
    got = split_decode_ref(tq, tk, tv, torch.as_tensor(PT), heads, n_splits)
    flat = got.reshape(want["heads"].shape).numpy()
    np.testing.assert_allclose(flat, want["heads"], atol=TOL, rtol=0)
    zero = VALID_HEADS == 0
    assert not flat[zero].any()
    oracle = flash_decode_paged_ref(*_t(q, k, v, PT, VALID_HEADS)).numpy()
    np.testing.assert_allclose(flat[~zero], oracle[~zero], atol=TOL, rtol=0)


def test_split_ref_nan_past_valid_never_mixes_in(split_case):
    """NaN in the trash page 0 (behind table entries past each valid
    length) leaves every split's partial finite."""
    from repro_torch.kernels.flash_decode.ref import split_decode_ref
    q, k, v, _, want = split_case
    k, v = k.copy(), v.copy()
    k[:, 0] = np.nan
    v[:, 0] = np.nan
    tq, tk, tv = _model_layout(q, k, v)
    got = split_decode_ref(tq, tk, tv, *_t(PT, VALID), 3)
    np.testing.assert_allclose(got.reshape(want["seq"].shape).numpy(),
                               want["seq"], atol=TOL, rtol=0)


# (batch, KV heads, table pages, page size, SMs, tile, K row bytes):
# decode_32k's dense "page" (fp32 and bf16), the long paged case, the
# serving shape, one small sequence, a page larger than a tile, few SMs
PLAN_CASES = [(8, 8, 1, 32_768, 132, 16, 512), (8, 8, 1, 32_768, 132, 32, 256),
              (8, 8, 256, 16, 132, 32, 256), (8, 8, 12, 16, 132, 16, 512),
              (1, 1, 1, 16, 132, 16, 512), (2, 4, 10, 48, 132, 32, 128),
              (3, 2, 4, 16, 8, 64, 128)]


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("forced", [None, 3])
def test_plan_splits(case, forced):
    b, hkv, mp, ps, n_sm, tile, row = case
    n, span = ops._plan_splits(b, hkv, mp, ps, n_sm, tile, row, forced)
    assert type(n) is int and type(span) is int
    assert n >= 1 and span % tile == 0
    if ps <= 64:
        assert span % ps == 0                # whole small pages
    cap = mp * ps
    assert n * span >= cap > (n - 1) * span  # covers the table, no idle tail
    assert (n, span) == ops._plan_splits(b, hkv, mp, ps, n_sm, tile, row,
                                         forced)
    if forced is None:
        assert 2 * span * row <= max(ops.SPLIT_BYTES, 2 * tile * row)
        if cap == 32_768:                    # decode_32k: the split path
            assert n > 1 and b * hkv * n >= n_sm


# spans the plan gives (multiples of the 16-token page), not dividing 64
@pytest.mark.parametrize("span", [16, 48, 32])
def test_split_ref_at_the_plans_span(split_case, span):
    """Split boundaries at a given span, as the kernel's plan sets them."""
    from repro_torch.kernels.flash_decode.ref import split_decode_ref
    q, k, v, valid, want = split_case
    tq, tk, tv = _model_layout(q, k, v)
    got = split_decode_ref(tq, tk, tv, *_t(PT, VALID), -(-64 // span),
                           span=span)
    np.testing.assert_allclose(got.reshape(want["seq"].shape).numpy(),
                               want["seq"], atol=TOL, rtol=0)


def _truncate_bf16(x):
    """fp32 -> bf16 by dropping the low 16 bits (rounding toward zero)."""
    bits = x.float().contiguous().view(torch.int32) & ~0xFFFF
    return bits.view(torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("wrong", ["last 16 tokens", "last 32 tokens",
                                   "truncated"])
def test_bf16_bar_passes_rounding_and_fails_wrong_outputs(split_case, wrong):
    """``ref.bf16_error_ratio``: the fp32 plain output rounded to bf16 is
    inside the bar; outputs a faulty bf16 kernel could give are not: each
    sequence's last tile or split left out (``chip_smoke.py``'s planted
    outputs), or the output truncated to bf16 instead of rounded."""
    from repro_torch.kernels.flash_decode.ref import bf16_error_ratio
    q, k, v, _, _ = split_case
    tq, tk, tv = (x.to(torch.bfloat16).float()
                  for x in _model_layout(q, k, v))
    pt, valid = _t(PT, VALID)
    want = paged_decode_ref(tq, tk, tv, pt, valid)
    assert bf16_error_ratio(want.to(torch.bfloat16), want) <= 1.0
    if wrong == "truncated":
        bad = _truncate_bf16(want)
    else:
        n = int(wrong.split()[1])
        short = torch.where(valid > n, valid - n, valid)
        bad = paged_decode_ref(tq, tk, tv, pt, short).to(torch.bfloat16)
    assert bf16_error_ratio(bad, want) > 1.0
    nan = want.to(torch.bfloat16)
    nan[0, 0, 0, 0] = float("nan")
    assert not bf16_error_ratio(nan, want) <= 1.0
