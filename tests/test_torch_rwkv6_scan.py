"""The port's WKV scan entry points (``repro_torch.kernels.rwkv6_scan.
ops``: ``wkv`` in the model layout, ``rwkv6_scan`` in the kernel layout)
on CPU tensors, where they run the plain chunked version of kernel K7,
against the reference's Pallas kernel (interpret mode, the default of
its ``wkv``), its per-token oracle and its chunked substrate, on the
same numpy inputs, at the reference's own shapes and bars
(``tests/test_kernels_rwkv6.py``): 1e-3 against the per-token oracle,
1e-4 against the chunked forms."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as r_rwkv6_scan
from repro.kernels.rwkv6_scan.ops import wkv as r_wkv
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as r_oracle
from repro.models.linear_scan import chunked_linear_scan as r_chunked
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_scan_chunked_ref,
                                                rwkv6_scan_ref,
                                                rwkv6_scan_segmented_ref)

ORACLE_TOL = 1e-3
CHUNKED_TOL = 1e-4


def _inputs(b, s, h, dk, dv, seed=0, decay_scale=1.0):
    """r, k, v ~ N(0, 1), log_decay = -|N(0, 1)| * scale, u ~ 0.1 N(0, 1)
    (as the reference's test draws them), numpy float32."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    ld = (-np.abs(rng.standard_normal((b, s, h, dk))) * decay_scale
          ).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, dk))).astype(np.float32)
    return r, k, v, ld, u


def _fold(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _t(xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _max(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (1, 64, 2, 32, 32, 16), (2, 128, 3, 64, 64, 16),
    (1, 64, 1, 16, 48, 32), (2, 48, 2, 64, 64, 8)])
def test_wkv_matches_per_token_oracle(b, s, h, dk, dv, chunk):
    ins = _inputs(b, s, h, dk, dv)
    r, k, v, ld, u = ins
    o, st = ops.wkv(*_t(ins), chunk=chunk)
    assert o.shape == (b, s, h, dv) and st.shape == (b, h, dk, dv)
    uu = np.broadcast_to(u, (b, h, dk)).reshape(b * h, dk)
    o_ref, st_ref = r_oracle(*(jnp.asarray(_fold(x)) for x in (r, k, v, ld)),
                             jnp.asarray(uu))
    folded = o.transpose(1, 2).reshape(b * h, s, dv).numpy()
    assert _max(folded, o_ref) < ORACLE_TOL
    assert _max(st.reshape(b * h, dk, dv), st_ref) < ORACLE_TOL
    # the port's own oracle is the reference's, to float32 rounding
    o_p, st_p = rwkv6_scan_ref(*_t([_fold(x) for x in (r, k, v, ld)]),
                               torch.as_tensor(uu.copy()))
    assert _max(o_p, o_ref) < CHUNKED_TOL and _max(st_p, st_ref) < CHUNKED_TOL


def test_wkv_matches_reference_kernel_and_substrate():
    """The reference's kernel-vs-substrate case: the port's wkv against
    the Pallas kernel (interpret) and the chunked jnp substrate."""
    b, s, h, dk, dv = 2, 64, 2, 32, 32
    ins = _inputs(b, s, h, dk, dv)
    o, st = ops.wkv(*_t(ins), chunk=16)
    o_k, st_k = r_wkv(*(jnp.asarray(x) for x in ins), chunk=16)
    o_c, st_c = r_chunked(*(jnp.asarray(x) for x in ins[:4]), decay_on="k",
                          bonus=jnp.asarray(ins[4]), chunk=16)
    for want_o, want_st in ((o_k, st_k), (o_c, st_c)):
        assert _max(o, want_o) < CHUNKED_TOL
        assert _max(st, want_st) < CHUNKED_TOL


@pytest.mark.parametrize("s,chunk", [(64, 16), (45, 5), (17, 1), (64, 32)])
def test_kernel_layout_matches_reference_kernel(s, chunk):
    """rwkv6_scan in the kernel layout (BH, S, d) against the reference's
    Pallas kernel in interpret mode, odd chunks included."""
    b, h, dk, dv = 1, 3, 16, 24
    r, k, v, ld, u = _inputs(b, s, h, dk, dv, seed=2)
    folded = [_fold(x) for x in (r, k, v, ld)] + [u]
    o, st = ops.rwkv6_scan(*_t(folded), chunk=chunk)
    o_k, st_k = r_rwkv6_scan(*(jnp.asarray(x) for x in folded), chunk=chunk,
                             interpret=True)
    assert _max(o, o_k) < CHUNKED_TOL and _max(st, st_k) < CHUNKED_TOL
    assert ops.rwkv6_scan.launches == 0            # the plain version ran


def test_strong_decay_stability():
    """Extreme data-dependent decays stay finite (log-floor behaviour)."""
    b, s, h, dk, dv = 1, 64, 1, 16, 16
    r, k, v, _, u = _inputs(b, s, h, dk, dv)
    ld = np.full((b, s, h, dk), -50.0, np.float32)
    o, st = ops.wkv(*_t((r, k, v, ld, u)), chunk=16)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtypes(dtype):
    """As the reference's test: bf16 rounds r/k/v/decay before the fp32
    math (2e-1 against fp32 there); the port's bf16 output is also held
    to the reference kernel's bf16 output within one bf16 rounding of the
    largest output (1e-2 x max|o|)."""
    b, s, h, dk, dv = 1, 32, 2, 16, 16
    ins = _inputs(b, s, h, dk, dv)
    o, st = ops.wkv(*(x.to(dtype) for x in _t(ins)), chunk=16)
    assert o.dtype == dtype and st.dtype == torch.float32
    o32, _ = ops.wkv(*_t(ins), chunk=16)
    tol = 1e-4 if dtype == torch.float32 else 2e-1
    assert _max(o.float(), o32) < tol
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    o_k, _ = r_wkv(*(jnp.asarray(x).astype(jdt) for x in ins), chunk=16)
    scale = float(np.abs(np.asarray(o_k, np.float32)).max())
    assert _max(o.float(), o_k) <= (CHUNKED_TOL if dtype == torch.float32
                                    else 1e-2 * scale)


def test_chunk_must_divide_the_sequence():
    r, k, v, ld, u = _inputs(1, 48, 1, 16, 16)
    folded = [_fold(x) for x in (r, k, v, ld)] + [u]
    with pytest.raises(ValueError, match="% chunk"):
        r_rwkv6_scan(*(jnp.asarray(x) for x in folded), chunk=32,
                     interpret=True)
    with pytest.raises(ValueError, match="% chunk"):
        ops.rwkv6_scan(*_t(folded), chunk=32)
    with pytest.raises(ValueError, match="% chunk"):
        ops.wkv(*_t((r, k, v, ld, u)), chunk=32)
    o, _ = ops.rwkv6_scan(*_t(folded), chunk=64)     # min(chunk, S) = S
    assert o.shape == (1, 48, 16)
    with pytest.raises(ValueError, match="shapes"):
        ops.rwkv6_scan(*_t(folded[:4]), torch.zeros(2, 16))


def test_gradient_inputs_raise():
    """K7 has no backward: an input that requires a gradient raises while
    grad mode is on, never falling back; under no_grad it runs."""
    ins = list(_t(_inputs(1, 32, 2, 16, 16)))
    ins[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv(*ins)
    folded = [x.transpose(1, 2).reshape(2, 32, -1) for x in ins[:4]]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_scan(*folded, ins[4].repeat(1, 1).expand(2, 16))
    with torch.no_grad():
        o, _ = ops.wkv(*ins)
    want, _ = rwkv6_scan_chunked_ref(
        *(x.detach() for x in folded), ins[4].expand(2, 16), chunk=16)
    torch.testing.assert_close(o.transpose(1, 2).reshape(2, 32, 16), want,
                               atol=0, rtol=0)


def test_chunk_32_at_the_floor_overflows_in_both():
    """A limit both packages share: at the decay floor qh's exponent
    reaches 5 (chunk - 1), e^155 at chunk 32 — past float32's e^88.7 —
    and both give non-finite outputs, while chunk 16 (e^75) stays finite.
    The model never takes a chunk over 16."""
    b, s, h, dk, dv = 1, 64, 1, 16, 16
    r, k, v, _, u = _inputs(b, s, h, dk, dv)
    ld = np.full((b, s, h, dk), -50.0, np.float32)
    ins = (r, k, v, ld, u)
    for chunk, finite in ((32, False), (16, True)):
        o, _ = ops.wkv(*_t(ins), chunk=chunk)
        o_k, _ = r_wkv(*(jnp.asarray(x) for x in ins), chunk=chunk)
        assert bool(torch.isfinite(o).all()) == finite
        assert bool(np.isfinite(np.asarray(o_k)).all()) == finite


# -- the segmented form the CUDA kernel computes ------------------------------

SEGMENTED = {  # chunk -> (S, segments: one chunk, several chunks, whole row)
    16: (64, (16, 48, 64)), 5: (45, (5, 15, 45)), 1: (17, (1, 5, 17))}


@functools.lru_cache(maxsize=None)
def _segmented_case(chunk, bf16):
    """Kernel-layout inputs (torch) and the reference's Pallas kernel
    (interpret mode) on them, computed once per (chunk, dtype)."""
    s = SEGMENTED[chunk][0]
    r, k, v, ld, u = _inputs(1, s, 3, 16, 24, seed=chunk)
    folded = [_fold(x) for x in (r, k, v, ld)] + [u]
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    o_k, st_k = r_rwkv6_scan(*(jnp.asarray(x).astype(jdt) for x in folded),
                             chunk=chunk, interpret=True)
    ins = _t(folded)
    if bf16:
        ins = tuple(x.to(torch.bfloat16) for x in ins)
    return ins, np.asarray(o_k, np.float32), np.asarray(st_k, np.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("chunk", sorted(SEGMENTED))
@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["one_chunk", "several", "whole_row"])
def test_segmented_matches_reference_kernel(which, chunk, bf16):
    """``rwkv6_scan_segmented_ref`` (pass 1, carry, pass 3, as the CUDA
    kernel runs them) against the reference's Pallas kernel in interpret
    mode on the same inputs: segments of one chunk, of several (the last
    one shorter where the row is not a multiple) and of the whole row, at
    chunks 16, 5 and 1.  The file's bars: 1e-4 in fp32 (kernel vs
    substrate), 1e-2 x max|o| on bf16 outputs (one bf16 rounding of the
    largest output) and 1e-4 on the fp32 state; the whole-row case is
    the chunked version bitwise."""
    ins, o_k, st_k = _segmented_case(chunk, bf16)
    segment = SEGMENTED[chunk][1][which]
    o, st = rwkv6_scan_segmented_ref(*ins, chunk=chunk, segment=segment)
    assert o.dtype == ins[0].dtype and st.dtype == torch.float32
    tol = 1e-2 * float(np.abs(o_k).max()) if bf16 else CHUNKED_TOL
    assert _max(o.float(), o_k) < tol
    assert _max(st, st_k) < CHUNKED_TOL
    if segment >= ins[0].shape[1]:
        o_c, st_c = rwkv6_scan_chunked_ref(*ins, chunk=chunk)
        assert torch.equal(o, o_c) and torch.equal(st, st_c)


PLANS = [  # (tag, rows x column tiles, S, chunk, fills the card)
    ("serving", 320, 128, 16, True), ("prefill_32k", 40, 32768, 16, True),
    ("S=145", 320, 145, 5, True), ("S=127", 320, 127, 1, True),
    ("one_prompt", 40, 128, 16, True), ("bh2_4096", 2, 4096, 16, True),
    ("bh1_4095", 1, 4095, 15, False), ("one_chunk", 1, 16, 16, False)]


@pytest.mark.parametrize("tag,rows,s,chunk,fills", PLANS,
                         ids=[p[0] for p in PLANS])
def test_segment_plan(tag, rows, s, chunk, fills):
    """The K7 plan on a 132-SM card: segments hold whole chunks, every
    chunk lies in exactly one segment, none is empty, the blocks fill the
    card where the row has chunks enough, and rows that fill the card
    alone are not split."""
    n_sm = 132
    n_seg, seg_len = ops._plan_segments(rows, s, chunk, n_sm)
    assert seg_len % chunk == 0 and seg_len >= chunk
    owner = [j * chunk // seg_len for j in range(s // chunk)]
    assert owner == sorted(owner) and set(owner) == set(range(n_seg))
    assert (n_seg - 1) * seg_len < s <= n_seg * seg_len
    if rows >= ops.MIN_ROW_BLOCKS * n_sm:
        assert n_seg == 1
    else:
        assert seg_len >= min(ops.MIN_SEG_CHUNKS * chunk, s)
    assert (rows * n_seg >= n_sm) == fills
    if tag == "prefill_32k":
        assert n_seg > 1


@pytest.mark.parametrize("forced", [1, 2, 3, 5, 64])
def test_segment_plan_forced(forced):
    """A forced segment count (the card tests' knob) is clamped to the
    chunks and still covers the row with whole chunks."""
    n_seg, seg_len = ops._plan_segments(8, 145, 5, 132, n_seg=forced)
    assert n_seg == min(forced, 29)
    assert seg_len % 5 == 0 and (n_seg - 1) * seg_len < 145 <= \
        n_seg * seg_len
