"""The hand-written CUDA kernels on a card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (this
file imports neither JAX nor the reference, so it also runs on a GPU
machine that has no JAX:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.masked_agg import ops
from repro_torch.kernels.masked_agg.ref import masked_agg_ref

TOL = 2e-5      # the reference's own kernel-vs-oracle bar

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs "
                    "these checks at the main path's shapes)")
    return torch.device("cuda")


def _case(dev, t, c, tile, seed=0, n_units=5):
    """K1's inputs: unit 1 selected by nobody (its rows keep the global
    value), client ``c - 1`` of weight 0 but selecting unit 0 (still
    read), the other selections random."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(t, tile, generator=gen, device=dev)
    d = torch.randn(c, t, tile, generator=gen, device=dev)
    rng = np.random.default_rng(seed)
    sel = torch.as_tensor(rng.integers(0, 2, (c, n_units)),
                          dtype=torch.float32)
    sel[:, 1] = 0.0
    sel[:, 0] = 1.0
    w = torch.as_tensor(rng.uniform(0.5, 2.0, c), dtype=torch.float32)
    w[c - 1] = 0.0
    ru = torch.as_tensor(np.arange(t) % n_units, dtype=torch.int32)
    return g, d, sel.to(dev), w.to(dev), ru.to(dev)


@pytest.mark.parametrize("t,c,tile", [(1, 1, 4), (7, 3, 256), (33, 8, 2048),
                                      (5, 2, 12), (44, 10, 2048),
                                      (9, 33, 256)])
def test_kernel_matches_plain(dev, t, c, tile):
    args = _case(dev, t, c, tile)
    g, ru = args[0], args[-1]
    before = ops.masked_agg.launches
    out = ops.masked_agg(*args)
    torch.cuda.synchronize()
    assert ops.masked_agg.launches == before + 1
    torch.testing.assert_close(out, masked_agg_ref(*args), atol=TOL,
                               rtol=TOL)
    still = ru == 1                                   # nobody trained
    assert torch.equal(out[still], g[still])
    assert torch.equal(out, ops.masked_agg(*args))    # bitwise repeatable


@pytest.mark.parametrize("t,c,tile", [(300, 10, 2048), (300, 33, 2000),
                                      (1100, 2, 12)])
def test_kernel_launch_widths_agree_bitwise(dev, t, c, tile):
    """A call of ``t`` rows launches 2 float4s a thread, its slices of
    256 rows 1 (``ops.launch_vec``); both sum each element's clients in
    the same order, so the slices' outputs are bitwise the whole call's
    rows, ragged chunks included."""
    g, d, sel, w, ru = _case(dev, t, c, tile, seed=t)
    assert ops.launch_vec(t, tile) == 2 and ops.launch_vec(256, tile) == 1
    whole = ops.masked_agg(g, d, sel, w, ru)
    torch.testing.assert_close(whole, masked_agg_ref(g, d, sel, w, ru),
                               atol=TOL, rtol=TOL)
    for a in range(0, t, 256):
        part = ops.masked_agg(g[a:a + 256], d[:, a:a + 256], sel, w,
                              ru[a:a + 256])
        assert torch.equal(part, whole[a:a + 256]), a


def test_kernel_reads_strided_client_planes(dev):
    # planes of a larger (C, T + 3, tile) buffer: client stride != T*tile
    g, d, sel, w, ru = _case(dev, 6, 4, 256)
    big = torch.zeros(4, 9, 256, device=dev)
    big[:, 2:8] = d
    view = big[:, 2:8]
    assert not view.is_contiguous()
    torch.testing.assert_close(ops.masked_agg(g, view, sel, w, ru),
                               masked_agg_ref(g, d, sel, w, ru), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("where", ["unselected", "zero_weight"])
def test_kernel_nan_planes(dev, where):
    """A NaN in a plane the client did not select is never read (the
    output equals the clean one bitwise); a NaN in a selected plane of
    a zero-weight client reaches the output (0·NaN), in the kernel and
    its plain version alike."""
    g, d, sel, w, ru = _case(dev, 10, 4, 256)
    clean = ops.masked_agg(g, d, sel, w, ru)
    if where == "unselected":
        sel[0, 2], sel[1, 2] = 0.0, 1.0               # row 2 is unit 2
        clean = ops.masked_agg(g, d, sel, w, ru)
        d[0, 2, 9] = float("nan")
        out = ops.masked_agg(g, d, sel, w, ru)
        assert torch.equal(out, clean)
        assert torch.equal(out, ops.masked_agg(g, d.nan_to_num(0.0), sel,
                                               w, ru))
        torch.testing.assert_close(out, masked_agg_ref(g, d, sel, w, ru),
                                   atol=TOL, rtol=TOL)
    else:
        d[3, 0, 9] = float("nan")                     # client 3: weight 0
        out = ops.masked_agg(g, d, sel, w, ru)
        plain = masked_agg_ref(g, d, sel, w, ru)
        assert bool(torch.isnan(out[0, 9])) and bool(torch.isnan(plain[0, 9]))
        nan = torch.isnan(out)
        assert int(nan.sum()) == 1
        torch.testing.assert_close(out[~nan], clean[~nan], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bad", ["misaligned", "row_stride", "float64",
                                 "row_unit_dtype", "row_unit_len",
                                 "sel_shape", "cpu_mix"])
def test_kernel_wrapper_raises(dev, bad):
    g, d, sel, w, ru = _case(dev, 4, 2, 256)
    if bad == "misaligned":
        g = torch.zeros(4 * 256 + 1, device=dev)[1:].view(4, 256)
    elif bad == "row_stride":
        d = torch.zeros(2, 4, 512, device=dev)[:, :, :256]
    elif bad == "float64":
        w = w.double()
    elif bad == "row_unit_dtype":
        ru = ru.long()
    elif bad == "row_unit_len":
        ru = ru[:3]
    elif bad == "sel_shape":
        sel = sel[:1]
    else:
        sel = sel.cpu()
    before = ops.masked_agg.launches
    with pytest.raises(ValueError, match="masked_agg"):
        ops.masked_agg(g, d, sel, w, ru)
    assert ops.masked_agg.launches == before


def test_fused_tree_matches_plain_on_card(dev):
    from repro_torch.core.aggregation import masked_fedavg
    from repro_torch.core.masking import build_units_flat
    from repro_torch.models import paper_models as pm
    params = {k: v.to(dev) for k, v in pm.init_vgg16(
        torch.Generator().manual_seed(0), width_mult=0.25).items()}
    assign = build_units_flat(params, pm.vgg16_units(params))
    rng = np.random.default_rng(0)
    sel = torch.as_tensor(rng.integers(0, 2, (5, 14)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 5), dtype=torch.float32)
    deltas = {k: 0.05 * torch.randn((5,) + tuple(v.shape), device=dev)
              for k, v in params.items()}
    got = ops.masked_fedavg_fused(params, deltas, sel, w, assign)
    ref = masked_fedavg(params, deltas, sel, w, assign)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=TOL, rtol=TOL)


# -- K2: quantize-pack -------------------------------------------------------

def _qcase(dev, r, p, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.05 * torch.randn(r, p, generator=gen, device=dev)
    u = torch.rand(r, p, generator=gen, device=dev)
    x[r // 2] = 0.0                                   # an all-zero row
    return x, u


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("r,p", [(1, 1), (8, 10), (3, 4097), (8, 8192),
                                 (2, 8193), (8, 2_359_296), (5, 30_001)])
def test_quantize_pack_matches_plain_bitwise(dev, bits, r, p):
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.codec.ref import quantize_pack_ref
    x, u = _qcase(dev, r, p)
    before = qops.quantize_pack_group.launches
    codes, scale = qops.quantize_pack(x, u, bits)
    torch.cuda.synchronize()
    assert qops.quantize_pack_group.launches == before + 1
    want_codes, want_scale = quantize_pack_ref(x, u, bits)
    assert codes.dtype == want_codes.dtype and codes.shape == want_codes.shape
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)
    again = qops.quantize_pack(x, u, bits)           # bitwise repeatable
    assert torch.equal(again[0], codes) and torch.equal(again[1], scale)
    if bits == 4 and r > 1:
        assert bool((codes[r // 2] == 0x88).all())


def test_quantize_pack_reads_unaligned_rows(dev):
    # a view starting one float in: no 16-byte loads, same codes
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.codec.ref import quantize_pack_ref
    x, u = _qcase(dev, 4, 4097)
    xs = torch.zeros(4 * 4096 + 1, device=dev)[1:].view(4, 4096)
    us = torch.zeros(4 * 4096 + 1, device=dev)[1:].view(4, 4096)
    xs.copy_(x[:, :4096])
    us.copy_(u[:, :4096])
    for bits in (8, 4):
        got = qops.quantize_pack(xs, us, bits)
        want = quantize_pack_ref(xs, us, bits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["strided", "float64", "device"])
def test_quantize_pack_wrapper_raises(dev, bad):
    from repro_torch.kernels.codec import ops as qops
    x, u = _qcase(dev, 4, 256)
    if bad == "strided":
        x = torch.zeros(4, 512, device=dev)[:, ::2]
    elif bad == "float64":
        u = u.double()
    else:
        u = u.cpu()
    with pytest.raises(ValueError, match="quantize_pack"):
        qops.quantize_pack(x, u, 8)


def _qgroup(dev, shapes, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [0.05 * torch.randn(r, p, generator=gen, device=dev)
          for r, p in shapes]
    us = [torch.rand(r, p, generator=gen, device=dev) for r, p in shapes]
    return xs, us


def _same_codes(got, xs, us, bits):
    """Each leaf's codes and scales bitwise equal to the plain version's
    (a NaN scale equal to a NaN)."""
    from repro_torch.kernels.codec.ref import quantize_pack_ref
    assert len(got) == len(xs)
    for i, ((codes, scale), x, u) in enumerate(zip(got, xs, us)):
        want_codes, want_scale = quantize_pack_ref(x, u, bits)
        assert codes.dtype == want_codes.dtype, i
        assert codes.shape == want_codes.shape, i
        assert torch.equal(codes, want_codes), i
        torch.testing.assert_close(scale, want_scale, rtol=0, atol=0,
                                   equal_nan=True)


_QWIDTHS = [1, 2, 3, 10, 255, 4096, 4097, 8192, 8193, 30_001]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [1, 7, 80, 200])
def test_quantize_pack_group_matches_plain_bitwise(dev, bits, n):
    """K2 over n mixed leaves in one launch: every leaf bitwise equal to
    the plain version, an all-zero row packing to zeros (0x88 at 4 bits),
    and two launches bitwise equal."""
    from repro_torch.kernels.codec import ops as qops
    rng = np.random.default_rng(n)
    shapes = [(int(rng.integers(1, 9)), int(rng.choice(_QWIDTHS)))
              for _ in range(n)]
    xs, us = _qgroup(dev, shapes, seed=n)
    xs[n // 2][0] = 0.0
    before = qops.quantize_pack_group.launches
    got = qops.quantize_pack_group(xs, us, bits)
    torch.cuda.synchronize()
    assert qops.quantize_pack_group.launches == before + 1
    _same_codes(got, xs, us, bits)
    zero = got[n // 2][0][0]
    assert bool((zero == (0 if bits == 8 else 0x88)).all())
    again = qops.quantize_pack_group(xs, us, bits)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(got, again))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pack_group_long_odd_and_nan_rows(dev, bits):
    """Rows of 288 chunks (VGG16's largest leaves) beside small ones, an
    unaligned leaf (no 16-byte loads), and a row holding a NaN and an
    infinity (the max keeps the NaN; NaN codes pack as the plain version's
    cast gives), in one launch: rows of 1 chunk, rows of 5 that wait in
    place for their maxima (x read once) and rows of 288 that take two
    visits (maxima first, then quantize)."""
    from repro_torch.kernels.codec import ops as qops
    xs, us = _qgroup(dev, [(8, 2_359_296), (3, 5), (2, 40_000), (4, 4097)])
    xs[2][0, 123] = float("nan")
    xs[2][1, 9] = float("inf")
    xs[3][1, 4000] = float("-inf")
    flat = torch.zeros(4 * 4096 + 1, device=dev)[1:].view(4, 4096)
    flat.copy_(0.05 * torch.randn(4, 4096, device=dev))
    xs.append(flat)
    us.append(torch.zeros(4 * 4096 + 1, device=dev)[1:].view(4, 4096)
              .uniform_())
    assert xs[-1].data_ptr() % 16 and xs[-1].is_contiguous()
    before = qops.quantize_pack_group.launches
    got = qops.quantize_pack_group(xs, us, bits)
    torch.cuda.synchronize()
    assert qops.quantize_pack_group.launches == before + 1
    _same_codes(got, xs, us, bits)
    assert bool(got[2][1][0].isnan()) and bool(got[2][1][1].isinf())


def test_quantize_pack_group_longer_than_one_launch(dev):
    """A list longer than one launch's parameter struct is cut into
    launches of whole leaves, each with its own ticket."""
    from repro_torch.kernels.codec import ops as qops
    n = qops.MAX_LEAVES + 44
    rng = np.random.default_rng(3)
    shapes = [(int(rng.integers(1, 5)), int(rng.choice(_QWIDTHS[:7])))
              for _ in range(n)]
    xs, us = _qgroup(dev, shapes, seed=3)
    for bits in (8, 4):
        before = qops.quantize_pack_group.launches
        got = qops.quantize_pack_group(xs, us, bits)
        torch.cuda.synchronize()
        assert qops.quantize_pack_group.launches == before + 2
        _same_codes(got, xs, us, bits)


@pytest.mark.parametrize("bad", ["strided", "float64", "device", "shape"])
def test_quantize_pack_group_wrapper_raises(dev, bad):
    from repro_torch.kernels.codec import ops as qops
    xs, us = _qgroup(dev, [(4, 256)] * 3)
    if bad == "strided":
        xs[1] = torch.zeros(4, 512, device=dev)[:, ::2]
    elif bad == "float64":
        us[1] = us[1].double()
    elif bad == "device":
        us[1] = us[1].cpu()
    else:
        us[1] = us[1][:, :128]
    before = qops.quantize_pack_group.launches
    with pytest.raises(ValueError, match="quantize_pack leaf 1"):
        qops.quantize_pack_group(xs, us, 8)
    assert qops.quantize_pack_group.launches == before


# -- K3: paged flash decode ----------------------------------------------------

def _pcase(dev, b, h, hkv, hd, n_pages, ps, mp, dtype=torch.float32, seed=0):
    """Scattered pages: sequence i owns a random set of physical pages
    (never page 0); entries past its valid length point at the trash page
    0; valid lengths cut mid-page."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    owned = rng.permutation(np.arange(1, n_pages))[:b * mp].reshape(b, mp)
    valid = rng.integers(1, mp * ps + 1, b)
    valid[0] = mp * ps                               # one full table
    pt = np.where(np.arange(mp)[None] * ps < valid[:, None], owned, 0)
    return (q, k, v, torch.as_tensor(pt, dtype=torch.int32, device=dev),
            torch.as_tensor(valid, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("h,hkv,hd", [(4, 4, 64), (4, 2, 64), (8, 1, 32),
                                      (16, 8, 128), (16, 2, 128),
                                      (4, 1, 256), (10, 2, 64), (40, 8, 128),
                                      (12, 2, 128)])
def test_paged_decode_matches_plain(dev, h, hkv, hd):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    q, k, v, pt, valid = _pcase(dev, 3, h, hkv, hd, 40, 16, 6)
    before = fops.paged_decode_attention.launches
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    torch.cuda.synchronize()
    assert fops.paged_decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    torch.testing.assert_close(out, paged_decode_ref(q, k, v, pt, valid),
                               atol=TOL, rtol=0)
    assert torch.equal(out, fops.paged_decode_attention(q, k, v, pt, valid))


def test_paged_decode_bf16(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    q, k, v, pt, valid = _pcase(dev, 4, 16, 8, 128, 64, 16, 8,
                                dtype=torch.bfloat16)
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    assert out.dtype == torch.bfloat16
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    assert float((out.float() - want).abs().max()) < 3e-2


def test_paged_decode_nan_trash_never_leaks(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    q, k, v, pt, valid = _pcase(dev, 3, 4, 2, 64, 40, 16, 6)
    owned = set(pt.unique().tolist())
    unowned = [p for p in range(40) if p not in owned]
    clean = (k.clone(), v.clone())
    for pool in (k, v):
        pool[0] = float("nan")                       # the trash page
        pool[unowned] = float("nan")
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, paged_decode_ref(q, *clean, pt, valid),
                               atol=TOL, rtol=0)


def test_paged_decode_kernel_layout_and_strided_pool(dev):
    # the reference kernel's (Hkv, P, ps, hd) layout with per-head valid
    # lengths, and the model layout read from a layer view of a stacked pool
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (flash_decode_paged_ref,
                                                      paged_decode_ref)
    q, k, v, pt, valid = _pcase(dev, 3, 8, 2, 64, 40, 16, 6)
    qk = q[:, 0].reshape(24, 1, 64)
    kk, vk = k.permute(2, 0, 1, 3).contiguous(), v.permute(2, 0, 1, 3).contiguous()
    vh = (valid.repeat_interleave(8)
          - torch.arange(24, device=dev) % 3).clamp(min=1)
    out = fops.flash_decode_paged(qk, kk, vk, pt, vh.to(torch.int32))
    torch.testing.assert_close(
        out, flash_decode_paged_ref(qk, kk, vk, pt, vh.to(torch.int32)),
        atol=TOL, rtol=0)
    stacked = torch.stack([torch.zeros_like(k), k, torch.zeros_like(k)])
    vstacked = torch.stack([torch.zeros_like(v), v, torch.zeros_like(v)])
    torch.testing.assert_close(
        fops.paged_decode_attention(q, stacked[1], vstacked[1], pt, valid),
        paged_decode_ref(q, k, v, pt, valid), atol=TOL, rtol=0)


def test_paged_decode_valid_zero_gives_zeros(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    q, k, v, pt, valid = _pcase(dev, 2, 4, 2, 64, 20, 16, 4)
    valid[1] = 0
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    assert bool((out[1] == 0).all())


@pytest.mark.parametrize("bad", ["table_int64", "head_dim", "group",
                                 "device"])
def test_paged_decode_wrapper_raises(dev, bad):
    from repro_torch.kernels.flash_decode import ops as fops
    q, k, v, pt, valid = _pcase(dev, 2, 4, 2, 64, 20, 16, 4)
    if bad == "table_int64":
        pt = pt.long()
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "group":
        q = torch.cat([q, q[:, :, :2]], dim=2)       # 6 heads over 2 -> 3
    else:
        valid = valid.cpu()
    with pytest.raises(ValueError, match="paged_decode_attention"):
        fops.paged_decode_attention(q, k, v, pt, valid)


# -- K4: dense flash decode on K3's kernel -------------------------------------

def _dcase(dev, b, s, h, hkv, hd, dtype=torch.float32, seed=0, hi=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device=dev).to(dtype)
    valid = np.random.default_rng(seed).integers(1, (hi or s) + 1, b)
    valid[0] = hi or s
    return q, k, v, torch.as_tensor(valid, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("b,s,h,hkv,hd,blk,window", [
    (2, 512, 4, 4, 64, 128, 0), (3, 512, 4, 2, 64, 256, 0),
    (1, 1024, 8, 1, 32, 128, 0), (4, 256, 2, 2, 128, 64, 0),
    (3, 256, 16, 8, 256, 512, 256),          # a ring: valid beyond the window
    (3, 1000, 16, 8, 128, 256, 0),           # S not a multiple of blk_k
    (8, 1500, 16, 16, 64, 1500, 0),          # whisper's cross cache
    (8, 200, 16, 16, 64, 200, 0)])           # whisper's self cache
def test_dense_decode_matches_plain(dev, b, s, h, hkv, hd, blk, window):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    q, k, v, valid = _dcase(dev, b, s, h, hkv, hd,
                            hi=3 * s if window else None)
    before = fops.paged_decode_attention.launches
    out = fops.decode_attention(q, k, v, valid, window=window, blk_k=blk)
    torch.cuda.synchronize()
    assert fops.paged_decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, valid, window=window, blk_k=blk)
    torch.testing.assert_close(out, want, atol=TOL, rtol=0)
    assert torch.equal(out, fops.decode_attention(q, k, v, valid,
                                                  window=window, blk_k=blk))


def test_dense_decode_reads_whole_blocks_only(dev):
    # positions at or past (S // blk_k) * blk_k are never read: NaN there
    # leaves the output equal to the truncated cache's
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models.attention import decode_attend
    q, k, v, valid = _dcase(dev, 3, 1000, 4, 2, 64)
    clean = fops.decode_attention(q, k[:, :768], v[:, :768], valid,
                                 blk_k=256)
    k[:, 768:] = float("nan")
    v[:, 768:] = float("nan")
    out = fops.decode_attention(q, k, v, valid, blk_k=256)
    assert torch.equal(out, clean)
    torch.testing.assert_close(
        out, decode_attend(q, k[:, :768], v[:, :768], valid.clamp(max=768)),
        atol=TOL, rtol=0)


def test_dense_decode_bf16_and_kernel_layout(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (decode_attention_ref,
                                                      flash_decode_ref)
    q, k, v, valid = _dcase(dev, 4, 640, 16, 8, 128, dtype=torch.bfloat16)
    out = fops.decode_attention(q, k, v, valid)
    assert out.dtype == torch.bfloat16
    want = decode_attention_ref(q.float(), k.float(), v.float(), valid)
    assert float((out.float() - want).abs().max()) < 3e-2
    # the reference kernel's layout, one valid length per query head
    qk = q[:, 0].reshape(64, 1, 128).float()
    kk = k.float().permute(0, 2, 1, 3).reshape(32, 640, 128)
    vk = v.float().permute(0, 2, 1, 3).reshape(32, 640, 128)
    vh = (valid.repeat_interleave(16)
          - torch.arange(64, device=dev) % 7).clamp(min=1).to(torch.int32)
    got = fops.flash_decode(qk, kk, vk, vh, blk_k=128)
    torch.testing.assert_close(got, flash_decode_ref(qk, kk, vk, vh),
                               atol=TOL, rtol=0)


def test_dense_decode_valid_zero_gives_zeros(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    q, k, v, valid = _dcase(dev, 3, 256, 4, 2, 64)
    valid[1] = 0
    assert bool((fops.decode_attention(q, k, v, valid)[1] == 0).all())


# -- K3/K4: the split-KV plan and the combine ----------------------------------

def _force_splits(monkeypatch, fops, n):
    """Every launch of the module with the plan's split count forced to n
    (the private ``_launch``'s keyword; the public wrappers have none)."""
    import functools
    monkeypatch.setattr(fops, "_launch",
                        functools.partial(fops._launch, splits=n))


SPLITS = [  # (h, hkv, hd, dtype, forced splits): n_rep 1, 2 and 8
    (8, 8, 64, torch.float32, 3), (16, 8, 128, torch.float32, 4),
    (8, 1, 128, torch.float32, 5), (4, 2, 32, torch.float32, 2),
    (16, 8, 128, torch.bfloat16, 4), (16, 8, 256, torch.bfloat16, 3),
    (4, 4, 256, torch.float32, 6)]


@pytest.mark.parametrize("h,hkv,hd,dtype,splits", SPLITS)
def test_paged_decode_splits_match_plain(dev, monkeypatch, h, hkv, hd, dtype,
                                         splits):
    """A forced split count > 1 on ragged lengths (1, the full table and
    between; splits wholly past the short ones): fp32 within 2e-5 of the
    plain version and of the plain split-and-combine at the plan's own
    split boundaries, bf16 within 3e-2 of both in fp32 on the same inputs
    and inside ``ref.bf16_error_ratio``'s element-wise bar; one counted
    launch per call; two calls bitwise equal."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (bf16_error_ratio,
                                                      paged_decode_ref,
                                                      split_decode_ref)
    b, mp, ps = 4, 12, 16
    q, k, v, pt, valid = _pcase(dev, b, h, hkv, hd, 80, ps, mp, dtype=dtype,
                                seed=7)
    valid[1] = 1
    pl = fops.plan(b, hkv, h // hkv, mp, ps, hd, dtype, dev, splits)
    assert pl.n_splits > 1 and pl.workspace_bytes > 0
    _force_splits(monkeypatch, fops, splits)
    before = fops.paged_decode_attention.launches
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    torch.cuda.synchronize()
    assert fops.paged_decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    tol = TOL if dtype == torch.float32 else 3e-2
    assert float((out.float() - want).abs().max()) <= tol
    split = split_decode_ref(q.float(), k.float(), v.float(), pt, valid,
                             pl.n_splits, span=pl.span)
    assert float((out.float() - split).abs().max()) <= tol
    if dtype == torch.bfloat16:       # element by element, as chip_smoke
        assert bf16_error_ratio(out, want) <= 1.0
        assert bf16_error_ratio(out, split) <= 1.0
    assert torch.equal(out, fops.paged_decode_attention(q, k, v, pt, valid))


def test_paged_decode_splits_kernel_layout_per_head(dev, monkeypatch):
    """The reference kernel's layout, one valid length per query head (0,
    1 and the full table among them), with splits."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import flash_decode_paged_ref
    q, k, v, pt, valid = _pcase(dev, 3, 8, 2, 64, 40, 16, 6, seed=8)
    qk = q[:, 0].reshape(24, 1, 64)
    kk = k.permute(2, 0, 1, 3).contiguous()
    vk = v.permute(2, 0, 1, 3).contiguous()
    vh = (valid.repeat_interleave(8)
          - torch.arange(24, device=dev) % 3).clamp(min=1).to(torch.int32)
    vh[1], vh[9], vh[2] = 1, 0, 6 * 16
    pt[0] = pt[0].clamp(min=1)        # head 2 reads sequence 0's whole table
    _force_splits(monkeypatch, fops, 3)
    out = fops.flash_decode_paged(qk, kk, vk, pt, vh)
    assert bool((out[9] == 0).all())
    keep = vh > 0
    torch.testing.assert_close(
        out[keep], flash_decode_paged_ref(qk, kk, vk, pt, vh)[keep],
        atol=TOL, rtol=0)


def test_paged_decode_splits_nan_trash_never_leaks(dev, monkeypatch):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    q, k, v, pt, valid = _pcase(dev, 4, 16, 8, 128, 64, 16, 12,
                                dtype=torch.bfloat16, seed=9)
    valid[2] = 1
    pt[2, 1:] = 0
    owned = set(pt.unique().tolist())
    unowned = [p for p in range(64) if p not in owned]
    _force_splits(monkeypatch, fops, 4)
    clean = fops.paged_decode_attention(q, k, v, pt, valid)
    for pool in (k, v):
        pool[0] = float("nan")                       # the trash page
        pool[unowned] = float("nan")
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, clean)


def test_dense_decode_splits_match_plain(dev, monkeypatch):
    """K4 with splits: S not a multiple of blk_k (positions past the last
    whole block NaN, never read), and a ring."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    _force_splits(monkeypatch, fops, 5)
    q, k, v, valid = _dcase(dev, 3, 1000, 16, 8, 128)
    k[:, 768:] = float("nan")
    v[:, 768:] = float("nan")
    out = fops.decode_attention(q, k, v, valid, blk_k=256)
    torch.testing.assert_close(
        out, decode_attention_ref(q, k[:, :768], v[:, :768], valid,
                                  blk_k=256), atol=TOL, rtol=0)
    q, k, v, valid = _dcase(dev, 3, 256, 16, 8, 256, hi=768)
    torch.testing.assert_close(
        fops.decode_attention(q, k, v, valid, window=256, blk_k=512),
        decode_attention_ref(q, k, v, valid, window=256, blk_k=512),
        atol=TOL, rtol=0)


def test_decode_wrappers_do_not_sync(dev):
    """One call of each wrapper, the wrapper's own plan (more than one
    split here), under ``set_sync_debug_mode("error")``: none reads
    ``valid_len`` or anything else back to the host."""
    from repro_torch.kernels.flash_decode import ops as fops
    q, k, v, pt, valid = _pcase(dev, 3, 8, 2, 64, 200, 16, 64)
    assert fops.plan(3, 2, 4, 64, 16, 64, q.dtype, dev).n_splits > 1
    qk = q[:, 0].reshape(24, 1, 64)
    kk = k.permute(2, 0, 1, 3).contiguous()
    vk = v.permute(2, 0, 1, 3).contiguous()
    vh = valid.repeat_interleave(8)
    qd, kd, vd, vd_len = _dcase(dev, 2, 512, 4, 2, 64)
    kd3 = kd.permute(0, 2, 1, 3).reshape(4, 512, 64).contiguous()
    vd3 = vd.permute(0, 2, 1, 3).reshape(4, 512, 64).contiguous()
    qd3, vd3_len = qd[:, 0].reshape(8, 1, 64), vd_len.repeat_interleave(4)
    fops._kernel(64)                     # the first load builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fops.paged_decode_attention(q, k, v, pt, valid)
        fops.flash_decode_paged(qk, kk, vk, pt, vh)
        fops.decode_attention(qd, kd, vd, vd_len, window=256, blk_k=128)
        fops.flash_decode(qd3, kd3, vd3, vd3_len, blk_k=128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_paged_decode_rejects_8_byte_offset(dev):
    """bf16 pools 8 bytes past a 16-byte boundary: the kernel loads 16
    bytes a lane, so the wrapper raises and launches nothing."""
    from repro_torch.kernels.flash_decode import ops as fops
    q, k, v, pt, valid = _pcase(dev, 2, 16, 8, 128, 20, 16, 4,
                                dtype=torch.bfloat16)
    buf_k = torch.zeros(k.numel() + 4, dtype=k.dtype, device=dev)
    buf_v = torch.zeros(v.numel() + 4, dtype=v.dtype, device=dev)
    k8, v8 = buf_k[4:].view(k.shape), buf_v[4:].view(v.shape)
    assert k8.data_ptr() % 16 == 8
    before = fops.paged_decode_attention.launches
    with pytest.raises(ValueError, match="16 bytes"):
        fops.paged_decode_attention(q, k8, v8, pt, valid)
    assert fops.paged_decode_attention.launches == before


# -- K5, K6: flash attention forward and backward -----------------------------

def _acase(dev, b, s, h, hkv, hd, dtype=torch.float32, seed=0, sk=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk or s, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk or s, hkv, hd, generator=gen, device=dev).to(dtype)
    g = torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
    return q, k, v, g


def _grads(fa, q, k, v, g, causal, window):
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o = fa(qs, ks, vs, causal, window, 32, 32)
    return (o.detach(),) + torch.autograd.grad((o * g).sum(), (qs, ks, vs))


ATTN = [  # (b, s, h, hkv, hd, causal, window)
    (2, 160, 4, 2, 64, True, 0),         # ragged last tile, GQA 2:1
    (2, 160, 4, 2, 64, True, 48),
    (1, 256, 8, 1, 32, False, 0),        # MQA
    (1, 128, 4, 4, 128, False, 0),
    (2, 96, 4, 2, 256, True, 32),
    (1, 128, 2, 1, 256, False, 0),
    (1, 512, 2, 1, 256, True, 128),     # the window skips whole tiles
    (2, 160, 4, 4, 80, True, 0),        # head dim 80 (stablelm-3b)
    (1, 256, 4, 2, 80, False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window", ATTN)
def test_flash_attention_matches_plain(dev, dtype, b, s, h, hkv, hd, causal,
                                       window, monkeypatch):
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref,
        rounding_error_ratio)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    q, k, v, g = _acase(dev, b, s, h, hkv, hd, dtype)
    sources, kernel = [], aops._kernel
    monkeypatch.setattr(aops, "_kernel", lambda src: sources.append(src.name)
                        or kernel(src))
    monkeypatch.setattr(aops, "flash_attention_fwd_ref", plain)
    monkeypatch.setattr(aops, "flash_attention_bwd_ref", plain)
    aops.reset_launch_counts()
    o, dq, dk, dv = _grads(aops.flash_attention, q, k, v, g, causal, window)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    # fp32 on the SIMT kernels, bf16 on the tensor-core ones
    assert sources == [aops.SOURCES[dtype].name] * 3
    assert o.dtype == dq.dtype == dk.dtype == dtype
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, causal=causal,
                                             window=window)
    want = (o_ref,) + flash_attention_bwd_ref(qf, kf, vf, o_ref, lse_ref, gf,
                                              causal=causal, window=window)
    _, lse = aops.attention_fwd(q, k, v, causal=causal, window=window)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        err = float((got.float() - ref).abs().max())
        if dtype == torch.float32:
            assert err < (TOL if name == "o" else 5e-4), (name, err)
        else:
            assert err < 3e-2 * max(1.0, float(ref.abs().max())), (name, err)
    torch.testing.assert_close(lse, lse_ref, atol=TOL if dtype ==
                               torch.float32 else 3e-2, rtol=0)
    if dtype == torch.bfloat16:   # element by element, P and dS rounded
        o_emu, lse_emu = flash_attention_fwd_ref(
            qf, kf, vf, causal=causal, window=window, round_to=dtype)
        want = (o_emu.to(dtype),) + flash_attention_bwd_ref(
            q, k, v, o, lse, g, causal=causal, window=window, round_to=dtype)
        for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                  want):
            assert rounding_error_ratio(got, ref) <= 1.0, name
        torch.testing.assert_close(lse, lse_emu, atol=1e-5, rtol=0)
    again = _grads(aops.flash_attention, q, k, v, g, causal, window)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (o, dq, dk, dv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_rows(dev, dtype):
    # non-causal window with Sq > Sk + window - 1: rows with no allowed key
    # get the mean of V, as the dense reference softmax gives
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models.attention import attend_reference
    q, k, v, _ = _acase(dev, 1, 256, 4, 2, 64, dtype=dtype, sk=64)
    o, lse = aops.attention_fwd(q, k, v, causal=False, window=32)
    want = attend_reference(q.float(), k.float(), v.float(), causal=False,
                            window=32)
    torch.testing.assert_close(o.float(), want, rtol=0, atol=TOL if dtype ==
                               torch.float32 else 3e-2)
    assert bool((lse[:, :, 100:] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_layout_and_strided_views(dev, dtype):
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    b, s, h, hkv, hd = 2, 128, 4, 2, 64
    fp32 = dtype == torch.float32

    def close(got, want, grad=False):   # bf16: the bars of the test above
        tol = (5e-4 if grad else TOL) if fp32 else 3e-2 * (
            max(1.0, float(want.abs().max())) if grad else 1.0)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)

    # q, k, v as views of one fused projection (B, S, H + 2 Hkv, hd)
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(b, s, h + 2 * hkv, hd, generator=gen,
                      device=dev).to(dtype)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    qf, kf, vf = q.float(), k.float(), v.float()
    o, lse = aops.attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, causal=True)
    close(o, o_ref)
    # kernel layout (BH, S, hd) against the same launches' plain versions
    qk = q.permute(0, 2, 1, 3).reshape(b * h, s, hd)
    kk = k.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
    vk = v.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
    ok_, lk = aops.flash_attention_fwd(qk, kk, vk, causal=True, window=64)
    om, lm = flash_attention_fwd_ref(qf, kf, vf, causal=True, window=64)
    close(ok_, om.permute(0, 2, 1, 3).reshape(b * h, s, hd))
    close(lk, lm.reshape(b * h, s))
    do = torch.randn(b * h, s, hd, generator=gen, device=dev).to(dtype)
    dq, dk, dv = aops.flash_attention_bwd(qk, kk, vk, ok_, lk, do,
                                          causal=True, window=64)
    dom = do.float().reshape(b, h, s, hd).permute(0, 2, 1, 3)
    want = flash_attention_bwd_ref(qf, kf, vf, om, lm, dom, causal=True,
                                   window=64)
    close(dq, want[0].permute(0, 2, 1, 3).reshape(b * h, s, hd), grad=True)
    for got, ref in zip((dk, dv), want[1:]):
        close(got, ref.permute(0, 2, 1, 3).reshape(b * hkv, s, hd),
              grad=True)


BWD_FP32 = [  # (b, sq, sk, h, hkv, causal, window)
    (2, 200, 200, 4, 2, True, 0),        # ragged last tile, interior tiles
    (1, 320, 320, 4, 1, True, 96),       # the window's edge, skipped tiles
    (1, 192, 130, 2, 2, False, 48),      # Sq != Sk, rows with no key
    (1, 136, 264, 4, 2, False, 0)]       # Sq < Sk, every tile full width


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("b,sq,sk,h,hkv,causal,window", BWD_FP32)
def test_flash_attention_fp32_backward_tiles(dev, hd, b, sq, sk, h, hkv,
                                             causal, window):
    """K6 in fp32 where its heavy-first tile order, the branch-free path
    of interior tiles, masked diagonal and window-edge tiles and ragged
    last tiles meet (lengths not a multiple of 64): o and lse within 2e-5
    of the plain forward, dq, dk, dv within 5e-4 of the plain backward;
    two backward calls bitwise equal."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    q, k, v, g = _acase(dev, b, sq, h, hkv, hd, sk=sk, seed=hd + sq)
    o, lse = aops.attention_fwd(q, k, v, causal=causal, window=window)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(o, o_ref, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=0)
    aops.reset_launch_counts()
    got = aops.attention_bwd(q, k, v, o, lse, g, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 0, "dq": 1, "dkv": 1}
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, g, causal=causal,
                                   window=window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = float((x - y).abs().max())
        assert err < 5e-4, (name, err)
    again = aops.attention_bwd(q, k, v, o, lse, g, causal=causal,
                               window=window)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


FWD_FP32 = [  # (b, sq, sk, h, hkv, causal, window)
    (2, 300, 300, 4, 2, True, 0),        # diagonal, interior, ragged tiles
    (1, 600, 600, 4, 1, True, 200),      # the window's edge, skipped tiles
    (1, 300, 170, 2, 2, False, 60),      # Sq != Sk, rows with no key
    (1, 136, 600, 4, 2, False, 0),       # Sq < Sk, a ragged last key tile
    (1, 257, 257, 2, 1, False, 0)]       # one row past a tile


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("b,sq,sk,h,hkv,causal,window", FWD_FP32)
def test_flash_attention_fp32_forward_tiles(dev, hd, b, sq, sk, h, hkv,
                                            causal, window):
    """K5 in fp32 at its tiles (128 x 128 up to head dim 128, 64 x 128 at
    256) where its heavy-first order, interior tiles without masks,
    masked diagonal and window-edge tiles and ragged ends meet: o and lse
    within 2e-5 of the plain forward, rows with no allowed key the mean of
    V with lse -1e30, one launch, two launches bitwise equal."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
    q, k, v, _ = _acase(dev, b, sq, h, hkv, hd, sk=sk, seed=hd + sq)
    aops.reset_launch_counts()
    o, lse = aops.attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 0, "dkv": 0}
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=causal,
                                             window=window)
    torch.testing.assert_close(o, o_ref, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=TOL, rtol=0)
    if window > 0 and sq > sk + window - 1:
        none = slice(sk + window - 1, sq)
        assert bool((lse[:, :, none] == -1e30).all())
        mean = v.mean(1).repeat_interleave(h // hkv, dim=1)   # (B, H, hd)
        torch.testing.assert_close(o[:, none], mean[:, None].expand_as(
            o[:, none]), atol=TOL, rtol=0)
    again = aops.attention_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)


def test_dense_round_is_bitwise_repeatable(dev):
    """The paper's hub round (VGG16 at full width) built twice from the
    same seed: two rounds each give bitwise equal parameters, selections
    and bill (cuDNN's deterministic algorithms, common/device.py)."""
    from repro_torch import paper_round
    runs = []
    for _ in range(2):
        fed = paper_round.build(dev)
        fed.fit(2)
        runs.append(fed)
    a, b = runs
    assert all(torch.equal(a.params[p], b.params[p]) for p in a.params)
    assert all(np.array_equal(x, y) for x, y in
               zip(a.server.sel_history, b.server.sel_history))
    assert a.comm_summary() == b.comm_summary()


@pytest.mark.parametrize("task", ["imdb", "casa"])
def test_paper_task_round_is_bitwise_repeatable(dev, task):
    """IMDB and CASA (the LSTM on cuDNN, the embedding's backward) built
    twice from the same seed: two rounds each give bitwise equal
    parameters, selections and bill, with one K1 launch a round."""
    from repro_torch import paper_tasks
    runs = []
    for _ in range(2):
        fed = paper_tasks.build(task, dev, evaluate=False)
        before = ops.masked_agg.launches
        fed.fit(2)
        torch.cuda.synchronize()
        assert ops.masked_agg.launches == before + 2
        runs.append(fed)
    a, b = runs
    assert all(torch.equal(a.params[p], b.params[p]) for p in a.params)
    assert all(np.array_equal(x, y) for x, y in
               zip(a.server.sel_history, b.server.sel_history))
    assert a.comm_summary() == b.comm_summary()


@pytest.mark.parametrize("strategy,topology", [
    ("score_weighted", "hub"), ("depth_dropout", "hub"),
    ("successive", "hub"), ("score_weighted", "hierarchical")])
def test_scored_round_launches_k1_once_a_round(dev, strategy, topology):
    """The paper's round (VGG16 at full width) under a scored strategy:
    one K1 launch a round on the hub and the hierarchical combine, the
    telemetry exact zero on frozen units, the state's counts the active
    selections' column sums."""
    from repro_torch import paper_round
    kw = {"n_edges": 2} if topology == "hierarchical" else {}
    fed = paper_round.build(dev, strategy=strategy, topology=topology, **kw)
    seen = []

    class Keep:
        def on_round_start(self, server, r, weights):
            return None

        def on_round_end(self, server, record, metrics):
            seen.append((metrics["sel"], metrics["unit_sqnorm"].cpu()))

        def on_fit_end(self, server, history):
            pass

    fed.server.add_hook(Keep())
    before = ops.masked_agg.launches
    fed.fit(2)
    torch.cuda.synchronize()
    assert ops.masked_agg.launches == before + 2
    counts = sum(sel.sum(0) for sel, _ in seen)
    assert torch.equal(fed.server.sel_state.counts, counts)
    for sel, sq in seen:
        assert bool((sq[sel == 0] == 0).all()) and bool((sq[sel > 0] > 0)
                                                        .all())


@pytest.mark.parametrize("kw", [{"strategy": "score_weighted"},
                                {"packed": True, "codec": "qint8"},
                                {"packed": True, "codec": "topk_ef"},
                                {"topology": "gossip"}],
                         ids=["scored", "qint8", "topk_ef", "gossip"])
def test_kill_resume_is_bitwise_on_card(dev, tmp_path, kw):
    """VGG16 at full width: 4 rounds straight against 2, save, a new
    Federation restored, 2 more: bitwise equal state, selection state,
    codec state, selections and bill."""
    from repro_torch import paper_round
    full = paper_round.build(dev, **kw)
    full.fit(4)
    half = paper_round.build(dev, **kw)
    half.fit(2)
    path = str(tmp_path / "ck")
    half.save(path)
    resumed = paper_round.build(dev, **kw)
    resumed.restore(path)
    resumed.fit(2)
    torch.cuda.synchronize()
    a, b = full.server, resumed.server
    assert all(torch.equal(a.params[p], b.params[p]) for p in a.params)
    if a.sel_state is not None:
        assert all(torch.equal(x, y) for x, y in zip(a.sel_state,
                                                     b.sel_state))
    if a.codec_state is not None:
        assert all(torch.equal(a.codec_state[p], b.codec_state[p])
                   for p in a.codec_state)
    assert all(np.array_equal(x, y) for x, y in
               zip(a.sel_history, b.sel_history))
    assert full.comm_summary() == resumed.comm_summary()


def test_kernel_two_edge_planes_match_plain(dev):
    """K1 as the hierarchical hub combine: E = 2 planes of edge means,
    their weight mass as the selection and unit edge weights."""
    g, d, sel, _, ru = _case(dev, 1293, 2, 2048)
    w = torch.ones(2, device=dev)
    before = ops.masked_agg.launches
    out = ops.masked_agg(g, d, sel, w, ru)
    torch.cuda.synchronize()
    assert ops.masked_agg.launches == before + 1
    torch.testing.assert_close(out, masked_agg_ref(g, d, sel, w, ru),
                               atol=TOL, rtol=TOL)
    assert torch.equal(out[ru == 1], g[ru == 1])


def test_fused_rounds_read_global_tiles_in_place_on_card(dev):
    """Two fused aggregates on the card: the second reads the first's
    output buffer in place, bitwise the packing path's result, and the
    first's params stay as they were."""
    from repro_torch.core.masking import build_units_flat
    from repro_torch.models import paper_models as pm
    params = {k: v.to(dev) for k, v in pm.init_vgg16(
        torch.Generator().manual_seed(0), width_mult=0.25).items()}
    assign = build_units_flat(params, pm.vgg16_units(params))
    plan = ops.build_agg_plan(assign, params)
    rng = np.random.default_rng(1)
    sel = torch.as_tensor(rng.integers(0, 2, (5, 14)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 5), dtype=torch.float32)
    d_t = ops.new_tile_buffer(plan, (5,), device=dev).normal_()
    first = ops.masked_combine_packed(params, d_t, sel, w, plan)
    assert ops.tile_source(plan, first) is not None
    keep = {p: x.clone() for p, x in first.items()}
    second = ops.masked_combine_packed(first, d_t, sel, w, plan)
    packed = ops.masked_combine_packed(keep, d_t, sel, w, plan)
    assert ops.tile_source(plan, keep) is None
    for p in params:
        assert torch.equal(second[p], packed[p]), p
        assert torch.equal(first[p], keep[p]), p


def test_hierarchical_fused_aggregate_matches_plain(dev):
    """The two-stage aggregate through K1 against the plain
    ``hierarchical_masked_fedavg`` on CASA's leaves, 10 clients in 2
    edges, a zero-weight client and a unit nobody trained."""
    from repro_torch.core import build_units_flat
    from repro_torch.core.aggregation import hierarchical_masked_fedavg
    from repro_torch.core.comm import edge_membership
    from repro_torch.core.topology import _fused_hier_aggregate
    from repro_torch.models import paper_models as pm
    params = {p: x.to(dev) for p, x in
              pm.init_casa(torch.Generator().manual_seed(0)).items()}
    assign = build_units_flat(params, pm.casa_units(params))
    rng = np.random.default_rng(0)
    sel = torch.as_tensor(rng.integers(0, 2, (10, 6)), dtype=torch.float32)
    sel[:, 2] = 0.0
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 10), dtype=torch.float32)
    w[3] = 0.0
    gen = torch.Generator(device=dev).manual_seed(1)
    deltas = {p: torch.randn((10,) + tuple(x.shape), generator=gen,
                             device=dev) for p, x in params.items()}
    mem = torch.as_tensor(edge_membership(10, 2))
    before = ops.masked_agg.launches
    fused = _fused_hier_aggregate(assign, mem)(params, deltas, sel, w)
    assert ops.masked_agg.launches == before + 1
    plain = hierarchical_masked_fedavg(params, deltas, sel, w, assign, mem)
    for p in params:
        torch.testing.assert_close(fused[p], plain[p], atol=TOL, rtol=TOL)
    assert torch.equal(fused["dense1/w"], params["dense1/w"])


@pytest.mark.parametrize("bad", ["head_dim", "misaligned", "device",
                                 "blocks"])
def test_flash_attention_wrapper_raises(dev, bad):
    from repro_torch.kernels.flash_attention import ops as aops
    q, k, v, _ = _acase(dev, 1, 64, 2, 1, 64)
    if bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "misaligned":
        q = torch.zeros(64 * 2 * 64 + 1, device=dev)[1:].view(1, 64, 2, 64)
    elif bad == "device":
        v = v.cpu()
    with pytest.raises(ValueError):
        if bad == "blocks":
            aops.flash_attention(q, k, v, True, 0, 48, 48)
        else:
            aops.attention_fwd(q, k, v)


# -- K7: the chunked RWKV-6 WKV scan -------------------------------------------

def _wcase(dev, shape, dk, dv, dtype=torch.float32, seed=0, decay=None):
    """r, k, v ~ N(0, 1), log_decay = -|N(0, 1)| (or ``decay``),
    u ~ 0.1 N(0, 1); ``shape`` is (BH, S) or (B, S, H)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(last):
        return torch.randn(*shape, last, generator=gen, device=dev)

    r, k, v = randn(dk), randn(dk), randn(dv)
    ld = -randn(dk).abs() if decay is None else torch.full(
        (*shape, dk), decay, device=dev)
    u_rows = shape[0] if len(shape) == 2 else shape[2]
    u = 0.1 * torch.randn(u_rows, dk, generator=gen, device=dev)
    return tuple(x.to(dtype) for x in (r, k, v, ld, u))


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (4, 127, 64, 64, 1), (3, 145, 64, 64, 5), (2, 60, 32, 48, 15),
    (6, 128, 64, 64, 16), (2, 128, 16, 40, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_matches_plain(dev, bh, s, dk, dv, chunk, dtype):
    """fp32: within 1e-4 of the plain chunked version (the reference's
    kernel-vs-substrate bar).  bf16: held to the fp32 plain version on the
    same bf16-rounded inputs, 1e-2 x max|o| on o (o is rounded to bf16)
    and 1e-4 on the fp32 state."""
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_chunked_ref
    r, k, v, ld, u = _wcase(dev, (bh, s), dk, dv, dtype)
    before = wops.rwkv6_scan.launches
    o, st = wops.rwkv6_scan(r, k, v, ld, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wops.rwkv6_scan.launches == before + 1
    assert o.dtype == dtype and st.dtype == torch.float32
    want_o, want_st = rwkv6_scan_chunked_ref(
        *(x.float() for x in (r, k, v, ld, u)), chunk=chunk)
    tol_o = 1e-4 if dtype == torch.float32 else \
        1e-2 * float(want_o.abs().max())
    torch.testing.assert_close(o.float(), want_o, atol=tol_o, rtol=0)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=0)
    again = wops.rwkv6_scan(r, k, v, ld, u, chunk=chunk)
    assert torch.equal(again[0], o) and torch.equal(again[1], st)


def _k7_close(o, st, want_o, want_st, dtype):
    """The K7 bars: fp32 1e-4 on o and state; bf16 o 1e-2 x max|o| and
    element by element at ``ref.bf16_error_ratio``, the state 1e-4."""
    from repro_torch.kernels.rwkv6_scan.ref import bf16_error_ratio
    tol_o = 1e-4 if dtype == torch.float32 else \
        1e-2 * float(want_o.abs().max())
    torch.testing.assert_close(o.float(), want_o, atol=tol_o, rtol=0)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=0)
    if dtype == torch.bfloat16:
        assert bf16_error_ratio(o, want_o) <= 1.0


@pytest.mark.parametrize("bh,s,chunk", [(1, 4096, 16), (2, 4095, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_plan_segments_match_plain(dev, bh, s, chunk, dtype):
    """Few rows of a long sequence: the plan itself cuts each row into
    several segments (three launches, one counted call), held to the
    plain chunked version and to the plain segmented version at the
    plan's own segments; two calls bitwise equal."""
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import (
        rwkv6_scan_chunked_ref, rwkv6_scan_segmented_ref)
    r, k, v, ld, u = _wcase(dev, (bh, s), 64, 64, dtype, seed=s)
    pl = wops.plan(bh, s, chunk, 64, dev)
    assert pl.n_seg > 1 and pl.kernels == 3 and pl.seg_len % chunk == 0
    before = wops.rwkv6_scan.launches
    o, st = wops.rwkv6_scan(r, k, v, ld, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wops.rwkv6_scan.launches == before + 1
    f32 = [x.float() for x in (r, k, v, ld, u)]
    _k7_close(o, st, *rwkv6_scan_chunked_ref(*f32, chunk=chunk), dtype)
    _k7_close(o, st, *rwkv6_scan_segmented_ref(*f32, chunk=chunk,
                                               segment=pl.seg_len), dtype)
    again = wops.rwkv6_scan(r, k, v, ld, u, chunk=chunk)
    assert torch.equal(again[0], o) and torch.equal(again[1], st)


@pytest.mark.parametrize("segments,b,s,chunk,dv", [
    (2, 2, 128, 16, 64), (3, 1, 145, 5, 64), (5, 2, 127, 1, 32),
    (4, 1, 96, 8, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_forced_segments_match_plain(dev, monkeypatch, segments, b, s,
                                         chunk, dv, dtype):
    """``wkv`` in the model layout with the segment count forced small
    (the private ``_launch``'s keyword), odd chunks and a second column
    tile included: within the K7 bars of the plain chunked version."""
    import functools
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_chunked_ref
    assert wops.plan(b * 3, s, chunk, dv, dev, segments).n_seg > 1
    monkeypatch.setattr(wops, "_launch",
                        functools.partial(wops._launch, segments=segments))
    r, k, v, ld, u = _wcase(dev, (b, s, 3), 64, dv, dtype, seed=segments)
    o, st = wops.wkv(r, k, v, ld, u, chunk=chunk)

    def fold(x):
        return x.transpose(1, 2).reshape(b * 3, s, -1).float()

    want_o, want_st = rwkv6_scan_chunked_ref(
        fold(r), fold(k), fold(v), fold(ld), u.float().repeat(b, 1),
        chunk=chunk)
    _k7_close(fold(o), st.reshape(b * 3, 64, dv), want_o, want_st, dtype)
    again = wops.wkv(r, k, v, ld, u, chunk=chunk)
    assert torch.equal(again[0], o) and torch.equal(again[1], st)


def test_wkv_model_layout_matches_oracle(dev):
    """wkv in the model layout (strided, no fold copy), bf16 r/k/v with an
    fp32 log-decay as a bf16 model passes them; the fp32 case within
    1e-3 of the per-token oracle."""
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    b, s, h, dk = 2, 96, 3, 64
    r, k, v, ld, u = _wcase(dev, (b, s, h), dk, dk)
    o, st = wops.wkv(r, k, v, ld, u, chunk=16)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, -1)

    want_o, want_st = rwkv6_scan_ref(fold(r), fold(k), fold(v), fold(ld),
                                     u.repeat(b, 1))
    torch.testing.assert_close(fold(o), want_o, atol=1e-3, rtol=0)
    torch.testing.assert_close(st.reshape(b * h, dk, dk), want_st, atol=1e-3,
                               rtol=0)
    ob, stb = wops.wkv(r.bfloat16(), k.bfloat16(), v.bfloat16(), ld, u,
                       chunk=16)
    assert ob.dtype == torch.bfloat16
    o32, st32 = wops.wkv(r.bfloat16().float(), k.bfloat16().float(),
                         v.bfloat16().float(), ld, u, chunk=16)
    torch.testing.assert_close(ob.float(), o32,
                               atol=1e-2 * float(o32.abs().max()), rtol=0)
    torch.testing.assert_close(stb, st32, atol=1e-4, rtol=0)


def test_rwkv6_scan_strong_decay_finite(dev):
    from repro_torch.kernels.rwkv6_scan import ops as wops
    r, k, v, ld, u = _wcase(dev, (2, 64), 64, 64, decay=-50.0)
    o, st = wops.rwkv6_scan(r, k, v, ld, u, chunk=16)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st).all())


def test_rwkv6_scan_never_runs_plain_on_card(dev, monkeypatch):
    from repro_torch.kernels.rwkv6_scan import ops as wops

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(wops, "rwkv6_scan_chunked_ref", plain)
    r, k, v, ld, u = _wcase(dev, (2, 32, 2), 64, 64)
    wops.wkv(r, k, v, ld, u)
    wops.rwkv6_scan(*_wcase(dev, (2, 32), 64, 64))
    torch.cuda.synchronize()


@pytest.mark.parametrize("bad", ["chunk", "divides", "dk", "device",
                                 "grad", "misaligned"])
def test_rwkv6_scan_wrapper_raises(dev, bad):
    from repro_torch.kernels.rwkv6_scan import ops as wops
    r, k, v, ld, u = _wcase(dev, (2, 64), 64, 64)
    chunk = 16
    if bad == "misaligned":          # rows 4 bytes past a 16-byte boundary
        r = torch.zeros(r.numel() + 1, device=dev)[1:].view(r.shape)
    elif bad == "chunk":
        chunk = 64
    elif bad == "divides":
        chunk = 24
    elif bad == "dk":
        r, k, v, ld, u = _wcase(dev, (2, 64), 128, 64)
    elif bad == "device":
        u = u.cpu()
    else:
        r.requires_grad_()
    with pytest.raises(RuntimeError if bad == "grad" else ValueError):
        wops.rwkv6_scan(r, k, v, ld, u, chunk=chunk)


def test_rwkv6_prefill_runs_k7_on_card(dev):
    """The reduced model's prefill launches K7 once per layer and agrees
    with forward (plain chunked_linear_scan) on the last position."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.models import get_model
    cfg = get_config("rwkv6-3b").reduced()
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    for name in ("u", "decay_base", "ln_b"):     # zeros at init
        leaf = params[f"blocks/sub0/wkv/{name}"]
        leaf.copy_(0.5 * torch.randn(leaf.shape, generator=gen, device=dev))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 45)), device=dev)
    with torch.no_grad():
        wops.reset_launch_counts()
        logits, cache = model.prefill(params, tokens, max_len=64,
                                      last_only=True)
        assert wops.rwkv6_scan.launches == cfg.n_layers
        full, _, _ = model.forward(params, tokens)
    torch.testing.assert_close(logits[:, -1], full[:, -1], atol=1e-4, rtol=0)
    assert cache["subs/sub0/wkv"].dtype == torch.float32


# -- the round engines on the card (toy MLP, K2 under qint8) --------------------

def _engine_setup(dev):
    import functools
    from repro_torch.models import toy
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=4, d=16,
                         hidden=32, out=4)
    b = toy.toy_batches(torch.Generator().manual_seed(1), n_clients=8,
                        steps=2, batch=4, d=16, out=4)
    return (p, toy.toy_units(p), {k: v.to(dev) for k, v in b.items()},
            functools.partial(toy.toy_loss, device=dev))


def test_async_zero_staleness_flush_is_sync_round_on_card(dev):
    """One grouped K2 launch per dispatch; a zero-staleness flush (buffer
    = C) bitwise the synchronous packed qint8 round."""
    from repro_torch.core import FLConfig, Federation, Server, build_round_step
    from repro_torch.kernels.codec import ops as qops
    p, assign, b, loss = _engine_setup(dev)
    b4 = {k: v[:4] for k, v in b.items()}
    kw = dict(n_clients=4, train_fraction=0.5, packed=True, codec="qint8")
    sync_fl = FLConfig(**kw)
    srv = Server(build_round_step(loss, assign, sync_fl, device=dev), assign,
                 sync_fl, p, seed=11, device=dev)
    srv.run_round(b4)
    fed = Federation(loss_fn=loss, params=p, assign=assign, seed=11,
                     fl=FLConfig(async_buffer=4, client_delay_dist="none",
                                 **kw), device=dev)
    qops.reset_launch_counts()
    fed.server.run(3, lambda w: b4)
    torch.cuda.synchronize()
    assert qops.quantize_pack_group.launches == \
        fed.server.async_engine._codec_dispatch > 1
    fed1 = Federation(loss_fn=loss, params=p, assign=assign, seed=11,
                      fl=FLConfig(async_buffer=4, client_delay_dist="none",
                                  **kw), device=dev)
    fed1.server.run(1, lambda w: b4)
    assert all(torch.equal(srv.params[k], fed1.params[k]) for k in p)


def test_cohort_chunkings_bitwise_on_card(dev):
    """Chunks of 1, 2 and 4 of a cohort of 4 out of 8 registered clients
    under qint8: one K2 launch a chunk, bitwise the same run."""
    from repro_torch.core import FLConfig, Federation
    from repro_torch.kernels.codec import ops as qops
    p, assign, b, loss = _engine_setup(dev)
    runs = []
    for chunk in (4, 2, 1):
        fed = Federation(loss_fn=loss, params=p, assign=assign, seed=3,
                         device=dev, fl=FLConfig(
                             n_clients=4, train_fraction=0.5, packed=True,
                             codec="qint8", n_registered=8,
                             cohort_chunk=chunk, faults="crash:0.2"))
        qops.reset_launch_counts()
        hist = fed.server.run(2, lambda r, ids: {
            k: v[torch.as_tensor(np.asarray(ids), device=dev)]
            for k, v in b.items()})
        torch.cuda.synchronize()
        assert qops.quantize_pack_group.launches == \
            sum(4 // chunk for r in hist if not r.skipped)
        runs.append(fed)
    for other in runs[1:]:
        assert all(torch.equal(runs[0].params[k], other.params[k]) for k in p)


# -- attend's chunked / windowed branches on K5/K6 ------------------------------


def _attend_case(dev, s, seed, h=4, hkv=2, hd=64):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, g = (torch.randn(1, s, h, hd, generator=gen, device=dev)
            for _ in range(2))
    k, v = (torch.randn(1, s, hkv, hd, generator=gen, device=dev)
            for _ in range(2))
    return q, k, v, g


def _attend_grads(fn, q, k, v, g):
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o = fn(qs, ks, vs)
    return (o.detach(),) + torch.autograd.grad((o * g).sum(), (qs, ks, vs))


@pytest.mark.parametrize("s,window,plain", [
    (1024, 0, "chunked"), (1000, 0, "chunked"), (1024, 256, "windowed"),
    (1000, 256, "windowed")])
def test_attend_routes_through_flash_attention(dev, s, window, plain):
    """``attend`` on CUDA tensors launches K5 once and K6's two kernels
    once per forward + backward, S=1,000 padded to 1,024 at the end; it
    matches the plain chunked / windowed version (run on the card's
    tensors moved to the CPU) at 2e-5 (o) and 5e-4 (gradients)."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models import attention as A
    q, k, v, g = _attend_case(dev, s, s + window)
    aops.reset_launch_counts()
    got = _attend_grads(lambda q, k, v: A.attend(
        q, k, v, impl="chunked", window=window, q_chunk=256), q, k, v, g)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    fn = (lambda q, k, v: A.attend_windowed(q, k, v, window=window,
                                            q_chunk=256)) \
        if plain == "windowed" else \
        (lambda q, k, v: A.attend_chunked(q, k, v, q_chunk=256,
                                          kv_chunk=256))
    want = _attend_grads(fn, *(x.cpu() for x in (q, k, v, g)))
    for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
        tol = TOL if name == "o" else 5e-4
        err = float((x.cpu() - y).abs().max())
        assert err <= tol, (name, err)


def test_flash_attention_takes_size_one_dims_of_any_stride(dev):
    """A batch of 1 whose gradient has batch stride 1 (what the model's
    output projection hands back) launches and matches the same call
    on contiguous tensors bitwise."""
    from repro_torch.kernels.flash_attention import ops as aops
    q, k, v, g = _attend_case(dev, 256, 3)
    o, lse = aops.attention_fwd(q, k, v)
    odd = g.as_strided(g.shape, (1,) + g.stride()[1:])
    want = aops.attention_bwd(q, k, v, o, lse, g)
    got = aops.attention_bwd(q, k, v, o, lse, odd)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_apply_moe_matches_cpu_and_backward_is_bitwise(dev):
    """``apply_moe`` at one granite-moe-1b-a400m layer's width (T = 1,024
    tokens, d 1,024, 32 experts of 512, top 8, capacity factor 1.25) on the
    card against the CPU: the output and aux at 2e-5, each gradient at
    2e-5 x max(1, its largest entry) (the router's reaches ~180: fp32 sums
    of ~1,000 terms in another order differ by ~1e-4 there, against
    float64), the same kept copies and the same dropped count; two
    backward passes on the card bitwise equal (the dispatch gathers, and
    its backward sums each token's copies in a fixed order: no
    atomics).  Routing is decisive by construction, as in
    ``tests/test_torch_moe.py``: the first 32 coordinates of each token
    hold a permutation of 32 codes 0.1 apart (half the tokens rank expert
    0 first, so that its 320 slots overflow) and the router reads expert
    e's code alone at 5; the least gap between a token's 8th and 9th
    router probability must be at least 100 x the tolerance, so that a
    routing flip fails loudly."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    mcfg = get_config("granite-moe-1b-a400m").moe
    e, t, d = mcfg.num_experts, 1024, 1024
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, d, mcfg, torch.float32)
    x = torch.randn(1, t, d, generator=gen)
    g = torch.randn(1, t, d, generator=gen)
    perm = torch.rand(t, e, generator=gen).argsort(-1)   # expert j: perm[j]
    skew = torch.rand(t, generator=gen) < 0.5
    top = (perm == e - 1).float().argmax(-1)
    first = perm[:, 0].clone()
    perm[skew, 0] = e - 1
    perm[skew, top[skew]] = first[skew]
    x[0, :, :e] = (perm - (e - 1) / 2) * 0.1
    p["router"] = torch.zeros(d, e)
    p["router"][torch.arange(e), torch.arange(e)] = 5.0

    def run(device):
        pp = {n: v.to(device).requires_grad_(True) for n, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        moe.reset_dropped()
        with moe.trace_routing() as trace:
            y, aux = moe.apply_moe(pp, xx, mcfg)
        dropped = moe.dropped_copies()
        grads = torch.autograd.grad((y * g.to(device)).sum() + aux,
                                    [xx, *pp.values()])
        return y, aux, grads, trace[0], dropped

    y, aux, grads, rec, dropped = run(dev)
    y2, aux2, grads2, _, _ = run(dev)
    cy, caux, cgrads, crec, cdropped = run("cpu")
    gap = float(crec["gap"].min())
    assert gap >= 100 * TOL, f"routing gap {gap} < 100 x {TOL}: a near tie"
    assert cdropped > 0
    assert torch.equal(rec["keep"].cpu(), crec["keep"]) and \
        dropped == cdropped
    torch.testing.assert_close(y.cpu(), cy, atol=TOL, rtol=0)
    torch.testing.assert_close(aux.cpu(), caux, atol=TOL, rtol=0)
    for name, a, b in zip(["x", *p], grads, cgrads):
        tol = TOL * max(1.0, float(b.abs().max()))
        err = float((a.cpu() - b).abs().max())
        assert err <= tol, (name, err, tol)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


# -- head dim 80 (stablelm-3b) and the padded non-causal route (whisper) -----

@pytest.mark.parametrize("splits", [None, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_head_dim_80(dev, dtype, splits, monkeypatch):
    """K3 at stablelm-3b's heads, 32 over 32 of 80 (a row on 32 fp32 / 16
    bf16 lanes, the last 12 / 6 holding zeros), at the plan's splits and
    at 1 and 4, against the plain version."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    q, k, v, pt, valid = _pcase(dev, 4, 32, 32, 80, 80, 16, 12, dtype=dtype)
    if splits is not None:
        _force_splits(monkeypatch, fops, splits)
    before = fops.paged_decode_attention.launches
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    torch.cuda.synchronize()
    assert fops.paged_decode_attention.launches == before + 1
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    err = float((out.float() - want).abs().max())
    assert err < (TOL if dtype == torch.float32 else 3e-2), err


def test_flash_attention_head_dim_80_at_stablelm_width(dev):
    """K5/K6 at head dim 80, 32 over 32 heads, S = 1,024 causal, fp32 and
    bf16 (the existing bars: fp32 2e-5 / 5e-4, bf16 3e-2 of the fp32
    plain version); every stored column is finite and columns past 80
    are never written (the outputs are (..., 80))."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = _acase(dev, 1, 1024, 32, 32, 80, dtype)
        aops.reset_launch_counts()
        o, dq, dk, dv = _grads(aops.flash_attention, q, k, v, g, True, 0)
        torch.cuda.synchronize()
        assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
        qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
        o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf)
        want = (o_ref,) + flash_attention_bwd_ref(qf, kf, vf, o_ref, lse_ref,
                                                  gf)
        for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                  want):
            err = float((got.float() - ref).abs().max())
            if dtype == torch.float32:
                assert err < (TOL if name == "o" else 5e-4), (name, err)
            else:
                assert err < 3e-2 * max(1.0, float(ref.abs().max())), \
                    (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(1500, 1500), (4096, 1500)])
def test_noncausal_padded_route_on_card(dev, dtype, sq, sk):
    """``attention.pad_noncausal`` (q, k, v padded to whole blocks, the
    keys past Sk masked by ``kv_len``, the output sliced back) at
    whisper's shapes, 16 heads of 64: one launch of each kernel, against
    the plain dense attention on the unpadded inputs; the padded rows of
    dK/dV the kernels write are zero."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    from repro_torch.models import attention as A
    q, _, _, g = _acase(dev, 1, sq, 16, 16, 64, dtype)
    _, k, v, _ = _acase(dev, 1, sk, 16, 16, 64, dtype, seed=1)
    aops.reset_launch_counts()
    got = _attend_grads(A.pad_noncausal, q, k, v, g)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, causal=False)
    want = (o_ref,) + flash_attention_bwd_ref(qf, kf, vf, o_ref, lse_ref, gf,
                                              causal=False)
    for name, x, ref in zip(("o", "dq", "dk", "dv"), got, want):
        assert x.shape == ref.shape, name
        err = float((x.float() - ref).abs().max())
        if dtype == torch.float32:
            assert err < (TOL if name == "o" else 5e-4), (name, err)
        else:
            assert err < 3e-2 * max(1.0, float(ref.abs().max())), (name, err)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, -sk % 128))
    o, lse = aops.attention_fwd(q, kp, kp, causal=False, kv_len=sk)
    _, dk, dv = aops.attention_bwd(q, kp, kp, o, lse, g, causal=False,
                                   kv_len=sk)
    assert not dk[:, sk:].any() and not dv[:, sk:].any()


def test_whisper_decode_step_runs_k4(dev):
    """Reduced whisper's ``decode_step`` on the card launches K4 twice a
    layer (self and cross) and matches the same step on the CPU
    (``decode_attend``) at 1e-4."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models import get_model
    cfg = get_config("whisper-medium").reduced().replace(enc_seq=300)
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (3, 9), generator=gen)
    frames = torch.randn(3, cfg.enc_seq, cfg.d_model, generator=gen)
    out = {}
    for where in ("cpu", dev):
        p = {k: x.to(where) for k, x in params.items()}
        _, cache = model.prefill(p, toks.to(where), frames=frames.to(where),
                                 max_len=24)
        fops.reset_launch_counts()
        logits, _ = model.decode_step(p, cache, toks[:, -1:].to(where))
        out[str(where)] = (logits.cpu(), fops.paged_decode_attention.launches)
    assert out[str(dev)][1] == 2 * cfg.n_layers and out["cpu"][1] == 0
    torch.testing.assert_close(out[str(dev)][0], out["cpu"][0], atol=1e-4,
                               rtol=0)


# -- head dim 256 (gemma3-12b), internvl2-26b's bf16 attention at a GQA group
#    of 6, and every registered config's attention shape ----------------------

@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_head_dim_256(dev, dtype, ring, splits, monkeypatch):
    """K3 at gemma3-12b's heads, 16 over 8 of 256 (a GQA group of 2; an
    fp32 row of 64 chunks on 32 lanes, two a lane), on scattered pages of
    ragged lengths and on a wrapped ring of 1,024 (every slot valid, as
    the model clamps a windowed sub-layer's lengths past the window), at
    the plan's splits and at 3, against the plain version: fp32 within
    2e-5, bf16 inside ``ref.bf16_error_ratio``'s bar of the fp32 plain
    version on the same inputs."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (bf16_error_ratio,
                                                      paged_decode_ref)
    mp = 64 if ring else 12
    q, k, v, pt, valid = _pcase(dev, 4, 16, 8, 256, 4 * mp + 9, 16, mp,
                                dtype=dtype, seed=3)
    if ring:
        valid.fill_(mp * 16)
        pt = torch.as_tensor(np.random.default_rng(3).permutation(
            np.arange(1, 4 * mp + 1)).reshape(4, mp), dtype=torch.int32,
            device=dev)
    if splits is not None:
        _force_splits(monkeypatch, fops, splits)
    before = fops.paged_decode_attention.launches
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    torch.cuda.synchronize()
    assert fops.paged_decode_attention.launches == before + 1
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    if dtype == torch.float32:
        assert float((out - want).abs().max()) < TOL
    else:
        assert bf16_error_ratio(out, want) <= 1.0
    assert torch.equal(out, fops.paged_decode_attention(q, k, v, pt, valid))


def test_flash_attention_bf16_at_group_6(dev):
    """K5/K6 in bf16 at internvl2-26b's heads (48 over 8 of 128, a GQA
    group of 6) over its serving prefill's 1,152 causal positions, on the
    tensor-core source, element by element inside
    ``ref.rounding_error_ratio``'s bar of the plain version that rounds
    where the kernels round; one launch each of the forward, dQ and
    dK/dV."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref,
        rounding_error_ratio)
    dtype = torch.bfloat16
    q, k, v, g = _acase(dev, 2, 1152, 48, 8, 128, dtype, seed=6)
    aops.reset_launch_counts()
    o, dq, dk, dv = _grads(aops.flash_attention, q, k, v, g, True, 0)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    assert aops.SOURCE_LAUNCHES == {aops.SOURCES[torch.float32].name: 0,
                                    aops.SOURCES[dtype].name: 3}
    _, lse = aops.attention_fwd(q, k, v)
    o_emu, lse_emu = flash_attention_fwd_ref(q, k, v, round_to=dtype)
    want = (o_emu,) + flash_attention_bwd_ref(q, k, v, o, lse, g,
                                              round_to=dtype)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                              want):
        assert rounding_error_ratio(got, ref) <= 1.0, name
    torch.testing.assert_close(lse, lse_emu, atol=1e-5, rtol=0)


def _attention_configs():
    """Every registered config with attention (not the ssm family): its
    name, heads, KV heads, head dim and window."""
    from repro_torch.configs.base import get_config, list_configs
    out = []
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family != "ssm":
            out.append((name, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.sliding_window))
    return out


@pytest.mark.parametrize("name,h,hkv,hd,window", _attention_configs())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_attention_shapes_on_card(dev, dtype, name, h, hkv, hd,
                                             window):
    """Each registered config's heads, KV heads and head dim on K3 (paged
    decode) and on K5/K6 (causal, and windowed where the config has a
    window, cut to 96 to fit 256 positions), against the plain versions
    at the bars of the tests above: the shapes
    ``tests/test_torch_kernel_shapes.py`` checks on the CPU, run here."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    fp32 = dtype == torch.float32
    q, k, v, pt, valid = _pcase(dev, 2, h, hkv, hd, 30, 16, 6, dtype=dtype)
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    assert float((out.float() - want).abs().max()) < (TOL if fp32 else 3e-2)
    for w in sorted({0, min(window, 96)}):
        q, k, v, g = _acase(dev, 1, 256, h, hkv, hd, dtype, seed=w)
        o, dq, dk, dv = _grads(aops.flash_attention, q, k, v, g, True, w)
        qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
        o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, window=w)
        refs = (o_ref,) + flash_attention_bwd_ref(qf, kf, vf, o_ref, lse_ref,
                                                  gf, window=w)
        for what, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                                  refs):
            err = float((got.float() - ref).abs().max())
            if fp32:
                assert err < (TOL if what == "o" else 5e-4), (what, w, err)
            else:
                assert err < 3e-2 * max(1.0, float(ref.abs().max())), \
                    (what, w, err)


# ---------------------------------------------------------------------------
# the mesh on the card: ranks spawned by tests/torch_ranks.py


def test_shard_over_clients_two_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks share the card: ``shard_over_clients`` on CUDA
    tensors is bitwise the plain call, also with an empty block."""
    import torch_ranks
    for got, want, one, want_one in torch_ranks.spawn(
            "shard_over_clients_case", 2, tmp_path, device="cuda"):
        for g, w in ((got, want), (one, want_one)):
            assert torch.equal(g["a"], w["a"])
            assert all(torch.equal(x, y) for x, y in zip(g["b"], w["b"]))


@pytest.mark.parametrize("e,k", [(8, 2), (8, 1), (4, 4)])
def test_apply_moe_sharded_world_of_one_over_nccl(dev, tmp_path, e, k):
    """``apply_moe_sharded`` on a (1, 1) mesh over NCCL against
    ``apply_moe`` on the card: y 1e-5, aux 1e-6, gradients 1e-5."""
    import torch_ranks
    (y_err, aux_err, grad_errs, kind), = torch_ranks.spawn(
        "moe_ep_cuda", 1, tmp_path, backend="nccl", e=e, k=k,
        seed=10 * e + k)
    assert kind == "cuda"
    assert y_err < 1e-5 and aux_err < 1e-6
    assert max(grad_errs) < 1e-5, grad_errs


def test_prod_env_allocator_setting_parses(dev):
    """The production profile's allocator setting is one the card's
    caching allocator takes."""
    import subprocess
    import sys
    from repro_torch.launch.env import production_env
    e = production_env(tcmalloc=False)
    r = subprocess.run([sys.executable, "-c",
                        "import torch; x = torch.ones(1 << 20, "
                        "device='cuda'); print(int(x.sum()))"],
                       env=e, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith(str(1 << 20))


def test_trace_level_on_the_card_is_clean_and_launches_kernels(dev):
    """The analysis gate's trace level on CUDA: no finding (the decode
    also under the sync debug mode), the CPU run's program list, and
    K1 / K2 / K3 launched in the dense, qint8 and decode programs."""
    from pathlib import Path
    from repro_torch.analysis import tracecheck as T
    from repro_torch.analysis.findings import run_checkers
    T.set_trace_device("cuda")
    try:
        reg = T.traced_programs("cuda")
        assert run_checkers(Path(__file__).resolve().parents[1],
                            "trace") == []
    finally:
        T.set_trace_device("cpu")
    assert [p.name for p in reg.programs] == \
        [p.name for p in T.traced_programs("cpu").programs]
    launches = {p.name: p.launches for p in reg.programs}
    assert launches["trace:sync/round_step_dense"]["K1"] > 0
    assert launches["trace:sync/round_step_qint8"]["K2"] > 0
    assert launches["trace:serve/decode"]["K3"] > 0


def test_dryrun_argument_bytes_against_real_allocations(dev):
    """A reduced train step's argument bytes from the meta dry run are
    the bytes its params, Adam moments and batch take on the card (the
    caching allocator rounds each tensor up to 512 bytes)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import get_model
    from repro_torch.optim.masked import adam_init
    cfg = get_config("qwen3-1.7b").reduced()
    rec = dryrun.run_dryrun(cfg, InputShape("t", 1024, 2, "train"),
                            verbose=False)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    opt = adam_init(params)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in lm_batch(2, 1024, cfg.vocab).items()}
    leaves = [x for t in (params, opt.mu, opt.nu, batch) for x in t.values()]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        sum(x.nbytes for x in leaves)
    assert torch.cuda.memory_allocated() - before == \
        sum(-(-x.nbytes // 512) * 512 for x in leaves)


# -- K1's bf16 instance --------------------------------------------------------

BF16 = torch.bfloat16
# (rows, clients) of the nine plans K1 runs, the zoo's rows cut by 100:
# VGG16 hub, IMDB, CASA, the hierarchical combine, qwen3-1.7b, hymba-1.5b
# (16 layers), whisper-medium, granite-moe-1b-a400m, internvl2-26b (2
# layers); then one plane and 33 (past a warp's 32 clients)
K1_BF16_PLANS = [(7252, 8), (1293, 10), (44, 10), (7252, 2), (8402, 2),
                 (3857, 2), (3714, 2), (6518, 2), (9401, 2), (300, 1),
                 (300, 33)]


def _bf16_case(dev, t, c, tile=2048, seed=0):
    """``_case`` in bf16, each client's unselected planes zero (as a
    round writes them)."""
    g, d, sel, w, ru = _case(dev, t, c, tile, seed)
    d = 0.05 * d * sel[:, ru.long()][..., None]
    return g.to(BF16), d.to(BF16), sel, w, ru


def _agrees(got, want, g):
    """One bf16 step, or fp32 rounding where the update cancels g
    (``ref.bf16_agrees``)."""
    from repro_torch.kernels.masked_agg.ref import bf16_agrees
    return bool(bf16_agrees(got, want, g).all())


@pytest.mark.parametrize("t,c", K1_BF16_PLANS)
def test_kernel_bf16_matches_plain(dev, t, c):
    g, d, sel, w, ru = _bf16_case(dev, t, c, seed=t + c)
    before = dict(ops.LAUNCHES)
    out = ops.masked_agg(g, d, sel, w, ru)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert ops.LAUNCHES == {"masked_agg_f32": before["masked_agg_f32"],
                            "masked_agg_bf16": before["masked_agg_bf16"] + 1}
    assert _agrees(out, masked_agg_ref(g, d, sel, w, ru), g)
    still = ru == 1                                   # nobody trained
    assert torch.equal(out[still], g[still])
    assert torch.equal(out, ops.masked_agg(g, d, sel, w, ru))


@pytest.mark.parametrize("t,c,tile", [(1100, 2, 2048), (600, 10, 2000),
                                      (2200, 6, 24)])
def test_kernel_bf16_launch_widths_agree_bitwise(dev, t, c, tile):
    """Two 16-byte vectors a thread over the whole call, one over slices
    of 256 rows: bitwise the same rows, ragged chunks included."""
    g, d, sel, w, ru = _bf16_case(dev, t, c, tile, seed=t)
    assert ops.launch_vec(t, tile, 2) == 2
    assert ops.launch_vec(256, tile, 2) == 1
    whole = ops.masked_agg(g, d, sel, w, ru)
    assert _agrees(whole, masked_agg_ref(g, d, sel, w, ru), g)
    for a in range(0, t, 256):
        part = ops.masked_agg(g[a:a + 256], d[:, a:a + 256], sel, w,
                              ru[a:a + 256])
        assert torch.equal(part, whole[a:a + 256]), a


@pytest.mark.parametrize("where", ["unselected", "zero_weight"])
def test_kernel_bf16_nan_planes(dev, where):
    """bf16 as ``test_kernel_nan_planes``: an unselected NaN never read,
    a zero-weight client's selected NaN reaching the output."""
    g, d, sel, w, ru = _bf16_case(dev, 10, 4, 256)
    if where == "unselected":
        sel[0, 2], sel[1, 2] = 0.0, 1.0               # row 2 is unit 2
        clean = ops.masked_agg(g, d, sel, w, ru)
        d[0, 2, 9] = float("nan")
        out = ops.masked_agg(g, d, sel, w, ru)
        assert torch.equal(out, clean)
        assert _agrees(out, masked_agg_ref(g, d, sel, w, ru), g)
    else:
        clean = ops.masked_agg(g, d, sel, w, ru)
        d[3, 0, 9] = float("nan")                     # client 3: weight 0
        out = ops.masked_agg(g, d, sel, w, ru)
        plain = masked_agg_ref(g, d, sel, w, ru)
        assert bool(torch.isnan(out[0, 9])) and bool(torch.isnan(plain[0, 9]))
        nan = torch.isnan(out)
        assert int(nan.sum()) == 1
        assert torch.equal(out[~nan], clean[~nan])


@pytest.mark.parametrize("bad", ["deltas_fp32", "global_fp32", "fp16",
                                 "tile", "client_stride"])
def test_kernel_bf16_wrapper_raises(dev, bad):
    """A dtype mix, a dtype the kernel lacks, and a tile or client stride
    off a 16-byte vector of 8 bf16s raise before any launch: no cast to
    the fp32 instance, no plain fallback."""
    g, d, sel, w, ru = _bf16_case(dev, 4, 2, 256)
    if bad == "deltas_fp32":
        d = d.float()
    elif bad == "global_fp32":
        g = g.float()
    elif bad == "fp16":
        g, d = g.half(), d.half()
    elif bad == "tile":
        g, d = g[:, :252].contiguous(), d[:, :, :252].contiguous()
    else:
        big = torch.zeros(2 * 4 * 256 + 4, dtype=BF16, device=dev)
        d = big.as_strided((2, 4, 256), (4 * 256 + 4, 256, 1))
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="masked_agg"):
        ops.masked_agg(g, d, sel, w, ru)
    assert ops.LAUNCHES == before


def test_fused_bf16_rounds_read_global_tiles_in_place_on_card(dev):
    """Two bf16 fused aggregates on the card: bf16 planes and global,
    the second read in place (bitwise the packing path) and no fp32
    launch."""
    from repro_torch.core.masking import build_units_flat
    from repro_torch.models import paper_models as pm
    params = {k: v.to(dev, BF16) for k, v in pm.init_vgg16(
        torch.Generator().manual_seed(0), width_mult=0.25).items()}
    assign = build_units_flat(params, pm.vgg16_units(params))
    plan = ops.build_agg_plan(assign, params)
    assert ops.tile_dtype(params) == BF16
    rng = np.random.default_rng(1)
    sel = torch.as_tensor(rng.integers(0, 2, (5, 14)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 5), dtype=torch.float32)
    d_t = ops.new_tile_buffer(plan, (5,), device=dev, dtype=BF16).normal_()
    before = dict(ops.LAUNCHES)
    first = ops.masked_combine_packed(params, d_t, sel, w, plan)
    assert {x.dtype for x in first.values()} == {BF16}
    assert ops.tile_source(plan, first) is not None
    keep = {p: x.clone() for p, x in first.items()}
    second = ops.masked_combine_packed(first, d_t, sel, w, plan)
    packed = ops.masked_combine_packed(keep, d_t, sel, w, plan)
    for p in params:
        assert torch.equal(second[p], packed[p]), p
        assert torch.equal(first[p], keep[p]), p
    assert ops.LAUNCHES["masked_agg_f32"] == before["masked_agg_f32"]
    assert ops.LAUNCHES["masked_agg_bf16"] == before["masked_agg_bf16"] + 3


# -- bf16 serving through the paged engine: K3's and K7's bf16 instances -----

# (arch, head dim): K3 at a GQA group of 2 and head dim 128 (qwen3-1.7b),
# at 256 on rings that wrap (gemma3-12b: prompts past its reduced window
# of 64) and at 80 (stablelm-3b: 10 16-byte chunks on 16 lanes)
SERVE_BF16 = [("qwen3-1.7b", 128, 24, 48), ("gemma3-12b", 256, 70, 96),
              ("stablelm-3b", 80, 24, 48)]


def _rows_rel(got, want):
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@contextlib.contextmanager
def _counted(mod, name, calls):
    real = getattr(mod, name)

    def fn(*a, **kw):
        calls.append(name)
        return real(*a, **kw)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, real)


@pytest.mark.parametrize("arch,hd,prompt,max_len", SERVE_BF16)
def test_serve_bf16_decode_step_k3_vs_plain(dev, arch, hd, prompt, max_len):
    """One engine decode step of a reduced model in bf16 at ``hd``: with
    K3 (its bf16 launches move by one a layer, the plain version never
    runs) against the same step with the model's K3 call replaced by the
    plain gather + attention in bf16, within 2 x the plain run's distance
    from the fp32 engine on the same weights."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    from repro_torch.models import get_model, transformer
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    cfg = get_config(arch).reduced().replace(head_dim=hd)
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, prompt))

    def decode_rows(dtype, plain=False):
        c = cfg.replace(param_dtype=str(dtype)[6:])
        eng = DecodeEngine(c, {p: x.to(dtype) for p, x in params.items()},
                           ServeConfig(n_slots=3, max_len=max_len,
                                       record_logits=True), device=dev)
        for p in prompts:
            eng.submit(p, 2)            # the prefill's token, one step
        real = transformer.paged_decode_attention
        if plain:
            transformer.paged_decode_attention = paged_decode_ref
        try:
            eng.run()
        finally:
            transformer.paged_decode_attention = real
        assert eng.decode_cache_size == 1
        return eng, torch.stack([torch.as_tensor(eng.logits_rows[i][1])
                                 for i in range(len(prompts))])

    fops.reset_launch_counts()
    plain_calls = []
    with _counted(fops, "paged_decode_ref", plain_calls):
        eng, kernel = decode_rows(BF16)
    assert fops.DTYPE_LAUNCHES == {torch.float32: 0, BF16: cfg.n_layers}
    assert plain_calls == []
    assert {eng.paged["pool/k"].dtype, eng.paged["pool/v"].dtype} == {BF16}
    if arch == "gemma3-12b":
        assert any(s.ring for s in eng.layout.subs)
    fops.reset_launch_counts()
    _, plain = decode_rows(BF16, plain=True)
    assert fops.DTYPE_LAUNCHES[BF16] == 0
    _, fp32 = decode_rows(torch.float32)
    bar = 2.0 * _rows_rel(plain, fp32)
    assert 0 < _rows_rel(kernel, plain) <= bar
    assert _rows_rel(kernel, fp32) <= bar


def test_serve_bf16_rwkv6_prefill_k7_vs_plain(dev):
    """rwkv6's bf16 prefill (r, k, v bf16, the log-decay fp32) with K7
    (its bf16 launches move by one a layer, no plain scan runs) against
    the same prefill with the scan on ``chunked_linear_scan``, within 2 x
    the plain run's distance from the fp32 prefill, the decay's base at
    RWKV-6's init so that the state carries across chunks; the WKV state
    stays fp32."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.models import get_model, linear_scan, rwkv6
    cfg = get_config("rwkv6-3b").reduced()
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    params["blocks/sub0/wkv/decay_base"].copy_(rwkv6.decay_base_init(
        cfg.n_layers, cfg.n_heads, cfg.head_dim))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 96)), device=dev)

    def prefill(dtype, plain=False):
        c16 = cfg.replace(param_dtype=str(dtype)[6:])
        p = {k: x.to(dtype) for k, x in params.items()}
        real = rwkv6.wkv
        if plain:
            rwkv6.wkv = lambda r, k, v, ld, u, *, chunk: \
                linear_scan.chunked_linear_scan(r, k, v, ld, decay_on="k",
                                                bonus=u, chunk=chunk)
        try:
            with torch.no_grad():
                logits, cache = get_model(c16).prefill(p, tokens)
        finally:
            rwkv6.wkv = real
        return logits.float(), cache

    wops.reset_launch_counts()
    plain_calls = []
    with _counted(wops, "rwkv6_scan_chunked_ref", plain_calls), \
            _counted(rwkv6, "chunked_linear_scan", plain_calls):
        kernel, cache = prefill(BF16)
    assert wops.DTYPE_LAUNCHES == {torch.float32: 0, BF16: cfg.n_layers}
    assert plain_calls == []
    assert cache["subs/sub0/wkv"].dtype == torch.float32
    assert cache["subs/sub0/x_tmix"].dtype == BF16
    wops.reset_launch_counts()
    plain, _ = prefill(BF16, plain=True)
    assert wops.rwkv6_scan.launches == 0
    fp32, _ = prefill(torch.float32)
    bar = 2.0 * _rows_rel(plain, fp32)
    assert 0 < _rows_rel(kernel, plain) <= bar
    assert _rows_rel(kernel, fp32) <= bar


# -- whisper-medium and hymba-1.5b in bf16: K4's bf16 instance at whisper's
#    caches, K5/K6 bf16 on the padded non-causal route, K3 bf16 at a GQA
#    group of 5 on a ring that wraps ------------------------------------------

@pytest.mark.parametrize("s", [200, 1500], ids=["self", "cross"])
def test_dense_decode_bf16_at_whisper_caches(dev, s):
    """K4's bf16 instance as whisper's decode step calls it: 8 sequences,
    16 heads of 64, ``blk_k`` the cache's length (the self cache's 200
    positions, ragged valid lengths; the cross cache's 1,500, every one
    valid): one bf16 launch, inside ``ref.bf16_error_ratio``'s bar of the
    plain version in fp32 on the same inputs, two calls bitwise equal."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (bf16_error_ratio,
                                                      decode_attention_ref)
    q, k, v, valid = _dcase(dev, 8, s, 16, 16, 64, dtype=torch.bfloat16,
                            seed=5)
    if s == 1500:
        valid.fill_(s)
    fops.reset_launch_counts()
    out = fops.decode_attention(q, k, v, valid, blk_k=s)
    torch.cuda.synchronize()
    assert fops.DTYPE_LAUNCHES == {torch.float32: 0, torch.bfloat16: 1}
    want = decode_attention_ref(q.float(), k.float(), v.float(), valid,
                                blk_k=s)
    assert out.dtype == torch.bfloat16
    assert bf16_error_ratio(out, want) <= 1.0
    assert torch.equal(out, fops.decode_attention(q, k, v, valid, blk_k=s))


def test_noncausal_bf16_pad_rows_reach_no_gradient(dev):
    """K5/K6 bf16 (``flash_attention_sm90.cu``) on the padded non-causal
    route at whisper's encoder, 1,500 of 1,536 keys, 16 heads of 64: the
    forward and both backward kernels once each, none of the fp32 source;
    o, dq, dk, dv inside ``ref.rounding_error_ratio``'s bar of the plain
    version that rounds where the kernels round; with large values
    planted in the 36 pad rows of K and V (masked by ``kv_len``) every
    real output and gradient is bitwise the same and the pad rows of dK
    and dV stay zero."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref,
        rounding_error_ratio)
    bf16, sk = torch.bfloat16, 1500
    q, k, v, g = _acase(dev, 1, 1536, 16, 16, 64, bf16, seed=2)
    k[:, sk:] = 0
    v[:, sk:] = 0
    aops.reset_launch_counts()
    o, lse = aops.attention_fwd(q, k, v, causal=False, kv_len=sk)
    dq, dk, dv = aops.attention_bwd(q, k, v, o, lse, g, causal=False,
                                    kv_len=sk)
    torch.cuda.synchronize()
    assert aops.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    assert aops.SOURCE_LAUNCHES == {aops.SOURCES[torch.float32].name: 0,
                                    aops.SOURCES[bf16].name: 3}
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=False,
                                             round_to=bf16, kv_len=sk)
    want = (o_ref,) + flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, g,
                                              causal=False, round_to=bf16,
                                              kv_len=sk)
    for name, x, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        assert rounding_error_ratio(x, ref) <= 1.0, name
    assert not dk[:, sk:].any() and not dv[:, sk:].any()
    k2, v2 = k.clone(), v.clone()
    k2[:, sk:] = 300.0
    v2[:, sk:] = -300.0
    o2, lse2 = aops.attention_fwd(q, k2, v2, causal=False, kv_len=sk)
    dq2, dk2, dv2 = aops.attention_bwd(q, k2, v2, o2, lse2, g, causal=False,
                                       kv_len=sk)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(dq2, dq)
    assert torch.equal(dk2[:, :sk], dk[:, :sk])
    assert torch.equal(dv2[:, :sk], dv[:, :sk])
    assert not dk2[:, sk:].any() and not dv2[:, sk:].any()


@pytest.mark.parametrize("splits", [None, 3])
def test_paged_decode_bf16_group_5_on_a_wrapped_ring(dev, splits,
                                                     monkeypatch):
    """K3's bf16 instance at hymba-1.5b's heads, 25 over 5 of 64 (a GQA
    group of 5), on a wrapped ring of 1,024 (64 pages of 16, every slot
    valid, as the model clamps a windowed sub-layer's lengths past the
    window), at the plan's splits and at 3: one bf16 launch, inside
    ``ref.bf16_error_ratio``'s bar of the plain version in fp32, two
    calls bitwise equal."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (bf16_error_ratio,
                                                      paged_decode_ref)
    mp = 64
    q, k, v, pt, valid = _pcase(dev, 4, 25, 5, 64, 4 * mp + 9, 16, mp,
                                dtype=torch.bfloat16, seed=7)
    valid.fill_(mp * 16)
    pt = torch.as_tensor(np.random.default_rng(7).permutation(
        np.arange(1, 4 * mp + 1)).reshape(4, mp), dtype=torch.int32,
        device=dev)
    if splits is not None:
        _force_splits(monkeypatch, fops, splits)
    fops.reset_launch_counts()
    out = fops.paged_decode_attention(q, k, v, pt, valid)
    torch.cuda.synchronize()
    assert fops.DTYPE_LAUNCHES == {torch.float32: 0, torch.bfloat16: 1}
    want = paged_decode_ref(q.float(), k.float(), v.float(), pt, valid)
    assert bf16_error_ratio(out, want) <= 1.0
    assert torch.equal(out, fops.paged_decode_attention(q, k, v, pt, valid))


def test_bf16_backward_delta_reads_unrounded_o(dev):
    """K6 bf16 over 1,500 near-uniformly attended keys and values that
    share a large common component (as whisper's cross-attention over
    its frames): the forward keeps o in fp32 before its rounding
    (``keep_fp32``, its bf16 rounding bitwise the bf16 o), the
    differentiable op's backward reads delta from it, and its dq lies
    far closer to the fp32 plain backward than the same kernels' dq from
    the rounded o, which breaks ``sum_j ds_ij = 0`` by dO times o's
    rounding."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    bf16, sk = torch.bfloat16, 1500
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    q = (0.1 * randn(1, 1024, 16, 64)).to(bf16)
    k = (4 * randn(1, 1, 16, 64) + randn(1, 1536, 16, 64)).to(bf16)
    v = (4 * randn(1, 1, 16, 64) + randn(1, 1536, 16, 64)).to(bf16)
    k[:, sk:] = 0
    v[:, sk:] = 0
    g = randn(1, 1024, 16, 64).to(bf16)
    o, lse, o32 = aops.attention_fwd(q, k, v, causal=False, kv_len=sk,
                                     keep_fp32=True)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(bf16), o)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, causal=False,
                                             kv_len=sk)
    dq_ref = flash_attention_bwd_ref(qf, kf, vf, o_ref, lse_ref, gf,
                                     causal=False, kv_len=sk)[0]

    def rel(x):
        return float((x.float() - dq_ref).norm() / dq_ref.norm())
    kept = aops.attention_bwd(q, k, v, o32, lse, g, causal=False,
                              kv_len=sk)[0]
    rounded = aops.attention_bwd(q, k, v, o, lse, g, causal=False,
                                 kv_len=sk)[0]
    qs = q.detach().requires_grad_()
    via = torch.autograd.grad((aops.flash_attention(
        qs, k, v, False, 0, kv_len=sk) * g).sum(), qs)[0]
    assert torch.equal(via, kept)
    assert 3 * rel(kept) < rel(rounded), (rel(kept), rel(rounded))
