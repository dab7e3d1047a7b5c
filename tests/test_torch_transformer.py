"""The port's dense transformer against ``repro.models.transformer`` on
the same params (``convert.from_reference``) and the same numpy tokens:
reduced qwen3-1.7b for the full-attention path and reduced gemma3-12b
(window 64, one global layer per macro of 2) for the sliding-window
ring branch.

Logits are held to 1e-4 abs (fp32 matmuls and softmax sums in another
order through 2-4 layers; measured ~1e-6).  The paged decode runs
teacher-forced: both packages are fed the same tokens, so a near-tie in
the argmax can not make the streams part.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import from_reference, is_conv_kernel, to_reference
from repro_torch.core import NotPortedError
from repro_torch.models import get_model, transformer

TOL = 1e-4
PS = 16


def _setup(arch, seed=0):
    rcfg = r_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rmodel = r_get_model(rcfg)
    rp = rmodel.init_params(jax.random.PRNGKey(seed))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    return rcfg, cfg, rmodel, get_model(cfg), rp, tp


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen3-1.7b")


@pytest.fixture(scope="module")
def gemma():
    return _setup("gemma3-12b")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0, err_msg=what)


def test_configs_match_reference():
    assert set(list_configs()) == {"qwen3-1.7b", "gemma3-12b", "rwkv6-3b",
                                   "qwen2.5-14b", "stablelm-3b", "hymba-1.5b",
                                   "granite-moe-1b-a400m",
                                   "llama4-maverick-400b-a17b",
                                   "whisper-medium", "internvl2-26b"}
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(r_get_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(r_get_config(name).reduced())
    full = get_config("qwen3-1.7b")
    assert full.padded_vocab == full.vocab == 151_936     # 1187 x 128


def test_convert_roundtrips_zoo_tree(qwen):
    rcfg, cfg, _, _, rp, tp = qwen
    np_rp = jax.tree_util.tree_map(np.asarray, rp)
    nm = transformer.n_macro(cfg)
    assert tuple(tp["blocks/sub0/attn/wq"].shape) == \
        (nm, cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert tuple(tp["blocks/sub0/attn/wo"].shape) == \
        (nm, cfg.n_heads, cfg.head_dim, cfg.d_model)
    assert not any(is_conv_kernel(p) for p in tp)
    assert is_conv_kernel("conv0/w") and is_conv_kernel("conv12/w")
    assert not is_conv_kernel("conv0/b") and not is_conv_kernel("dense0/w")
    back = to_reference(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(np_rp)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        assert np.array_equal(flat_b[path], x), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b"])
def test_init_params_shapes_and_scales(arch):
    rcfg = r_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: r_get_model(rcfg).init_params(k),
                            jax.random.PRNGKey(0))
    want = {p: tuple(x.shape) for p, x in from_reference(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    tp = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    assert list(tp) == sorted(want, key=lambda p: tuple(p.split("/")))
    assert {p: tuple(x.shape) for p, x in tp.items()} == want
    assert float(tp["embed/table"].std()) == pytest.approx(0.02, rel=0.05)
    wq = tp["blocks/sub0/attn/wq"]
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    assert bool((tp["blocks/sub0/ln1/w"] == 1).all())


def test_full_width_param_count():
    """The figure chip_smoke.py holds the port's full-width init to."""
    rcfg = r_get_config("qwen3-1.7b")
    shapes = jax.eval_shape(lambda k: r_get_model(rcfg).init_params(k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes)) == 1_720_574_976


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b"])
def test_forward_and_loss_match(arch, qwen, gemma):
    rcfg, cfg, rmodel, model, rp, tp = qwen if arch.startswith("qwen") \
        else gemma
    toks = _tokens(cfg, 2, 24)
    want, _, _ = rmodel.forward(rp, jnp.asarray(toks), attn_impl="reference")
    got, _, _ = model.forward(tp, torch.as_tensor(toks),
                              attn_impl="reference")
    _close(got, want, f"{arch} forward logits")
    labels = _tokens(cfg, 2, 24, seed=2)
    rl, _ = rmodel.loss_fn(rp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)},
                           attn_impl="reference")
    tl, _ = model.loss_fn(tp, {"tokens": torch.as_tensor(toks),
                               "labels": torch.as_tensor(labels)},
                          attn_impl="reference")
    assert abs(float(tl) - float(rl)) < TOL


def _dense_run(rmodel, model, rp, tp, toks, feed, max_len):
    """Prefill then teacher-forced dense decode in both packages; yields
    (what, port logits, reference logits)."""
    rlog, rc = rmodel.prefill(rp, jnp.asarray(toks), max_len=max_len,
                              attn_impl="reference")
    tlog, tc = model.prefill(tp, torch.as_tensor(toks), max_len=max_len,
                             attn_impl="reference")
    yield "prefill logits", tlog, rlog
    for name in rc["subs"]:
        for kind in ("k", "v"):
            yield (f"prefill cache {name}/{kind}", tc[f"subs/{name}/{kind}"],
                   rc["subs"][name][kind])
    for i, t in enumerate(feed.T):
        rlog, rc = rmodel.decode_step(rp, rc, jnp.asarray(t[:, None]))
        tlog, tc = model.decode_step(tp, tc, torch.as_tensor(t[:, None]))
        yield f"decode step {i}", tlog, rlog
    assert int(tc["step"]) == int(rc["step"])


def test_prefill_and_decode_match(qwen):
    rcfg, cfg, rmodel, model, rp, tp = qwen
    toks, feed = _tokens(cfg, 2, 20), _tokens(cfg, 2, 4, seed=3)
    for what, got, want in _dense_run(rmodel, model, rp, tp, toks, feed, 32):
        _close(got, want, what)


def test_ring_prefill_and_decode_match(gemma):
    """70 prompt tokens into a 64-slot ring (prefill wraps), then decode
    steps that keep wrapping; the global layer's cache stays full."""
    rcfg, cfg, rmodel, model, rp, tp = gemma
    assert cfg.sliding_window == 64
    toks, feed = _tokens(cfg, 2, 70), _tokens(cfg, 2, 4, seed=3)
    for what, got, want in _dense_run(rmodel, model, rp, tp, toks, feed, 96):
        _close(got, want, what)


def _paged_setup(cfg, b, max_len, seed=0):
    """Page tables with scattered physical pages (page 0 = trash)."""
    layout = transformer.block_layout(cfg)
    rng = np.random.default_rng(seed)
    mps = [transformer.cache_alloc(cfg, s, max_len) // PS for s in layout]
    n_pages = 1 + b * sum(mps) + 3
    perm = iter(rng.permutation(np.arange(1, n_pages)).tolist())
    tables = {f"sub{si}": np.asarray([[next(perm) for _ in range(mp)]
                                      for _ in range(b)], np.int32)
              for si, mp in enumerate(mps)}
    return n_pages, tables


@pytest.mark.parametrize("arch,prompt,max_len", [("qwen3-1.7b", 20, 32),
                                                 ("gemma3-12b", 70, 96)])
def test_paged_decode_teacher_forced(arch, prompt, max_len, qwen, gemma):
    rcfg, cfg, rmodel, model, rp, tp = qwen if arch.startswith("qwen") \
        else gemma
    b = 2
    toks, feed = _tokens(cfg, b, prompt), _tokens(cfg, b, 5, seed=4)
    n_pages, tables = _paged_setup(cfg, b, max_len)
    _, rc = rmodel.prefill(rp, jnp.asarray(toks), max_len=max_len,
                           attn_impl="reference")
    _, tc = model.prefill(tp, torch.as_tensor(toks), max_len=max_len,
                          attn_impl="reference")
    rpaged = rmodel.init_paged_cache(b, n_pages, PS)
    rpaged = rmodel.commit_prefill(rpaged, rc, None,
                                   {k: jnp.asarray(v) for k, v in
                                    tables.items()}, PS)
    tpaged = model.init_paged_cache(b, n_pages, PS, device="cpu")
    ttab = {k: torch.as_tensor(v) for k, v in tables.items()}
    tpaged = model.commit_prefill(tpaged, tc, None, ttab, PS)
    for kind in ("k", "v"):
        # pages nobody owns stay zero in both; owned pages hold the slabs
        np.testing.assert_allclose(tpaged[f"pool/{kind}"].numpy(),
                                   np.asarray(rpaged["pool"][kind]),
                                   atol=TOL, rtol=0)
    steps = np.full((b,), prompt, np.int32)
    for i, t in enumerate(feed.T):
        rlog, rpaged = rmodel.decode_step_paged(
            rp, rpaged, jnp.asarray(t[:, None]), jnp.asarray(steps + i),
            {k: jnp.asarray(v) for k, v in tables.items()}, PS)
        tlog, tpaged = model.decode_step_paged(
            tp, tpaged, torch.as_tensor(t[:, None]),
            torch.as_tensor(steps + i), ttab, PS)
        _close(tlog, rlog, f"{arch} paged decode step {i}")


def test_paged_decode_equals_dense_decode_bitwise(gemma):
    """Inside the port on the CPU the paged step (plain gather + dense
    decode) equals the dense step bitwise, ring layers included."""
    _, cfg, _, model, _, tp = gemma
    b, prompt, max_len = 2, 70, 96
    toks, feed = _tokens(cfg, b, prompt), _tokens(cfg, b, 4, seed=5)
    n_pages, tables = _paged_setup(cfg, b, max_len, seed=1)
    ttab = {k: torch.as_tensor(v) for k, v in tables.items()}
    _, dense = model.prefill(tp, torch.as_tensor(toks), max_len=max_len,
                             attn_impl="reference")
    paged = model.commit_prefill(
        model.init_paged_cache(b, n_pages, PS, device="cpu"),
        {k: v.clone() for k, v in dense.items()}, None, ttab, PS)
    for i, t in enumerate(feed.T):
        tok = torch.as_tensor(t[:, None])
        dlog, dense = model.decode_step(tp, dense, tok)
        plog, paged = model.decode_step_paged(
            tp, paged, tok, torch.full((b,), prompt + i, dtype=torch.int32),
            ttab, PS)
        assert torch.equal(dlog, plog), f"step {i}"


def test_unported_paths_raise():
    # the vlm family is the transformer's since it was ported
    vlm = get_config("internvl2-26b").reduced()
    assert get_model(vlm).forward.__code__ is \
        get_model(get_config("qwen3-1.7b")).forward.__code__
    # the audio family is whisper's since it was ported; it has no paged
    # serving entries
    assert get_model(get_config("whisper-medium")).decode_step_paged is None
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotPortedError, match="moe_mesh"):
        model.forward(params, torch.zeros((1, 4), dtype=torch.int64),
                      moe_mesh=object())
    # the patch projector is drawn since it was ported
    vp = get_model(vlm).init_params(torch.Generator().manual_seed(0))
    assert tuple(vp["projector/w"].shape) == (transformer.vit_width(vlm),
                                              vlm.d_model)
