"""The port's RWKV-6 model (``repro_torch.models.rwkv6``) against
``repro.models.rwkv6`` on reduced rwkv6-3b (2 layers, d_model 128, 4
heads of 32, d_ff 256, vocab 512), on the same params
(``convert.from_reference``) and the same numpy tokens.

The reference's init sets ``u``, ``decay_base`` and ``ln_b`` to zeros and
every ``mu`` to 0.5, which would leave the bonus term and the lerps
untested; the fixture redraws those leaves from a numpy seed before
either package sees them.

Logits and caches are held to 1e-4 abs (fp32 in another summation order
through 2 layers; measured ~1e-5).  Decode runs teacher-forced, so a
near tie cannot make the streams part.  On the CPU the prefill's scan is
K7's plain chunked version, the training forward's the chunked
substrate, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.models import rwkv6 as r_rwkv6
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, is_conv_kernel, to_reference
from repro_torch.models import _FAMILY, get_model, rwkv6, transformer

TOL = 1e-4
ARCH = "rwkv6-3b"
FULL_PARAMS = 3_073_395_200      # chip_smoke.py holds the full-width init to it
_REDRAWN = ("u", "decay_base", "ln_b", "mu_r", "mu_k", "mu_v", "mu_w",
            "mu_g")


def perturbed_reference_params(rcfg, seed=0):
    """The reference's init with the zero / constant leaves redrawn
    (numpy, nested)."""
    rp = r_get_model(rcfg).init_params(jax.random.PRNGKey(seed))
    np_rp = jax.tree_util.tree_map(np.asarray, rp)
    rng = np.random.default_rng(seed + 100)
    blk = np_rp["blocks"]["sub0"]
    for name in _REDRAWN:
        x = blk["wkv"][name]
        blk["wkv"][name] = (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
    for name in ("mu_k", "mu_r"):
        x = blk["cmix"][name]
        blk["cmix"][name] = rng.uniform(0, 1, x.shape).astype(x.dtype)
    return np_rp


@pytest.fixture(scope="module")
def setup():
    rcfg = r_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    np_rp = perturbed_reference_params(rcfg)
    rp = jax.tree_util.tree_map(jnp.asarray, np_rp)
    return rcfg, cfg, r_get_model(rcfg), get_model(cfg), rp, \
        from_reference(np_rp), np_rp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0, err_msg=what)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(r_get_config(ARCH))
    cfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(r_get_config(ARCH).reduced())
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (2, 128, 4, 32, 256, 512)


def test_init_params_shapes_and_full_width_count():
    rcfg = r_get_config(ARCH).reduced()
    shapes = jax.eval_shape(lambda k: r_get_model(rcfg).init_params(k),
                            jax.random.PRNGKey(0))
    want = {p: tuple(x.shape) for p, x in from_reference(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    tp = get_model(get_config(ARCH).reduced()).init_params(
        torch.Generator().manual_seed(0))
    assert list(tp) == sorted(want, key=lambda p: tuple(p.split("/")))
    assert {p: tuple(x.shape) for p, x in tp.items()} == want
    assert bool((tp["blocks/sub0/wkv/mu_r"] == 0.5).all())
    assert bool((tp["blocks/sub0/wkv/u"] == 0).all())
    assert float(tp["blocks/sub0/cmix/wk"].std()) == \
        pytest.approx(128 ** -0.5, rel=0.05)
    full = jax.eval_shape(
        lambda k: r_get_model(r_get_config(ARCH)).init_params(k),
        jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(full)) == FULL_PARAMS


def test_convert_passes_every_leaf_through(setup):
    """rwkv6 leaves (``blocks/sub0/wkv/wr``, ``cmix/wk`` ...) are not conv
    kernels: every one crosses unchanged, and back."""
    *_, tp, np_rp = setup
    flat = dict(jax.tree_util.tree_flatten_with_path(np_rp)[0])
    assert len(flat) == len(tp) and not any(is_conv_kernel(p) for p in tp)
    for path, x in flat.items():
        key = "/".join(k.key for k in path)
        assert np.array_equal(tp[key].numpy(), x), key
        assert tuple(tp[key].shape) == x.shape
    back = dict(jax.tree_util.tree_flatten_with_path(to_reference(tp))[0])
    assert all(np.array_equal(back[p], x) for p, x in flat.items())


def test_forward_and_loss_match(setup):
    _, cfg, rmodel, model, rp, tp, _ = setup
    toks, labels = _tokens(cfg, 2, 24), _tokens(cfg, 2, 24, seed=2)
    want, _, _ = rmodel.forward(rp, jnp.asarray(toks))
    got, aux, _ = model.forward(tp, torch.as_tensor(toks))
    _close(got, want, "forward logits")
    assert float(aux) == 0.0
    rl, _ = rmodel.loss_fn(rp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    tl, _ = model.loss_fn(tp, {"tokens": torch.as_tensor(toks),
                               "labels": torch.as_tensor(labels)})
    assert abs(float(tl) - float(rl)) < TOL


def test_loss_is_differentiable(setup):
    """Training runs the differentiable substrate, never K7."""
    _, cfg, _, model, _, tp, _ = setup
    params = {p: x.clone().requires_grad_() for p, x in tp.items()}
    toks = torch.as_tensor(_tokens(cfg, 1, 16))
    loss, _ = model.loss_fn(params, {"tokens": toks, "labels": toks})
    (g,) = torch.autograd.grad(loss, [params["blocks/sub0/wkv/u"]])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("s", [32, 21, 17])      # chunks 16, 7 and 1
def test_prefill_last_only_and_cache(setup, s):
    _, cfg, rmodel, model, rp, tp, _ = setup
    toks = _tokens(cfg, 2, s)
    rlog, rc = rmodel.prefill(rp, jnp.asarray(toks), max_len=48,
                              last_only=True)
    with torch.no_grad():
        tlog, tc = model.prefill(tp, torch.as_tensor(toks), max_len=48,
                                 last_only=True, attn_impl="ignored")
    assert tuple(tlog.shape) == (2, 1, cfg.padded_vocab)
    _close(tlog, rlog, "last-only prefill logits")
    for name in ("x_tmix", "x_cmix", "wkv"):
        _close(tc[f"subs/sub0/{name}"], rc["subs"]["sub0"][name],
               f"prefill cache {name}")
    assert int(tc["step"]) == s
    assert tc["subs/sub0/wkv"].dtype == torch.float32
    # inside the port: the prefill's scan (K7's plain version) against
    # the training forward's (the chunked substrate)
    full, _, _ = model.forward(tp, torch.as_tensor(toks))
    torch.testing.assert_close(tlog[:, 0], full[:, -1], atol=TOL, rtol=0)


def test_decode_steps_match(setup):
    _, cfg, rmodel, model, rp, tp, _ = setup
    toks, feed = _tokens(cfg, 2, 20), _tokens(cfg, 2, 5, seed=3)
    _, rc = rmodel.prefill(rp, jnp.asarray(toks), max_len=32)
    with torch.no_grad():
        _, tc = model.prefill(tp, torch.as_tensor(toks), max_len=32)
        for i, t in enumerate(feed.T):
            rlog, rc = rmodel.decode_step(rp, rc, jnp.asarray(t[:, None]))
            tlog, tc = model.decode_step(tp, tc, torch.as_tensor(t[:, None]))
            _close(tlog, rlog, f"decode step {i}")
    assert int(tc["step"]) == int(rc["step"]) == 25
    for name in ("x_tmix", "x_cmix", "wkv"):
        _close(tc[f"subs/sub0/{name}"], rc["subs"]["sub0"][name],
               f"cache {name} after decode")


def test_paged_commit_and_decode_into_scattered_slots(setup):
    """Two prompts committed into slots 3 and 0 of five, then paged decode
    steps over all five slots, teacher-forced, against the reference's
    commit_prefill + decode_step_paged on the same slots."""
    _, cfg, rmodel, model, rp, tp, _ = setup
    n_slots, slots = 5, [3, 0]
    toks, feed = _tokens(cfg, 2, 19), _tokens(cfg, n_slots, 4, seed=5)
    _, rc = rmodel.prefill(rp, jnp.asarray(toks), max_len=32)
    rpaged = rmodel.init_paged_cache(n_slots, 0, 0)
    rpaged = rmodel.commit_prefill(rpaged, rc, jnp.asarray(slots), {}, 0)
    with torch.no_grad():
        _, tc = model.prefill(tp, torch.as_tensor(toks), max_len=32)
        paged = model.init_paged_cache(n_slots, 0, 0, device="cpu")
        out = model.commit_prefill(paged, tc, slots, {}, 0)
        assert out is paged                                # in place
        for name in ("x_tmix", "x_cmix", "wkv"):
            _close(paged[f"state/sub0/{name}"], rpaged["state"]["sub0"][name],
                   f"committed {name}")
        steps = torch.zeros(n_slots, dtype=torch.int32)
        for i, t in enumerate(feed.T):
            rlog, rpaged = rmodel.decode_step_paged(
                rp, rpaged, jnp.asarray(t[:, None]), None, {}, 0)
            tlog, paged = model.decode_step_paged(
                tp, paged, torch.as_tensor(t[:, None]), steps, {}, 0)
            _close(tlog, rlog, f"paged decode step {i}")
    for name in ("x_tmix", "x_cmix", "wkv"):
        _close(paged[f"state/sub0/{name}"], rpaged["state"]["sub0"][name],
               f"state {name} after decode")


def test_helpers_match_reference(setup):
    """_shift, _channel_mix and the per-head groupnorm (eps 64e-5)."""
    _, cfg, _, _, _, tp, np_rp = setup
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(rwkv6._shift(torch.as_tensor(x)), r_rwkv6._shift(jnp.asarray(x)),
           "_shift")
    cm = {k: v[0] for k, v in np_rp["blocks"]["sub0"]["cmix"].items()}
    _close(rwkv6._channel_mix({k: torch.tensor(v) for k, v in cm.items()},
                              torch.as_tensor(x)),
           r_rwkv6._channel_mix({k: jnp.asarray(v) for k, v in cm.items()},
                                jnp.asarray(x)), "_channel_mix")
    w = {k: v[0] for k, v in np_rp["blocks"]["sub0"]["wkv"].items()}
    o = rng.standard_normal((2, 5, cfg.n_heads, cfg.head_dim)) \
        .astype(np.float32)
    _close(rwkv6._head_groupnorm({k: torch.tensor(v) for k, v in
                                  w.items()}, torch.as_tensor(o)),
           r_rwkv6._head_groupnorm({k: jnp.asarray(v) for k, v in w.items()},
                                   jnp.asarray(o)), "_head_groupnorm")


def test_get_model_families():
    cfg = get_config(ARCH).reduced()
    assert get_model(cfg).prefill is not None
    # the vlm family is the transformer's since it was ported
    vlm = get_model(get_config("internvl2-26b").reduced())
    assert vlm.prefill is not None and vlm.decode_step_paged is not None
    assert _FAMILY["vlm"] is transformer
