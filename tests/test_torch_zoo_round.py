"""The zoo federated round of the port against the reference's.

* ``lm_tokens`` / ``lm_batch``: array-equal.
* ``build_units_zoo``: the same unit count, names and ``LeafUnit`` of
  every leaf on reduced qwen3-1.7b, gemma3-12b (two sub-layers a macro
  block) and rwkv6-3b.
* The zoo loss and its gradients at ``attn_impl="chunked", q_chunk=64``
  and S=256 (chunked attention; gemma3's local layers windowed) within
  1e-5 of the reference on reduced qwen3-1.7b, gemma3-12b, qwen2.5-14b
  (QKV bias) and stablelm-3b (LayerNorm, 25% rotary), converted params
  and the same numpy tokens (measured ~1e-7); ``remat=True`` bitwise
  equal to ``remat=False`` inside the port.
* One ``Federation.from_config`` round of reduced qwen3-1.7b (2 clients,
  one local SGD step, the reference's selection replayed, its params
  injected) against the reference's round step: the dense hub through
  K1's plain version (``fused_agg="on"``) within 2e-5, and the packed
  qint8 round with the reference's rounding uniforms injected within 2e-5
  plus one quantization step of the leaf (a delta that differs in its
  last bits may round to the neighbouring code); billed bytes exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pytree as rpt
from repro.configs.base import get_config as r_get_config
from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core.codecs import CODEC_KEY_TAG, codec_unit_bytes
from repro.core.codecs import get_codec as r_get_codec
from repro.core.comm import hub_round_bytes, unit_bytes
from repro.core.masking import LeafUnit as RLeafUnit
from repro.core.masking import build_units as r_build_units
from repro.data import lm_batch as r_lm_batch
from repro.data import lm_tokens as r_lm_tokens
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference
from repro_torch.core import FLConfig, Federation, Replay, build_units
from repro_torch.data import lm_batch, lm_tokens
from repro_torch.models import get_model

LOSS_TOL = 1e-5
ROUND_TOL = 2e-5
C, S_ROUND, B_ROUND, LR = 2, 32, 2, 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=0):
    rcfg = r_get_config(arch).reduced()
    rp = r_get_model(rcfg).init_params(jax.random.PRNGKey(seed))
    return rcfg, get_config(arch).reduced(), rp, from_reference(_np(rp))


def test_lm_data_array_equal():
    for n, s, vocab, key in ((3, 17, 512, 0), (8, 64, 151_936, 5)):
        np.testing.assert_array_equal(lm_tokens(n, s, vocab, key=key),
                                      r_lm_tokens(n, s, vocab, key=key))
        got, want = lm_batch(n, s, vocab, key=key), \
            r_lm_batch(n, s, vocab, key=key)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "rwkv6-3b"])
def test_build_units_zoo_matches_reference(arch):
    rcfg, cfg, rp, tp = _setup(arch)
    ra = r_build_units(rcfg, rp)
    ta = build_units(cfg, tp)
    assert ta.n_units == ra.n_units
    assert ta.unit_names == ra.unit_names
    r_units = jax.tree_util.tree_leaves(
        ra.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    r_paths = [p for p, _ in rpt.flatten_with_paths(rp)]
    assert list(ta.leaf_units) == r_paths
    for path, lu in zip(r_paths, r_units):
        assert tuple(ta.leaf_units[path]) == tuple(lu), path
    if arch == "gemma3-12b":
        assert ta.leaf_units["blocks/sub1/attn/wq"] == ("stacked", 2, 2)


LOSS_ARCHS = ["qwen3-1.7b", "gemma3-12b", "qwen2.5-14b", "stablelm-3b"]


@pytest.fixture(scope="module")
def loss_cases():
    """The reference's loss and gradients, once per architecture."""
    out = {}
    for arch in LOSS_ARCHS:
        rcfg, cfg, rp, tp = _setup(arch)
        batch = lm_batch(2, 256, cfg.vocab, key=3)
        rmodel = r_get_model(rcfg)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            functools.partial(rmodel.loss_fn, attn_impl="chunked",
                              q_chunk=64), has_aux=True))(
            rp, jax.tree_util.tree_map(jnp.asarray, batch))
        out[arch] = (cfg, tp, batch, float(loss),
                     from_reference(_np(grads)))
    return out


def _port_loss(cfg, tp, batch, remat):
    leaves = {p: x.clone().requires_grad_(True) for p, x in tp.items()}
    loss, _ = get_model(cfg).loss_fn(
        leaves, {k: torch.as_tensor(v) for k, v in batch.items()},
        attn_impl="chunked", q_chunk=64, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_zoo_loss_and_grads_match_reference(loss_cases, arch):
    cfg, tp, batch, rloss, rgrads = loss_cases[arch]
    loss, grads = _port_loss(cfg, tp, batch, remat=False)
    assert abs(float(loss) - rloss) <= LOSS_TOL
    assert set(grads) == set(rgrads)
    for p, g in grads.items():
        np.testing.assert_allclose(g.numpy(), rgrads[p].numpy(),
                                   atol=LOSS_TOL, rtol=0, err_msg=p)
    loss_r, grads_r = _port_loss(cfg, tp, batch, remat=True)
    assert torch.equal(loss_r, loss)
    assert all(torch.equal(grads_r[p], grads[p]) for p in grads)


@pytest.fixture(scope="module")
def round_setup():
    rcfg, cfg, rp, tp = _setup("qwen3-1.7b")
    batch = lm_batch(C * B_ROUND, S_ROUND, cfg.vocab, key=7)
    batches = {k: v.reshape(C, 1, B_ROUND, S_ROUND) for k, v in batch.items()}
    return rcfg, cfg, rp, tp, batches


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "qint8"])
def test_zoo_federation_round_matches_reference(round_setup, packed):
    rcfg, cfg, rp, tp, batches = round_setup
    kw = dict(n_clients=C, train_fraction=0.5, lr=LR, optimizer="sgd")
    kw.update(dict(packed=True, codec="qint8") if packed
              else dict(fused_agg="on"))
    ra = r_build_units(rcfg, rp)
    key = jax.random.PRNGKey(5)
    step = jax.jit(r_build_round_step(
        r_get_model(rcfg).loss_fn, ra, RFLConfig(**kw),
        loss_kwargs={"attn_impl": "reference"}))
    new, m = step(rp, jax.tree_util.tree_map(jnp.asarray, batches),
                  jnp.ones(C), key)
    want = from_reference(_np(new))
    sel = np.asarray(m["sel"])

    fed = Federation.from_config(cfg, FLConfig(**kw), strategy=Replay([sel]),
                                 device="cpu")
    assert {p: x.shape for p, x in fed.server.params.items()} == \
        {p: x.shape for p, x in tp.items()}
    fed.server.params = {p: x.clone() for p, x in tp.items()}
    if packed:
        ck = jax.random.fold_in(key, CODEC_KEY_TAG)
        fed.server.codec_uniform = lambda i, shape: torch.tensor(
            np.asarray(jax.random.uniform(jax.random.fold_in(ck, i), shape,
                                          jnp.float32)))
    rec = fed.run_round({k: torch.as_tensor(v) for k, v in batches.items()})
    np.testing.assert_array_equal(fed.server.sel_history[0], sel)
    assert abs(rec.loss - float(m["loss_mean"])) <= ROUND_TOL
    got = fed.params
    for path, x in want.items():
        tol = ROUND_TOL
        if packed:
            # one code of the leaf's coarsest row: absmax / 127
            d = (x - tp[path]).reshape(x.shape[0], -1) if x.ndim > 1 \
                else (x - tp[path])
            tol += float(d.abs().max()) / 127.0
        err = float((got[path] - x).abs().max())
        assert err <= tol, (path, err, tol)
    ubytes = codec_unit_bytes(r_get_codec("qint8"), ra, rp,
                              RFLConfig(**kw)) if packed \
        else unit_bytes(ra, rp)
    assert rec.uplink_bytes == hub_round_bytes(sel, ubytes)["uplink"]
    assert rec.uplink_bytes > 0
