"""The port's VLM family (internvl2-26b: the dense transformer with a
patch projector) against ``repro.models.transformer`` on the same
params (``convert.from_reference``), tokens and patches (numpy), on
reduced internvl2-26b (2 layers, d_model 128, 4 heads over 2 of 32, 8
patches of width 128).

* The config field for field, and at full width on the meta device the
  reference's ``eval_shape`` leaf for leaf: 19,869,020,160 params, 50
  units, the projector in unit 0 (``build_units_zoo``).
* ``forward`` logits ``(B, n_patches + S, V)`` within 1e-4; ``loss_fn``
  on the text positions only and every leaf of its gradient within
  1e-5, ``remat`` bitwise; no patches raise ``ValueError``.
* ``prefill`` and five teacher-forced ``decode_step`` logits within
  1e-4, the cache's ``step`` counting the patches; prefill + decode
  equal to the full forward read at the patch offset; ``static_generate``
  streams equal to the reference's; ``make_prefill_step`` feeds patches.
* The paged engine refuses the family, as the reference's does.
* One ``Federation.from_config`` hub round against the reference's round
  step, dense (K1's plain version) and packed qint8 (the reference's
  uniforms injected) within 2e-5 (qint8: plus one code of the leaf).
* Both launchers at ``--reduced`` on the CPU; the training launcher's
  header and comm-summary keys equal the reference launcher's.
* The reference's outputs are computed once per module, on one torch
  thread.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core.codecs import CODEC_KEY_TAG, codec_unit_bytes
from repro.core.codecs import get_codec as r_get_codec
from repro.core.comm import hub_round_bytes, unit_bytes
from repro.core.masking import LeafUnit as RLeafUnit
from repro.core.masking import build_units as r_build_units
from repro.launch import train as r_train
from repro.models import get_model as r_get_model
from repro.serve.engine import static_generate as r_static_generate
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import FLConfig, Federation, Replay, build_units
from repro_torch.data import lm_batch
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps, train
from repro_torch.launch.shapes import InputShape
from repro_torch.models import get_model, transformer
from repro_torch.serve.engine import DecodeEngine, ServeConfig, \
    static_generate

ARCH = "internvl2-26b"
TOL = 1e-4
LOSS_TOL = 1e-5
ROUND_TOL = 2e-5
B, S, FEED = 2, 6, 5
C, S_ROUND, LR = 2, 8, 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs on reduced internvl2-26b, computed once."""
    torch.set_num_threads(1)
    rcfg, cfg = r_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    rmodel = r_get_model(rcfg)
    rp = jax.jit(rmodel.init_params)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S + FEED), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    patches = rng.normal(size=(B, cfg.n_patches, transformer.vit_width(cfg))
                         ).astype(np.float32)
    jt, jp = jnp.asarray(toks[:, :S]), jnp.asarray(patches)
    kw = {"attn_impl": "chunked", "q_chunk": 1024}
    logits = rmodel.forward(rp, jt, patches=jp, **kw)[0]
    full = rmodel.forward(rp, jnp.asarray(toks), patches=jp,
                          attn_impl="reference")[0]
    batch = {"tokens": jt, "labels": jnp.asarray(labels), "patches": jp}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, batch, **kw)[0]))(rp)
    max_len = cfg.n_patches + S + FEED + 2
    pre_logits, cache = rmodel.prefill(rp, jt, patches=jp, max_len=max_len,
                                       **kw)
    prefill = (np.asarray(pre_logits), _np(cache))
    decode, step = [], jax.jit(rmodel.decode_step)
    for t in range(S, S + FEED):
        out, cache = step(rp, cache, jnp.asarray(toks[:, t:t + 1]))
        decode.append(np.asarray(out))
    gen, rows = r_static_generate(rcfg, rp, jt, FEED + 1, max_len=max_len,
                                  collect_logits=True,
                                  extra={"patches": jp})
    return {"rcfg": rcfg, "cfg": cfg, "rp": rp, "tp": from_reference(_np(rp)),
            "toks": toks, "labels": labels, "patches": patches,
            "max_len": max_len, "logits": np.asarray(logits),
            "full": np.asarray(full), "loss": float(loss),
            "grads": from_reference(_np(grads)), "prefill": prefill,
            "decode": decode,
            "gen": (np.asarray(gen), [np.asarray(r) for r in rows])}


def _batch(ref):
    return {"tokens": torch.as_tensor(ref["toks"][:, :S]),
            "labels": torch.as_tensor(ref["labels"]),
            "patches": torch.as_tensor(ref["patches"])}


# ---------------------------------------------------------------------------
# config, params, units
# ---------------------------------------------------------------------------

def test_config_params_and_units_match_reference():
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(r_get_config(ARCH))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(r_get_config(ARCH).reduced())
    assert (full.family, full.n_patches, full.head_dim,
            full.n_heads // full.n_kv_heads) == ("vlm", 1024, 128, 6)
    shapes = jax.eval_shape(
        lambda k: r_get_model(r_get_config(ARCH)).init_params(k),
        jax.random.PRNGKey(0))
    ref_shapes = [tuple(s.shape) for _, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]]
    meta = get_model(full).init_params(steps._MetaGenerator())
    assert [tuple(x.shape) for x in meta.values()] == ref_shapes
    assert sum(x.numel() for x in meta.values()) == 19_869_020_160
    assert sum(int(np.prod(s)) for s in ref_shapes) == 19_869_020_160
    assert tuple(meta["projector/w"].shape) == (1024, 6144)
    assert tuple(meta["embed/table"].shape) == (92_672, 6144)
    assign = build_units(full, meta)
    rassign = r_build_units(r_get_config(ARCH), shapes)
    assert (assign.n_units, assign.unit_names) == \
        (rassign.n_units, rassign.unit_names)
    assert assign.n_units == 50
    r_units = jax.tree_util.tree_leaves(
        rassign.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    assert [tuple(u) for u in assign.leaf_units.values()] == \
        [tuple(u) for u in r_units]
    for p in ("projector/w", "projector/b", "embed/table"):
        assert tuple(assign.leaf_units[p]) == ("scalar", 0, 0), p


def test_convert_roundtrips_vlm_tree(ref):
    tp = ref["tp"]
    assert list(tp)[-2:] == ["projector/b", "projector/w"]
    again = from_reference(to_reference(tp))
    assert list(again) == list(tp)
    assert all(torch.equal(again[p], x) for p, x in tp.items())
    np.testing.assert_array_equal(to_reference(tp)["projector"]["w"],
                                  np.asarray(ref["rp"]["projector"]["w"]))


def test_init_params_match_reference_shapes(ref):
    cfg, tp = ref["cfg"], ref["tp"]
    got = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    assert list(got) == list(tp)
    assert {p: x.shape for p, x in got.items()} == \
        {p: x.shape for p, x in tp.items()}
    assert bool((got["projector/b"] == 0).all())
    w = got["projector/w"]
    assert tuple(w.shape) == (transformer.vit_width(cfg), cfg.d_model) \
        == (128, 128)
    assert float(w.std()) == pytest.approx(128 ** -0.5, rel=0.1)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_forward_and_loss_match(ref):
    cfg = ref["cfg"]
    model = get_model(cfg)
    got, aux, cache = model.forward(ref["tp"],
                                    torch.as_tensor(ref["toks"][:, :S]),
                                    patches=torch.as_tensor(ref["patches"]))
    assert tuple(got.shape) == (B, cfg.n_patches + S, cfg.padded_vocab)
    _close(got, ref["logits"], "forward logits")
    assert float(aux) == 0.0 and cache is None
    loss, parts = model.loss_fn(ref["tp"], _batch(ref))
    assert abs(float(loss) - ref["loss"]) <= LOSS_TOL
    assert float(parts["xent"]) == float(loss)


def test_loss_reads_the_text_positions_only(ref):
    """The loss is the mean cross-entropy of the text positions' logits;
    a patch offset one short of ``n_patches`` gives another value."""
    cfg = ref["cfg"]
    logits = torch.tensor(ref["logits"])
    labels = torch.tensor(ref["labels"]).long()

    def xent(rows):
        return float(torch.nn.functional.cross_entropy(
            rows.reshape(-1, rows.shape[-1]), labels.reshape(-1)))

    assert abs(xent(logits[:, cfg.n_patches:]) - ref["loss"]) <= LOSS_TOL
    assert abs(xent(logits[:, cfg.n_patches - 1:-1]) - ref["loss"]) \
        > 100 * LOSS_TOL


def test_loss_gradient_matches(ref):
    leaves = {p: x.clone().requires_grad_(True)
              for p, x in ref["tp"].items()}
    loss, _ = get_model(ref["cfg"]).loss_fn(leaves, _batch(ref))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (path, _), g in zip(leaves.items(), grads):
        _close(g, ref["grads"][path], f"d loss / d {path}", LOSS_TOL)
    assert float(ref["grads"]["projector/w"].abs().max()) > 100 * LOSS_TOL


def test_remat_is_bitwise(ref):
    model = get_model(ref["cfg"])
    out = []
    for remat in (False, True):
        leaves = {p: x.clone().requires_grad_(True)
                  for p, x in ref["tp"].items()}
        loss, _ = model.loss_fn(leaves, _batch(ref), remat=remat,
                                attn_impl="chunked")
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_missing_patches_raise(ref):
    model = get_model(ref["cfg"])
    toks = torch.as_tensor(ref["toks"][:, :S])
    with pytest.raises(ValueError, match="requires patch embeddings"):
        model.forward(ref["tp"], toks)
    with pytest.raises(ValueError, match="requires patch embeddings"):
        model.loss_fn(ref["tp"], {"tokens": toks,
                                  "labels": torch.as_tensor(ref["labels"])})


def test_prefill_and_decode_match(ref):
    cfg, tp = ref["cfg"], ref["tp"]
    model = get_model(cfg)
    logits, cache = model.prefill(tp, torch.as_tensor(ref["toks"][:, :S]),
                                  patches=torch.as_tensor(ref["patches"]),
                                  max_len=ref["max_len"],
                                  attn_impl="chunked")
    want_logits, want = ref["prefill"]
    _close(logits, want_logits, "prefill logits")
    assert int(cache["step"]) == cfg.n_patches + S
    for name in ("k", "v"):
        _close(cache[f"subs/sub0/{name}"], want["subs"]["sub0"][name],
               f"prefill cache {name}")
    steps_ = []
    for i, t in enumerate(range(S, S + FEED)):
        logits, cache = model.decode_step(
            tp, cache, torch.as_tensor(ref["toks"][:, t:t + 1]))
        _close(logits, ref["decode"][i], f"decode step {i}")
        steps_.append(logits[:, 0])
    assert int(cache["step"]) == cfg.n_patches + S + FEED
    # prefill + decode against the full forward, read at the patch offset
    got = torch.stack([torch.as_tensor(want_logits)[:, -1]] + steps_[:-1], 1)
    off = cfg.n_patches + S - 1
    _close(got, ref["full"][:, off:off + FEED], "decode vs full forward")


def test_static_generate_matches_reference(ref):
    want, rows = ref["gen"]
    got, mine = static_generate(
        ref["cfg"], ref["tp"], ref["toks"][:, :S], FEED + 1,
        max_len=ref["max_len"], collect_logits=True, device="cpu",
        extra={"patches": ref["patches"]})
    np.testing.assert_array_equal(got, want)
    for t, (a, b) in enumerate(zip(mine, rows)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                   err_msg=f"step {t}")


def test_prefill_step_feeds_patches(ref):
    cfg, tp = ref["cfg"], ref["tp"]
    step = steps.make_prefill_step(
        cfg, InputShape("t", ref["max_len"], B, "prefill"),
        steps.default_loss_kwargs(cfg))
    logits, cache = step(tp, {"tokens": torch.as_tensor(ref["toks"][:, :S]),
                              "patches": torch.as_tensor(ref["patches"])})
    _close(logits, ref["prefill"][0][:, -1:], "prefill step logits")
    decode = steps.make_decode_step(cfg)
    logits, _ = decode(tp, cache, torch.as_tensor(ref["toks"][:, S:S + 1]))
    _close(logits, ref["decode"][0], "decode step logits")


# ---------------------------------------------------------------------------
# serving, the round and the launchers
# ---------------------------------------------------------------------------

def test_paged_engine_refuses_vlm():
    cfg = get_config(ARCH).reduced()
    model = get_model(cfg)
    assert model.decode_step_paged is not None    # as the reference's API
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="vlm"):
        DecodeEngine(cfg, params, ServeConfig(n_slots=2, max_len=32),
                     device="cpu")


@pytest.fixture(scope="module")
def round_batches(ref):
    data = lm_batch(C, S_ROUND, ref["cfg"].vocab, key=7)
    data["patches"] = np.random.default_rng(8).normal(
        0, 1, (C, ref["cfg"].n_patches, transformer.vit_width(ref["cfg"]))
    ).astype(np.float32)
    return {k: v.reshape((C, 1, 1) + v.shape[1:]) for k, v in data.items()}


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "qint8"])
def test_federation_round_matches_reference(ref, round_batches, packed):
    rcfg, cfg, rp, tp = ref["rcfg"], ref["cfg"], ref["rp"], ref["tp"]
    kw = dict(n_clients=C, train_fraction=0.5, lr=LR, optimizer="sgd")
    kw.update(dict(packed=True, codec="qint8") if packed
              else dict(fused_agg="on"))
    ra = r_build_units(rcfg, rp)
    key = jax.random.PRNGKey(5)
    step = jax.jit(r_build_round_step(
        r_get_model(rcfg).loss_fn, ra, RFLConfig(**kw),
        loss_kwargs={"attn_impl": "reference"}))
    new, m = step(rp, jax.tree_util.tree_map(jnp.asarray, round_batches),
                  jnp.ones(C), key)
    want = from_reference(_np(new))
    sel = np.asarray(m["sel"])

    fed = Federation.from_config(cfg, FLConfig(**kw), strategy=Replay([sel]),
                                 device="cpu")
    fed.server.params = {p: x.clone() for p, x in tp.items()}
    if packed:
        ck = jax.random.fold_in(key, CODEC_KEY_TAG)
        fed.server.codec_uniform = lambda i, shape: torch.tensor(
            np.asarray(jax.random.uniform(jax.random.fold_in(ck, i), shape,
                                          jnp.float32)))
    rec = fed.run_round({k: torch.as_tensor(v)
                         for k, v in round_batches.items()})
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
    if sel[:, 0].any():                   # unit 0 trained: the projector
        assert not torch.equal(got["projector/w"], tp["projector/w"])
    ubytes = codec_unit_bytes(r_get_codec("qint8"), ra, rp,
                              RFLConfig(**kw)) if packed \
        else unit_bytes(ra, rp)
    assert rec.uplink_bytes == hub_round_bytes(sel, ubytes)["uplink"]
    assert rec.uplink_bytes > 0


def test_serve_launcher_runs_vlm(capsys):
    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--engine", "static", "--batch", "2",
                         "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "static: prefill 2x8 + 4 tokens/seq" in out
    with pytest.raises(ValueError, match="vlm"):
        serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--engine", "continuous", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4"])


def _header(out):
    line = next(x for x in out.splitlines() if x.startswith("arch="))
    return dict(tok.split("=", 1) for tok in line.split())


def _summary(out):
    import json
    return json.loads(out[out.index("comm summary:\n") + 14:
                          out.rindex("}") + 1])


def test_train_launcher_matches_reference_launcher(capsys, monkeypatch):
    argv = ["--arch", ARCH, "--reduced", "--clients", "2", "--rounds", "1",
            "--batch-size", "1", "--steps-per-round", "1", "--seq", "16"]
    train.main(["--device", "cpu", *argv])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    r_train.main()
    want = capsys.readouterr().out
    assert _header(got) == _header(want)
    assert f"arch={ARCH} reduced=True units=4 train=2" in got
    assert got.count("  round ") == 1
    g, w = _summary(got), _summary(want)
    assert set(g) == set(w)
    assert g["avg_uplink_bytes"] > 0 and 0 < g["reduction_vs_full"] < 1
