"""The port's whisper (the ``audio`` family) against ``repro.models.whisper``
on the same params (``convert.from_reference``), tokens and frames
(numpy), on reduced whisper-medium (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, enc_seq 16) in two cases: ``clip``, whose
``max_position`` of 8 makes the decoder's learned positions clip (as
whisper's 448 does past 448 tokens), and ``enc300``, 300 frames, which
send the encoder down ``attend``'s chunked branch.

* ``forward`` logits, ``loss_fn`` and every leaf of the loss gradient
  within 1e-4 (fp32 sums in another order through 4 layers; measured
  ~1e-6).
* ``prefill`` logits and caches, then five teacher-forced ``decode_step``
  logits (the decode's attention is ``decode_attend`` on CPU tensors,
  K4 on the card) within 1e-4; ``static_generate``'s greedy streams
  equal the reference's ``static_generate`` and its logits rows within
  1e-4.
* Full width on the meta device: the reference's ``eval_shape`` leaf for
  leaf, 760,348,672 params, 50 units (embed, 24 encoder, 24 decoder
  layers, head) as the reference's ``build_units``.
* The reference's outputs are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core.masking import LeafUnit as RLeafUnit
from repro.core.masking import build_units as r_build_units
from repro.models import get_model as r_get_model
from repro.serve.engine import static_generate as r_static_generate
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, is_conv_kernel, to_reference
from repro_torch.core import build_units
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps, train
from repro_torch.launch.shapes import InputShape
from repro_torch.models import get_model, whisper
from repro_torch.serve.engine import DecodeEngine, ServeConfig, \
    static_generate

ARCH = "whisper-medium"
TOL = 1e-4
B, S, MAX_LEN, FEED = 2, 6, 16, 5
CASES = {"clip": {"max_position": 8}, "enc300": {"enc_seq": 300}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0, err_msg=what)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The reference's outputs for one case, computed once."""
    torch.set_num_threads(1)
    rcfg = r_get_config(ARCH).reduced().replace(**CASES[request.param])
    cfg = get_config(ARCH).reduced().replace(**CASES[request.param])
    rmodel = r_get_model(rcfg)
    rp = rmodel.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    jt, jf = jnp.asarray(toks), jnp.asarray(frames)
    kw = {"attn_impl": "chunked", "q_chunk": 1024}
    logits = rmodel.forward(rp, jt, frames=jf, **kw)[0]
    batch = {"tokens": jt, "labels": jnp.asarray(labels), "frames": jf}
    loss, grads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, batch, **kw)[0])(rp)
    pre_logits, cache = rmodel.prefill(rp, jt, frames=jf, max_len=MAX_LEN,
                                       **kw)
    prefill = (np.asarray(pre_logits), _np(cache))
    fed = rng.integers(0, cfg.vocab, (FEED, B, 1), dtype=np.int32)
    steps_ = []
    for t in fed:
        out, cache = rmodel.decode_step(rp, cache, jnp.asarray(t))
        steps_.append(np.asarray(out))
    gen, rows = r_static_generate(rcfg, rp, jt, FEED + 1, max_len=MAX_LEN,
                                  collect_logits=True, extra={"frames": jf})
    return {"rcfg": rcfg, "cfg": cfg, "rp": rp, "tp": from_reference(_np(rp)),
            "toks": toks, "labels": labels, "frames": frames,
            "logits": np.asarray(logits), "loss": float(loss),
            "grads": from_reference(_np(grads)),
            "prefill": prefill,
            "fed": fed, "decode": steps_,
            "gen": (np.asarray(gen), [np.asarray(r) for r in rows])}


# ---------------------------------------------------------------------------
# config, params, units
# ---------------------------------------------------------------------------

def test_config_params_and_units_match_reference():
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(r_get_config(ARCH))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(r_get_config(ARCH).reduced())
    shapes = jax.eval_shape(
        lambda k: r_get_model(r_get_config(ARCH)).init_params(k),
        jax.random.PRNGKey(0))
    ref_shapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]}
    meta = get_model(full).init_params(steps._MetaGenerator())
    assert [tuple(x.shape) for x in meta.values()] == \
        list(ref_shapes.values())
    assert sum(x.numel() for x in meta.values()) == 760_348_672
    assert tuple(meta["enc_embed/pos"].shape) == (1_500, 1_024)
    assert tuple(meta["embed/pos"].shape) == (448, 1_024)
    assert tuple(meta["embed/table"].shape) == (51_968, 1_024)
    assign = build_units(full, meta)
    rassign = r_build_units(r_get_config(ARCH), shapes)
    assert (assign.n_units, assign.unit_names) == \
        (rassign.n_units, rassign.unit_names)
    assert assign.n_units == 50
    r_units = jax.tree_util.tree_leaves(
        rassign.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    assert [tuple(u) for u in assign.leaf_units.values()] == \
        [tuple(u) for u in r_units]


def test_convert_roundtrips_whisper_tree(case):
    """Every whisper leaf passes the converter as it is, both ways: the
    encoder and decoder stacks, the biases, both position tables, the
    encoder's final norm."""
    tp, cfg = case["tp"], case["cfg"]
    for path in ("enc_blocks/sub0/attn/wq", "blocks/sub0/xattn/wk",
                 "blocks/sub0/mlp/b_up", "enc_blocks/sub0/mlp/b_down",
                 "embed/pos", "enc_embed/pos", "enc_final_norm/b"):
        assert path in tp, path
    assert not any(is_conv_kernel(p) or "norm" in p.split("/")[-1]
                   for p in tp if "/xattn/" in p)
    assert tuple(tp["blocks/sub0/xattn/wq"].shape) == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    again = from_reference(to_reference(tp))
    assert list(again) == list(tp)
    assert all(torch.equal(again[p], x) for p, x in tp.items())


def test_init_params_match_reference_shapes(case):
    cfg, tp = case["cfg"], case["tp"]
    got = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    assert list(got) == list(tp)
    assert {p: x.shape for p, x in got.items()} == \
        {p: x.shape for p, x in tp.items()}
    assert all(bool((x == 0).all()) for p, x in got.items()
               if p.endswith(("/b_up", "/b_down")))
    assert float(got["embed/pos"].std()) == pytest.approx(0.02, rel=0.1)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _batch(case):
    return {"tokens": torch.as_tensor(case["toks"]),
            "labels": torch.as_tensor(case["labels"]),
            "frames": torch.as_tensor(case["frames"])}


def test_forward_and_loss_match(case):
    model = get_model(case["cfg"])
    got, aux, cache = model.forward(case["tp"],
                                    torch.as_tensor(case["toks"]),
                                    frames=torch.as_tensor(case["frames"]))
    _close(got, case["logits"], "forward logits")
    assert float(aux) == 0.0 and cache is None
    loss, parts = model.loss_fn(case["tp"], _batch(case))
    assert abs(float(loss) - case["loss"]) < TOL
    assert float(parts["xent"]) == float(loss)


def test_loss_gradient_matches(case):
    leaves = {p: x.clone().requires_grad_(True)
              for p, x in case["tp"].items()}
    loss, _ = get_model(case["cfg"]).loss_fn(leaves, _batch(case))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (path, _), g in zip(leaves.items(), grads):
        _close(g, case["grads"][path], f"d loss / d {path}")


def test_prefill_and_decode_match(case):
    cfg, tp = case["cfg"], case["tp"]
    model = get_model(cfg)
    logits, cache = model.prefill(tp, torch.as_tensor(case["toks"]),
                                  frames=torch.as_tensor(case["frames"]),
                                  max_len=MAX_LEN, attn_impl="chunked")
    want_logits, want = case["prefill"]
    _close(logits, want_logits, "prefill logits")
    assert int(cache["step"]) == S
    for name in ("k", "v", "xk", "xv"):
        _close(cache[f"subs/sub0/{name}"], want["subs"]["sub0"][name],
               f"prefill cache {name}")
    for i, (tok, ref) in enumerate(zip(case["fed"], case["decode"])):
        logits, cache = model.decode_step(tp, cache, torch.as_tensor(tok))
        _close(logits, ref, f"decode step {i}")
    assert int(cache["step"]) == S + FEED


def test_static_generate_matches_reference(case):
    want, rows = case["gen"]
    got, mine = static_generate(
        case["cfg"], case["tp"], case["toks"], FEED + 1, max_len=MAX_LEN,
        collect_logits=True, device="cpu",
        extra={"frames": case["frames"]})
    np.testing.assert_array_equal(got, want)
    for t, (a, b) in enumerate(zip(mine, rows)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                   err_msg=f"step {t}")


def test_remat_is_bitwise(case):
    model = get_model(case["cfg"])
    out = []
    for remat in (False, True):
        leaves = {p: x.clone().requires_grad_(True)
                  for p, x in case["tp"].items()}
        loss, _ = model.loss_fn(leaves, _batch(case), remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_decode_attention_dispatch(monkeypatch):
    """CPU tensors take ``decode_attend``; the K4 wrapper is reached only
    for CUDA tensors (the card test covers it)."""
    seen = []
    monkeypatch.setattr(whisper, "decode_attention",
                        lambda *a, **kw: seen.append(kw))
    q = torch.randn(2, 1, 4, 32)
    kc = torch.randn(2, 10, 4, 32)
    got = whisper._decode_attend(q, kc, kc, torch.tensor([3, 10],
                                                         dtype=torch.int32))
    assert seen == [] and tuple(got.shape) == (2, 1, 4, 32)


# ---------------------------------------------------------------------------
# serving and launchers
# ---------------------------------------------------------------------------

def test_no_paged_serving():
    cfg = get_config(ARCH).reduced()
    model = get_model(cfg)
    assert model.init_paged_cache is None and model.decode_step_paged is None
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="audio"):
        DecodeEngine(cfg, params, ServeConfig(n_slots=2, max_len=32),
                     device="cpu")


def test_prefill_step_feeds_frames(case):
    cfg, tp = case["cfg"], case["tp"]
    step = steps.make_prefill_step(cfg, InputShape("t", MAX_LEN, B, "prefill"),
                                   steps.default_loss_kwargs(cfg))
    logits, cache = step(tp, {"tokens": torch.as_tensor(case["toks"]),
                              "frames": torch.as_tensor(case["frames"])})
    _close(logits, case["prefill"][0][:, -1:], "prefill step logits")
    decode = steps.make_decode_step(cfg)
    logits, _ = decode(tp, cache, torch.as_tensor(case["fed"][0]))
    _close(logits, case["decode"][0], "decode step logits")


def test_serve_launcher_runs_whisper(capsys):
    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--engine", "static", "--batch", "2",
                         "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "static: prefill 2x8 + 4 tokens/seq" in out


def test_train_launcher_runs_whisper(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--clients",
                "2", "--rounds", "1", "--batch-size", "1",
                "--steps-per-round", "1", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} reduced=True units=6 train=3" in out
    assert "comm summary:" in out
