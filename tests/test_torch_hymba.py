"""The port's hymba (the ``hybrid`` family) against ``repro.models.hymba``
on the same params (``convert.from_reference``) and the same numpy
tokens, on reduced hymba-1.5b (4 layers, d_model 128, window 64, one
global layer per macro block of 2, SSM state 8) at its GQA group of 2
(4 heads over 2) and at a group of 5 (10 heads over 2), the group of the
full-width model.

* ``forward`` logits and ``loss_fn`` within 1e-4 (fp32 sums in another
  order through 4 layers; measured ~1e-5).
* ``prefill`` (70 prompt tokens into ``max_len`` 96: the windowed subs'
  caches are rings of 64 that wrap) logits and its KV, conv and SSM
  caches within 1e-5 x max(1, max|ref|), the linear scan's bar; dense
  ``decode_step`` and teacher-forced ``decode_step_paged`` over scattered
  pages and slot rows (an idle slot between them) within 1e-4.
* The reduced engine's greedy streams equal ``repro.serve.engine.
  DecodeEngine``'s, its logits rows within 1e-4; inside the port the
  engine equals ``static_generate`` bitwise on the CPU, with and without
  the ring.
* One ``Federation.from_config`` round (2 clients, one SGD step, the
  reference's selection replayed, K1's plain version) within 2e-5 of
  the reference's round step; ``remat`` bitwise equal to none.
* The reference's outputs are computed once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core.masking import LeafUnit as RLeafUnit
from repro.core.masking import build_units as r_build_units
from repro.models import get_model as r_get_model
from repro.models import layers as r_layers
from repro.serve.engine import DecodeEngine as RDecodeEngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, is_conv_kernel, to_reference
from repro_torch.core import FLConfig, Federation, Replay, build_units
from repro_torch import serve_workload
from repro_torch.data import lm_batch
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps, train
from repro_torch.models import get_model, hymba
from repro_torch.serve.engine import DecodeEngine, ServeConfig, \
    static_generate

ARCH = "hymba-1.5b"
TOL = 1e-4
CACHE_TOL = 1e-5
ROUND_TOL = 2e-5
PS = 16
PROMPT, MAX_LEN, FEED = 70, 96, 3
GROUPS = {"group2": {}, "group5": {"n_heads": 10, "n_kv_heads": 2}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(group):
    """The reference's reduced params for one GQA group (its init
    compiled once: eager, it takes seconds)."""
    rcfg = r_get_config(ARCH).reduced().replace(**GROUPS[group])
    return rcfg, jax.jit(r_get_model(rcfg).init_params)(
        jax.random.PRNGKey(0))


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _paged_setup(cfg, n_slots, max_len, seed=0):
    """Page tables of ``n_slots`` rows with scattered physical pages (page
    0 = trash) for every slot."""
    layout = hymba.block_layout(cfg)
    rng = np.random.default_rng(seed)
    mps = [hymba.cache_alloc(cfg, s, max_len) // PS for s in layout]
    n_pages = 1 + n_slots * sum(mps) + 3
    perm = iter(rng.permutation(np.arange(1, n_pages)).tolist())
    tables = {f"sub{si}": np.asarray([[next(perm) for _ in range(mp)]
                                      for _ in range(n_slots)], np.int32)
              for si, mp in enumerate(mps)}
    return n_pages, tables


# the two sequences sit in slot rows 2 and 0 of 3; row 1 is idle (its
# tables point at the trash page, its step is 0)
SLOTS, N_SLOTS = [2, 0], 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    fastest, and keeps a worker of a parallel test run from contending
    with the others for every core.  Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(GROUPS))
def case(request):
    """The reference's params and outputs for one GQA group, once."""
    rcfg, rp = _ref_params(request.param)
    cfg = get_config(ARCH).reduced().replace(**GROUPS[request.param])
    rmodel = r_get_model(rcfg)
    toks = _tokens(cfg.vocab, 2, PROMPT, 1)
    labels = _tokens(cfg.vocab, 2, PROMPT, 2)
    feed = _tokens(cfg.vocab, 2, FEED, 3)
    out = {"rcfg": rcfg, "cfg": cfg, "toks": toks, "labels": labels,
           "feed": feed, "tp": from_reference(_np(rp))}
    # each function compiled once (jit) and run on every step's inputs
    forward = jax.jit(lambda p, t: rmodel.forward(
        p, t, attn_impl="reference")[0])
    prefill = jax.jit(lambda p, t: rmodel.prefill(
        p, t, max_len=MAX_LEN, attn_impl="reference"))
    decode = jax.jit(rmodel.decode_step)
    paged_step = jax.jit(rmodel.decode_step_paged, static_argnums=5)
    logits = forward(rp, jnp.asarray(toks))
    out["logits"] = np.asarray(logits)
    out["loss"] = float(r_layers.softmax_xent(logits, jnp.asarray(labels)))
    plog, rc = prefill(rp, jnp.asarray(toks))
    out["prefill"] = (np.asarray(plog), {
        f"subs/{n}/{k}": np.asarray(x) for n, sub in rc["subs"].items()
        for k, x in sub.items()})
    # teacher-forced paged decode from the same prefill, scattered slots
    n_pages, tables = _paged_setup(cfg, N_SLOTS, MAX_LEN)
    jtab = {k: jnp.asarray(v) for k, v in tables.items()}
    paged = rmodel.init_paged_cache(N_SLOTS, n_pages, PS)
    paged = rmodel.commit_prefill(
        paged, rc, jnp.asarray(SLOTS),
        {k: v[np.asarray(SLOTS)] for k, v in jtab.items()}, PS)
    steps_ = np.zeros((N_SLOTS,), np.int32)
    steps_[SLOTS] = PROMPT
    plogs = []
    for i, t in enumerate(feed.T):
        tok = np.zeros((N_SLOTS, 1), np.int32)
        tok[SLOTS, 0] = t
        lg, paged = paged_step(rp, paged, jnp.asarray(tok),
                               jnp.asarray(steps_ + i), jtab, PS)
        plogs.append(np.asarray(lg))
    out["paged"] = (n_pages, tables, plogs)
    dlogs = []
    for t in feed.T:
        lg, rc = decode(rp, rc, jnp.asarray(t[:, None]))
        dlogs.append(np.asarray(lg))
    out["decode"] = dlogs
    return out


def _scaled_close(got, want, what):
    want = np.asarray(want)
    tol = CACHE_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol,
                               rtol=0, err_msg=what)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# config, params, units
# ---------------------------------------------------------------------------

def test_config_params_and_units_match_reference():
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(r_get_config(ARCH))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(r_get_config(ARCH).reduced())
    assert hymba.ssm_dims(full) == (25, 128, 16, 4)
    shapes = jax.eval_shape(
        lambda k: r_get_model(r_get_config(ARCH)).init_params(k),
        jax.random.PRNGKey(0))
    want = {p: tuple(x.shape) for p, x in from_reference(
        jax.tree_util.tree_map(lambda s: np.zeros((1,) * len(s.shape)),
                               shapes)).items()}
    meta = get_model(full).init_params(steps._MetaGenerator())
    assert list(meta) == list(want)
    ref_shapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert [tuple(x.shape) for x in meta.values()] == \
        list(ref_shapes.values())
    assert sum(x.numel() for x in meta.values()) == 1_476_611_200
    assert tuple(meta["blocks/sub0/ssm/conv_w"].shape) == (4, 25, 128, 4)
    assert tuple(meta["embed/table"].shape) == (32_128, 1_600)
    # 8 sub-layers x 4 macro rows = 32 layer units, plus embed and head
    assign = build_units(full, meta)
    rassign = r_build_units(r_get_config(ARCH), shapes)
    assert (assign.n_units, assign.unit_names) == \
        (rassign.n_units, rassign.unit_names)
    assert assign.n_units == 34
    r_units = jax.tree_util.tree_leaves(
        rassign.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    assert [tuple(u) for u in assign.leaf_units.values()] == \
        [tuple(u) for u in r_units]


def test_convert_passes_every_hymba_leaf_through(case):
    """``ssm/conv_w`` is not a ``conv<N>/w`` kernel: the converter leaves
    it (and every other hymba leaf) in its layout, both ways."""
    tp = case["tp"]
    assert "blocks/sub0/ssm/conv_w" in tp
    assert not any(is_conv_kernel(p) for p in tp)
    back = to_reference(tp)
    again = from_reference(back)
    assert all(torch.equal(again[p], x) for p, x in tp.items())
    h, p, n, w = hymba.ssm_dims(case["cfg"])
    assert tuple(tp["blocks/sub0/ssm/conv_w"].shape) == (2, h, p, w)


def test_init_params_match_reference_shapes_and_scales(case):
    cfg, tp = case["cfg"], case["tp"]
    got = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    assert list(got) == list(tp)
    assert {p: x.shape for p, x in got.items()} == \
        {p: x.shape for p, x in tp.items()}
    ssm = {k.rsplit("/", 1)[-1]: v for k, v in got.items()
           if k.startswith("blocks/sub0/ssm/")}
    assert bool((ssm["dt_bias"] == -2).all()) and \
        bool((ssm["a_log"] == 0).all())
    assert bool((ssm["d_skip"] == 0.1).all())
    assert float(ssm["w_in"].std()) == pytest.approx(cfg.d_model ** -0.5,
                                                     rel=0.05)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_forward_and_loss_match(case):
    cfg, tp = case["cfg"], case["tp"]
    model = get_model(cfg)
    got, _, _ = model.forward(tp, torch.as_tensor(case["toks"]),
                              attn_impl="reference")
    _close(got, case["logits"], "forward logits")
    loss, _ = model.loss_fn(tp, {"tokens": torch.as_tensor(case["toks"]),
                                 "labels": torch.as_tensor(case["labels"])},
                            attn_impl="reference")
    assert abs(float(loss) - case["loss"]) < TOL


def test_prefill_and_caches_match(case):
    cfg, tp = case["cfg"], case["tp"]
    logits, cache = get_model(cfg).prefill(
        tp, torch.as_tensor(case["toks"]), max_len=MAX_LEN,
        attn_impl="reference")
    want_logits, want = case["prefill"]
    _scaled_close(logits, want_logits, "prefill logits")
    assert set(cache) == set(want) | {"step"}
    assert int(cache["step"]) == PROMPT
    for key, x in want.items():
        assert cache[key].dtype == (torch.float32 if key.endswith("ssm")
                                    else tp["embed/table"].dtype)
        _scaled_close(cache[key], x, f"prefill cache {key}")


def test_decode_step_matches(case):
    """Dense decode after the ring prefill: the windowed subs keep
    wrapping, the global ones grow."""
    cfg, tp = case["cfg"], case["tp"]
    model = get_model(cfg)
    _, cache = model.prefill(tp, torch.as_tensor(case["toks"]),
                             max_len=MAX_LEN, attn_impl="reference")
    for i, t in enumerate(case["feed"].T):
        logits, cache = model.decode_step(tp, cache, torch.as_tensor(
            t[:, None]))
        _close(logits, case["decode"][i], f"decode step {i}")
    assert int(cache["step"]) == PROMPT + FEED


def test_paged_decode_teacher_forced(case):
    """The reference's prefill state scattered into slot rows 2 and 0 of
    3 and into scattered pages (rings for the windowed subs); three
    teacher-forced paged steps over all 3 rows."""
    cfg, tp = case["cfg"], case["tp"]
    model = get_model(cfg)
    n_pages, tables, want = case["paged"]
    _, cache = model.prefill(tp, torch.as_tensor(case["toks"]),
                             max_len=MAX_LEN, attn_impl="reference")
    ttab = {k: torch.as_tensor(v) for k, v in tables.items()}
    paged = model.init_paged_cache(N_SLOTS, n_pages, PS, device="cpu")
    paged = model.commit_prefill(paged, cache, SLOTS,
                                 {k: v[SLOTS] for k, v in ttab.items()}, PS)
    steps_ = np.zeros((N_SLOTS,), np.int32)
    steps_[SLOTS] = PROMPT
    for i, t in enumerate(case["feed"].T):
        tok = np.zeros((N_SLOTS, 1), np.int32)
        tok[SLOTS, 0] = t
        logits, paged = model.decode_step_paged(
            tp, paged, torch.as_tensor(tok), torch.as_tensor(steps_ + i),
            ttab, PS)
        _close(logits[SLOTS], want[i][SLOTS], f"paged decode step {i}")


def test_paged_decode_equals_dense_decode_bitwise(case):
    """Inside the port on the CPU the paged step (plain gather + dense
    decode) equals the dense step bitwise, rings and states included."""
    cfg, tp = case["cfg"], case["tp"]
    model = get_model(cfg)
    b = 2
    n_pages, tables = _paged_setup(cfg, b, MAX_LEN, seed=1)
    ttab = {k: torch.as_tensor(v) for k, v in tables.items()}
    _, dense = model.prefill(tp, torch.as_tensor(case["toks"]),
                             max_len=MAX_LEN, attn_impl="reference")
    paged = model.commit_prefill(
        model.init_paged_cache(b, n_pages, PS, device="cpu"),
        {k: v.clone() for k, v in dense.items()}, [0, 1], ttab, PS)
    for i, t in enumerate(case["feed"].T):
        tok = torch.as_tensor(t[:, None])
        dlog, dense = model.decode_step(tp, dense, tok)
        plog, paged = model.decode_step_paged(
            tp, paged, tok, torch.full((b,), PROMPT + i, dtype=torch.int32),
            ttab, PS)
        assert torch.equal(dlog, plog), f"step {i}"
    for si in range(len(hymba.block_layout(cfg))):
        for kind in ("conv", "ssm"):
            assert torch.equal(paged[f"state/sub{si}/{kind}"],
                               dense[f"subs/sub{si}/{kind}"])


def test_remat_is_bitwise_and_grads_flow():
    cfg = get_config(ARCH).reduced()
    tp = get_model(cfg).init_params(torch.Generator().manual_seed(2))
    batch = {k: torch.as_tensor(v) for k, v in
             lm_batch(2, 64, cfg.vocab, key=4).items()}

    def run(remat):
        leaves = {p: x.clone().requires_grad_(True) for p, x in tp.items()}
        loss, _ = get_model(cfg).loss_fn(leaves, batch, attn_impl="chunked",
                                         q_chunk=32, remat=remat)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    loss, grads = run(False)
    loss_r, grads_r = run(True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))
    names = list(tp)
    for p, g in zip(names, grads):
        if "/ssm/" in p or "/attn/" in p:
            assert float(g.abs().max()) > 0, p


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

N_REQ, GEN = 3, 6


@pytest.fixture(scope="module")
def engine_ref():
    """The reference engine on reduced hymba, prompts past the window
    (ring pages wrap)."""
    rcfg, rp = _ref_params("group2")
    prompts = _tokens(rcfg.vocab, N_REQ, PROMPT, 5)
    eng = RDecodeEngine(rcfg, rp, RServeConfig(
        n_slots=N_REQ, max_len=MAX_LEN, page_size=PS, record_logits=True))
    for i in range(N_REQ):
        eng.submit(prompts[i], GEN)
    return {"tp": from_reference(_np(rp)), "prompts": prompts,
            "greedy": eng.run(), "rows": eng.logits_rows}


def _engine(cfg, params, n_slots, max_len):
    return DecodeEngine(cfg, params, ServeConfig(
        n_slots=n_slots, max_len=max_len, page_size=PS, record_logits=True),
        device="cpu")


def test_engine_streams_match_reference_engine(engine_ref):
    cfg = get_config(ARCH).reduced()
    eng = _engine(cfg, engine_ref["tp"], N_REQ, MAX_LEN)
    assert any(s.ring for s in eng.layout.subs) and eng.layout.has_state
    for i in range(N_REQ):
        eng.submit(engine_ref["prompts"][i], GEN)
    res = eng.run()
    for i in range(N_REQ):
        assert np.array_equal(res[i], engine_ref["greedy"][i]), f"req {i}"
        np.testing.assert_allclose(np.stack(eng.logits_rows[i]),
                                   np.stack(engine_ref["rows"][i]), atol=TOL,
                                   rtol=0, err_msg=f"request {i}")
    assert eng.decode_cache_size == 1


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("prompt,max_len", [(24, 48), (PROMPT, MAX_LEN)],
                         ids=["no_ring", "ring"])
def test_engine_equals_static_bitwise(group, prompt, max_len):
    cfg = get_config(ARCH).reduced().replace(**GROUPS[group])
    params = get_model(cfg).init_params(torch.Generator().manual_seed(3))
    prompts = _tokens(cfg.vocab, N_REQ, prompt, 6)
    eng = _engine(cfg, params, N_REQ, max_len)
    assert any(s.ring for s in eng.layout.subs) == (max_len > 64)
    for i in range(N_REQ):
        eng.submit(prompts[i], GEN)
    res = eng.run()
    out, rows = static_generate(cfg, params, prompts, GEN,
                                max_len=eng.layout.max_len,
                                collect_logits=True, device="cpu")
    for i in range(N_REQ):
        assert np.array_equal(res[i], out[i])
        assert np.array_equal(np.stack(eng.logits_rows[i]),
                              np.stack([r[i] for r in rows]))
    assert eng.decode_cache_size == 1


@pytest.mark.parametrize("traffic,steps_,prefills", [("serving", 84, 9),
                                                     ("long", 63, 1)])
def test_serve_workload_traffic_decode_steps(traffic, steps_, prefills):
    """The scheduler's decode steps and prefill calls under each traffic
    of ``serve_workload`` (what ``chip_smoke.py`` predicts K3's and K5's
    launches from) depend on the traffic alone: the reduced model under
    the same traffic counts them."""
    t = serve_workload.TRAFFIC[traffic]
    cfg = get_config(ARCH).reduced().replace(max_position=8192)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    gens = [t.gen + i % t.gen_spread for i in range(t.n_requests)]
    eng = DecodeEngine(cfg, params, ServeConfig(
        n_slots=t.n_slots, max_len=t.prompt_len + max(gens) + 8,
        page_size=serve_workload.PAGE_SIZE, attn_impl=t.attn_impl),
        device="cpu")
    prompts = _tokens(cfg.vocab, t.n_requests, t.prompt_len, 8)
    for i, g in enumerate(gens):
        eng.submit(prompts[i], g)
    res = eng.run()
    st = eng.stats()
    assert (st["n_decode_steps"], st["n_prefill_calls"]) == (steps_, prefills)
    assert [len(res[i]) for i in range(t.n_requests)] == gens


def test_serve_launcher_runs_hymba(capsys):
    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--engine", "continuous", "--batch", "2",
                         "--requests", "3", "--prompt-len", "16", "--gen",
                         "4", "--gen-spread", "2"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests x 2 slots" in out


# ---------------------------------------------------------------------------
# the federated round
# ---------------------------------------------------------------------------

C, S_ROUND, B_ROUND, LR = 2, 32, 2, 2e-3


def test_federation_round_matches_reference():
    rcfg, rp = _ref_params("group2")
    cfg = get_config(ARCH).reduced()
    tp = from_reference(_np(rp))
    batch = lm_batch(C * B_ROUND, S_ROUND, cfg.vocab, key=7)
    batches = {k: v.reshape(C, 1, B_ROUND, S_ROUND) for k, v in batch.items()}
    kw = dict(n_clients=C, train_fraction=0.5, lr=LR, optimizer="sgd",
              fused_agg="on")
    ra = r_build_units(rcfg, rp)
    step = jax.jit(r_build_round_step(
        r_get_model(rcfg).loss_fn, ra, RFLConfig(**kw),
        loss_kwargs={"attn_impl": "reference"}))
    new, m = step(rp, jax.tree_util.tree_map(jnp.asarray, batches),
                  jnp.ones(C), jax.random.PRNGKey(5))
    want = from_reference(_np(new))
    sel = np.asarray(m["sel"])

    fed = Federation.from_config(cfg, FLConfig(**kw), strategy=Replay([sel]),
                                 device="cpu")
    assert fed.assign.n_units == 6
    fed.server.params = {p: x.clone() for p, x in tp.items()}
    rec = fed.run_round({k: torch.as_tensor(v) for k, v in batches.items()})
    np.testing.assert_array_equal(fed.server.sel_history[0], sel)
    assert abs(rec.loss - float(m["loss_mean"])) <= ROUND_TOL
    moved = 0
    for path, x in want.items():
        err = float((fed.params[path] - x).abs().max())
        assert err <= ROUND_TOL, (path, err)
        moved += int(not torch.equal(x, tp[path]))
    assert moved > 0


def test_train_launcher_runs_hymba(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--clients",
                "2", "--rounds", "1", "--batch-size", "1",
                "--steps-per-round", "1", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} reduced=True units=6 train=3" in out
    assert "comm summary:" in out
