"""The port's MoE family (``models/moe.py`` and the MoE blocks of
``models/transformer.py``) against ``repro.models.moe`` and
``repro.models.transformer`` on the same params (``convert.from_reference``)
and the same numpy inputs.

* ``apply_moe`` on reduced granite's MoE (4 experts, top 2, d 128): the
  output and the aux loss within 2e-5 at the reduced config's dropless
  ``capacity_factor=8.0`` and at 1.25 on a batch where the reference drops
  copies (the test asserts it does, and the port keeps *the same* copies);
  the gradients of both through ``apply_moe`` within 2e-5.
* Reduced granite (2 layers): ``forward``, ``loss_fn`` (xent and aux),
  ``prefill`` and its KV cache, dense and teacher-forced paged decode
  within 1e-4; the engine's greedy streams equal the reference engine's;
  one ``Federation.from_config`` round within 2e-5 of the reference's
  round step.  Reduced llama4 (interleave 2: a dense block, then a MoE
  block of top 1 with the always-on shared expert) through ``forward``
  and ``loss_fn``.
* Counts: ``moe_param_count``, ``moe_active_param_count``, ``capacity_for``
  and the full-width parameter trees of both configs (meta device against
  the reference's ``eval_shape``: granite 1,334,756,352).

Routing near ties.  When the k-th and (k+1)-th router probabilities of a
token lie within rounding of each other the two packages may choose
different experts, and the output then differs by a whole expert's share.
Every comparison records the least such gap in the reference's run (a
``jax.debug.callback`` inside the reference's ``apply_moe``) and asserts
it is at least ``MARGIN`` times its tolerance, so a flip fails loudly.
With the reference's random router (0.02) a few hundred routing decisions
always hold gaps of 1e-5 and less, so the inputs make routing decisive by
construction instead: the first E coordinates of every embedding row
(of ``x`` for ``apply_moe``) hold a permutation of E evenly spaced codes,
no layer writes into those coordinates (their columns of ``attn/wo`` and
of every ``w_down`` are zero), and each router reads its expert's code
coordinate alone.  Every other weight is the reference's random draw.
"""
import contextlib
import dataclasses
import functools
import types

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
from repro.models import moe as r_moe
from repro.serve.engine import DecodeEngine as RDecodeEngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import FLConfig, Federation, Replay, build_units
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps, train
from repro_torch.models import get_model, moe, transformer
from repro_torch.serve.engine import DecodeEngine, ServeConfig

ARCH = "granite-moe-1b-a400m"
LLAMA4 = "llama4-maverick-400b-a17b"
MOE_TOL = 2e-5
TOL = 1e-4
ROUND_TOL = 2e-5
MARGIN = 100           # the least routing gap over a comparison's tolerance
PS = 16
PROMPT, MAX_LEN, FEED = 20, 32, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _codes(rng, rows, e, spacing, skew=0.0):
    """(rows, e): each row a permutation of e evenly spaced codes (centred
    on 0); with ``skew``, that share of the rows ranks expert 0 first."""
    out = np.empty((rows, e))
    for i in range(rows):
        perm = rng.permutation(e)               # expert j's code: perm[j]
        if rng.random() < skew:
            j = int(np.argmax(perm == e - 1))
            perm[[0, j]] = perm[[j, 0]]
        out[i] = perm
    return (out - (e - 1) / 2) * spacing


def _decisive(cfg, tp, seed=0, spacing=0.1, scale=5.0):
    """``tp`` with decisive routing (module docstring): embedding codes on
    the first E coordinates, those coordinates written by no layer, and
    each router reading its expert's coordinate at ``scale``."""
    e = cfg.moe.num_experts
    out = {p: x.clone() for p, x in tp.items()}
    table = out["embed/table"]
    table[:, :e] = torch.as_tensor(_codes(np.random.default_rng(seed),
                                          table.shape[0], e, spacing),
                                   dtype=table.dtype)
    for p, x in out.items():
        if p.endswith("/attn/wo") or p.endswith("/w_down"):
            x[..., :e] = 0
        if p.endswith("/moe/router"):
            x.zero_()
            x[:, torch.arange(e), torch.arange(e)] = scale
    return out


@contextlib.contextmanager
def _ref_margins():
    """Patch the reference's ``apply_moe`` (for functions traced inside
    the block) to report each call's least gap between the k-th and the
    (k+1)-th router probability; yields the list of gaps."""
    gaps = []
    orig = r_moe.apply_moe

    def wrapped(p, x, mcfg, **kw):
        k = mcfg.top_k
        probs = jax.nn.softmax((x.reshape(-1, x.shape[-1]) @ p["router"])
                               .astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(np.min(g))),
                           jnp.min(top[:, k - 1] - top[:, k]))
        return orig(p, x, mcfg, **kw)

    r_moe.apply_moe = wrapped
    try:
        yield gaps
    finally:
        r_moe.apply_moe = orig


def _assert_margin(gaps, tol):
    assert gaps, "the reference recorded no routing"
    assert min(gaps) >= MARGIN * tol, \
        f"routing gap {min(gaps)} < {MARGIN} x {tol}: a near tie"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    fastest.  Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

def _meta_and_shapes(name):
    shapes = jax.eval_shape(
        lambda k: r_get_model(r_get_config(name)).init_params(k),
        jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    meta = get_model(get_config(name)).init_params(steps._MetaGenerator())
    return shapes, want, meta


@pytest.mark.parametrize("name,n_params", [(ARCH, 1_334_756_352),
                                           (LLAMA4, None)])
def test_configs_and_full_width_params_match_reference(name, n_params):
    full = get_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(r_get_config(name))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(r_get_config(name).reduced())
    shapes, want, meta = _meta_and_shapes(name)
    assert [tuple(x.shape) for x in meta.values()] == list(want.values())
    assert list(meta) == list(from_reference(jax.tree_util.tree_map(
        lambda s: np.zeros((1,) * len(s.shape)), shapes)))
    total = sum(int(np.prod(s)) for s in want.values())
    assert sum(x.numel() for x in meta.values()) == total
    if n_params is not None:
        assert total == n_params
    mcfg = full.moe
    for fn, rfn in ((moe.moe_param_count, r_moe.moe_param_count),
                    (moe.moe_active_param_count,
                     r_moe.moe_active_param_count)):
        assert fn(full.d_model, mcfg) == rfn(full.d_model, mcfg)
    per_layer = sum(x[0].numel() for p, x in meta.items()
                    if "/moe/" in p)
    assert per_layer == moe.moe_param_count(full.d_model, mcfg)


def test_granite_units_match_reference():
    """26 units: embed, 24 layers, head; the head holds ``final_norm``
    alone (the embeddings are tied)."""
    shapes, _, meta = _meta_and_shapes(ARCH)
    assign = build_units(get_config(ARCH), meta)
    rassign = r_build_units(r_get_config(ARCH), shapes)
    assert (assign.n_units, assign.unit_names) == \
        (rassign.n_units, rassign.unit_names)
    assert assign.n_units == 26
    r_units = jax.tree_util.tree_leaves(
        rassign.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    assert [tuple(u) for u in assign.leaf_units.values()] == \
        [tuple(u) for u in r_units]
    assert [p for p, u in assign.leaf_units.items() if u.base == 25] == \
        ["final_norm/w"]


@pytest.mark.parametrize("t", [8, 16, 128, 1024, 4 * 1536, 4096, 13])
def test_capacity_for_matches_reference(t):
    for e, k, cf in ((32, 8, 1.25), (4, 2, 8.0), (4, 1, 1.25)):
        assert moe.capacity_for(t, e, k, cf) == r_moe.capacity_for(t, e, k,
                                                                   cf)
    assert [moe.capacity_for(n, 32, 8) for n in (128, 1024, 8, 16, 6144)] \
        == [40, 320, 8, 8, 1920]


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

CF = {"dropless": 8.0, "drops": 1.25}


@pytest.fixture(scope="module")
def moe_case():
    """Reduced granite's MoE at d 128 on 64 tokens, three of four of them
    ranking expert 0 first (so that at capacity factor 1.25 its 40 slots
    overflow); the reference's outputs, gradients and kept copies at both
    capacity factors, once."""
    cfg = get_config(ARCH).reduced()
    mcfg, d = cfg.moe, cfg.d_model
    e, k = mcfg.num_experts, mcfg.top_k
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    x[..., :e] = _codes(rng, 64, e, 0.5, skew=0.75).reshape(2, 32, e)
    router = np.zeros((d, e), np.float32)
    router[np.arange(e), np.arange(e)] = 4.0
    p = {"router": router,
         "w_gate": (rng.standard_normal((e, d, mcfg.expert_d_ff))
                    / np.sqrt(d)).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, mcfg.expert_d_ff))
                  / np.sqrt(d)).astype(np.float32),
         "w_down": (rng.standard_normal((e, mcfg.expert_d_ff, d))
                    / np.sqrt(mcfg.expert_d_ff)).astype(np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)
    out = {"mcfg": mcfg, "x": x, "p": p, "g": g}
    xf = jnp.asarray(x.reshape(-1, d))
    probs = jax.nn.softmax((xf @ jnp.asarray(router)).astype(jnp.float32))
    top, topi = jax.lax.top_k(probs, k + 1)
    out["gaps"] = [float(jnp.min(top[:, k - 1] - top[:, k]))]
    rank = r_moe._rank_within(topi[:, :k].reshape(-1), e)
    for name, cf in CF.items():
        def f(pp, xx, cf=cf):
            y, aux = r_moe.apply_moe(pp, xx, mcfg, capacity_factor=cf)
            return jnp.sum(y * jnp.asarray(g)) + 3.0 * aux, (y, aux)

        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(_jnp(p), jnp.asarray(x))
        cap = r_moe.capacity_for(64, e, k, cf)
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "grads": _np(grads), "cap": cap,
                     "keep": np.asarray(rank < cap)}
    return out


def _port_moe(case, cf, grad=False):
    p = {n: torch.tensor(v, requires_grad=grad) for n, v in case["p"].items()}
    x = torch.tensor(case["x"], requires_grad=grad)
    with moe.trace_routing() as trace:
        y, aux = moe.apply_moe(p, x, case["mcfg"], capacity_factor=cf)
    return p, x, y, aux, trace


@pytest.mark.parametrize("name", sorted(CF))
def test_apply_moe_matches_reference(moe_case, name):
    want = moe_case[name]
    _assert_margin(moe_case["gaps"], MOE_TOL)
    moe.reset_dropped()
    _, _, y, aux, trace = _port_moe(moe_case, CF[name])
    n_drop = int((~want["keep"]).sum())
    assert (n_drop > 0) == (name == "drops"), n_drop
    assert len(trace) == 1
    np.testing.assert_array_equal(trace[0]["keep"].numpy(), want["keep"])
    assert moe.dropped_copies() == n_drop
    _close(y, want["y"], "apply_moe output", MOE_TOL)
    assert abs(float(aux) - want["aux"]) <= MOE_TOL


@pytest.mark.parametrize("name", sorted(CF))
def test_apply_moe_grads_match_reference(moe_case, name):
    want = moe_case[name]
    p, x, y, aux, _ = _port_moe(moe_case, CF[name], grad=True)
    obj = (y * torch.as_tensor(moe_case["g"])).sum() + 3.0 * aux
    grads = torch.autograd.grad(obj, [x, *p.values()])
    _close(grads[0], want["grads"][1], "d x", MOE_TOL)
    for (n, _), gp in zip(p.items(), grads[1:]):
        _close(gp, want["grads"][0][n], f"d {n}", MOE_TOL)
    if name == "drops":
        # a token whose copies were all dropped passes nothing back
        keep = want["keep"].reshape(64, -1)
        gone = np.flatnonzero(~keep.any(1))
        assert bool((grads[0].reshape(64, -1)[gone] == 0).all())


def test_apply_moe_sharded_and_counter():
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg.d_model, cfg.moe, torch.float32)
    assert {n: tuple(v.shape) for n, v in p.items()} == {
        "router": (128, 4), "w_gate": (4, 128, 64), "w_up": (4, 128, 64),
        "w_down": (4, 64, 128)}
    assert float(p["router"].std()) == pytest.approx(0.02, rel=0.1)
    x = torch.randn(1, 16, cfg.d_model, generator=gen)
    moe.reset_dropped()
    y, aux = moe.apply_moe_sharded(p, x, cfg.moe, mesh=None,
                                   capacity_factor=0.25)
    y2, aux2 = moe.apply_moe(p, x, cfg.moe, capacity_factor=0.25)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    # 32 copies into 4 experts of capacity_for(16, 4, 2, 0.25) = 4 slots
    assert moe.capacity_for(16, 4, 2, 0.25) == 4
    assert moe.dropped_copies() == 2 * (32 - 16)
    moe.reset_dropped()
    assert moe.dropped_copies() == 0
    # a mesh with no model axis has nowhere to put the experts
    with pytest.raises(ValueError, match="'model' axis"):
        moe.apply_moe_sharded(p, x, cfg.moe, mesh=types.SimpleNamespace(
            shape={"data": 1}))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

SLOTS, N_SLOTS = [2, 0], 3


def _paged_setup(cfg, n_slots, max_len, seed=0):
    layout = transformer.block_layout(cfg)
    rng = np.random.default_rng(seed)
    mps = [transformer.cache_alloc(cfg, s, max_len) // PS for s in layout]
    n_pages = 1 + n_slots * sum(mps) + 3
    perm = iter(rng.permutation(np.arange(1, n_pages)).tolist())
    tables = {f"sub{si}": np.asarray([[next(perm) for _ in range(mp)]
                                      for _ in range(n_slots)], np.int32)
              for si, mp in enumerate(mps)}
    return n_pages, tables


@functools.lru_cache(maxsize=None)
def _params(name):
    """Reduced ``name``: the reference's random draw made decisive
    (module docstring), as the port's flat tree and the reference's."""
    rcfg = r_get_config(name).reduced()
    rp = jax.jit(r_get_model(rcfg).init_params)(jax.random.PRNGKey(0))
    cfg = get_config(name).reduced()
    tp = _decisive(cfg, from_reference(_np(rp)))
    return rcfg, cfg, tp, _jnp(to_reference(tp))


@pytest.fixture(scope="module")
def case():
    """The reference's outputs on reduced granite, once."""
    rcfg, cfg, tp, rp = _params(ARCH)
    rmodel = r_get_model(rcfg)
    toks = _tokens(cfg.vocab, 2, PROMPT, 1)
    labels = _tokens(cfg.vocab, 2, PROMPT, 2)
    feed = _tokens(cfg.vocab, 2, FEED, 3)
    out = {"cfg": cfg, "tp": tp, "toks": toks, "labels": labels,
           "feed": feed}
    with _ref_margins() as gaps:
        logits, aux, _ = jax.jit(lambda p, t: rmodel.forward(
            p, t, attn_impl="reference"))(rp, jnp.asarray(toks))
        # the reference's loss_fn on these logits: xent, plus the aux
        xent = r_layers.softmax_xent(logits, jnp.asarray(labels))
        plog, rc = jax.jit(lambda p, t: rmodel.prefill(
            p, t, max_len=MAX_LEN, attn_impl="reference"))(
            rp, jnp.asarray(toks))
        out["cache"] = {f"subs/{n}/{k}": np.asarray(x)
                        for n, sub in rc["subs"].items()
                        for k, x in sub.items()}
        n_pages, tables = _paged_setup(cfg, N_SLOTS, MAX_LEN)
        jtab = {k: jnp.asarray(v) for k, v in tables.items()}
        paged = rmodel.commit_prefill(
            rmodel.init_paged_cache(N_SLOTS, n_pages, PS), rc,
            jnp.asarray(SLOTS), {k: v[np.asarray(SLOTS)]
                                 for k, v in jtab.items()}, PS)
        paged_step = jax.jit(rmodel.decode_step_paged, static_argnums=5)
        steps_ = np.zeros((N_SLOTS,), np.int32)
        steps_[SLOTS] = PROMPT
        plogs = []
        for i, t in enumerate(feed.T):
            tok = np.zeros((N_SLOTS, 1), np.int32)
            tok[SLOTS, 0] = t
            lg, paged = paged_step(rp, paged, jnp.asarray(tok),
                                   jnp.asarray(steps_ + i), jtab, PS)
            plogs.append(np.asarray(lg))
        decode = jax.jit(rmodel.decode_step)
        dlogs = []
        for t in feed.T:
            lg, rc = decode(rp, rc, jnp.asarray(t[:, None]))
            dlogs.append(np.asarray(lg))
    out.update(logits=np.asarray(logits), aux=float(aux),
               loss=float(xent + aux), xent=float(xent),
               prefill=np.asarray(plog),
               paged=(n_pages, tables, plogs), decode=dlogs, gaps=gaps)
    return out


def test_forward_and_loss_match(case):
    cfg, tp = case["cfg"], case["tp"]
    _assert_margin(case["gaps"], TOL)
    model = get_model(cfg)
    logits, aux, _ = model.forward(tp, torch.as_tensor(case["toks"]),
                                   attn_impl="reference")
    _close(logits, case["logits"], "forward logits")
    assert float(aux) > 0 and abs(float(aux) - case["aux"]) <= MOE_TOL
    loss, parts = model.loss_fn(
        tp, {"tokens": torch.as_tensor(case["toks"]),
             "labels": torch.as_tensor(case["labels"])},
        attn_impl="reference")
    assert abs(float(loss) - case["loss"]) < TOL
    assert abs(float(parts["xent"]) - case["xent"]) < TOL
    assert torch.equal(loss, parts["xent"] + parts["aux"])


def test_prefill_and_decode_match(case):
    """``prefill`` (logits, then the KV cache at PROMPT of MAX_LEN) and
    three dense decode steps."""
    cfg, tp = case["cfg"], case["tp"]
    _assert_margin(case["gaps"], TOL)
    model = get_model(cfg)
    logits, cache = model.prefill(tp, torch.as_tensor(case["toks"]),
                                  max_len=MAX_LEN, attn_impl="reference")
    _close(logits, case["prefill"], "prefill logits")
    assert set(cache) == set(case["cache"]) | {"step"}
    for key, x in case["cache"].items():
        _close(cache[key], x, f"prefill cache {key}")
    for i, t in enumerate(case["feed"].T):
        logits, cache = model.decode_step(tp, cache,
                                          torch.as_tensor(t[:, None]))
        _close(logits, case["decode"][i], f"decode step {i}")
    assert int(cache["step"]) == PROMPT + FEED


def test_paged_decode_teacher_forced(case):
    """The prefill scattered into slot rows 2 and 0 of 3 (row 1 idle: its
    token runs through ``apply_moe`` too) and into scattered pages; three
    teacher-forced paged steps."""
    cfg, tp = case["cfg"], case["tp"]
    _assert_margin(case["gaps"], TOL)
    model = get_model(cfg)
    n_pages, tables, want = case["paged"]
    _, cache = model.prefill(tp, torch.as_tensor(case["toks"]),
                             max_len=MAX_LEN, attn_impl="reference")
    ttab = {k: torch.as_tensor(v) for k, v in tables.items()}
    paged = model.commit_prefill(
        model.init_paged_cache(N_SLOTS, n_pages, PS, device="cpu"), cache,
        SLOTS, {k: v[SLOTS] for k, v in ttab.items()}, PS)
    steps_ = np.zeros((N_SLOTS,), np.int32)
    steps_[SLOTS] = PROMPT
    for i, t in enumerate(case["feed"].T):
        tok = np.zeros((N_SLOTS, 1), np.int32)
        tok[SLOTS, 0] = t
        logits, paged = model.decode_step_paged(
            tp, paged, torch.as_tensor(tok), torch.as_tensor(steps_ + i),
            ttab, PS)
        _close(logits[SLOTS], want[i][SLOTS], f"paged decode step {i}")


def test_remat_is_bitwise_and_aux_reaches_the_router():
    """``remat`` changes no bit of the loss or the gradients, and the aux
    loss flows into the gradient: the router's gradient of ``loss_fn``
    differs from that of its xent alone."""
    cfg = get_config(ARCH).reduced()
    tp = get_model(cfg).init_params(torch.Generator().manual_seed(2))
    toks = torch.as_tensor(_tokens(cfg.vocab, 2, 48, 4))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def run(remat, part=None):
        leaves = {p: x.clone().requires_grad_(True) for p, x in tp.items()}
        loss, parts = get_model(cfg).loss_fn(leaves, batch, remat=remat,
                                             attn_impl="chunked", q_chunk=16)
        obj = loss if part is None else parts[part]
        return loss, dict(zip(leaves, torch.autograd.grad(
            obj, list(leaves.values()))))

    loss, grads = run(False)
    loss_r, grads_r = run(True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(grads[p], grads_r[p]) for p in grads)
    _, xent_grads = run(False, "xent")
    router = "blocks/sub0/moe/router"
    assert not torch.equal(grads[router], xent_grads[router])
    assert all(float(g.abs().max()) > 0 for p, g in grads.items()
               if "/moe/" in p)


@pytest.mark.parametrize("name", [LLAMA4])
def test_llama4_interleaved_shared_expert_matches(name):
    """Reduced llama4: one macro block of a dense sub-layer and a MoE
    sub-layer (4 experts, top 1) with the shared MLP beside it."""
    rcfg, cfg, tp, rp = _params(name)
    layout = transformer.block_layout(cfg)
    assert [s.moe for s in layout] == [False, True]
    assert "blocks/sub0/mlp/w_up" in tp and "blocks/sub1/moe/router" in tp
    assert "blocks/sub1/shared/w_gate" in tp
    assert not any(p.startswith("blocks/sub1/mlp/") for p in tp)
    rmodel = r_get_model(rcfg)
    toks = _tokens(cfg.vocab, 2, PROMPT, 5)
    labels = _tokens(cfg.vocab, 2, PROMPT, 6)
    with _ref_margins() as gaps:
        logits, aux, _ = jax.jit(lambda p, t: rmodel.forward(
            p, t, attn_impl="reference"))(rp, jnp.asarray(toks))
    # the reference's loss_fn on these logits: xent, plus the aux
    loss = r_layers.softmax_xent(logits, jnp.asarray(labels)) + aux
    _assert_margin(gaps, TOL)
    model = get_model(cfg)
    got, gaux, _ = model.forward(tp, torch.as_tensor(toks),
                                 attn_impl="reference")
    _close(got, logits, "llama4 forward logits")
    assert abs(float(gaux) - float(aux)) <= MOE_TOL
    gloss, _ = model.loss_fn(tp, {"tokens": torch.as_tensor(toks),
                                  "labels": torch.as_tensor(labels)},
                             attn_impl="reference")
    assert abs(float(gloss) - float(loss)) < TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

N_REQ, GEN = 3, 6


def test_engine_streams_match_reference_engine():
    rcfg, cfg, tp, rp = _params(ARCH)
    prompts = _tokens(cfg.vocab, N_REQ, PROMPT, 7)
    with _ref_margins() as gaps:
        reng = RDecodeEngine(rcfg, rp, RServeConfig(
            n_slots=N_REQ, max_len=MAX_LEN + PS, page_size=PS,
            record_logits=True))
        for i in range(N_REQ):
            reng.submit(prompts[i], GEN)
        want = reng.run()
    _assert_margin(gaps, TOL)
    eng = DecodeEngine(cfg, tp, ServeConfig(
        n_slots=N_REQ, max_len=MAX_LEN + PS, page_size=PS,
        record_logits=True), device="cpu")
    for i in range(N_REQ):
        eng.submit(prompts[i], GEN)
    res = eng.run()
    for i in range(N_REQ):
        assert np.array_equal(res[i], want[i]), f"req {i}"
        np.testing.assert_allclose(np.stack(eng.logits_rows[i]),
                                   np.stack(reng.logits_rows[i]), atol=TOL,
                                   rtol=0, err_msg=f"request {i}")
    assert eng.decode_cache_size == 1


def test_serve_launcher_runs_granite(capsys):
    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--engine", "continuous", "--batch", "2",
                         "--requests", "3", "--prompt-len", "16", "--gen",
                         "4", "--gen-spread", "2"])
    assert "continuous: 3 requests x 2 slots" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the federated round
# ---------------------------------------------------------------------------

C, S_ROUND, B_ROUND, LR = 2, 32, 2, 2e-3


def test_federation_round_matches_reference():
    rcfg, cfg, tp, rp = _params(ARCH)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (C, 1, B_ROUND, S_ROUND + 1),
                        dtype=np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    kw = dict(n_clients=C, train_fraction=0.5, lr=LR, optimizer="sgd",
              fused_agg="on")
    ra = r_build_units(rcfg, rp)
    with _ref_margins() as gaps:
        step = jax.jit(r_build_round_step(
            r_get_model(rcfg).loss_fn, ra, RFLConfig(**kw),
            loss_kwargs={"attn_impl": "reference"}))
        new, m = step(rp, _jnp(batches), jnp.ones(C), jax.random.PRNGKey(5))
        new = _np(new)
    _assert_margin(gaps, ROUND_TOL)
    want = from_reference(new)
    sel = np.asarray(m["sel"])
    fed = Federation.from_config(cfg, FLConfig(**kw), strategy=Replay([sel]),
                                 device="cpu")
    assert fed.assign.n_units == 4
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


def test_train_launcher_runs_granite(capsys):
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--clients",
                "2", "--rounds", "1", "--batch-size", "1",
                "--steps-per-round", "1", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} reduced=True units=4 train=2" in out
    assert "comm summary:" in out
