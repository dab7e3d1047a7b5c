"""The packed MoE round: ``Federation.from_config`` on reduced
granite-moe-1b-a400m with ``packed=True, codec="qint8"`` against the
reference's round step, on the same params, batches and selection, with
the reference's rounding uniforms injected (``Server.codec_uniform``).

* The expert leaves ``(n_macro, E, d, ff)`` ship one slot row of
  ``E·d·ff`` elements a trained layer.  The round makes one grouped
  ``quantize_pack_group`` call over every leaf; its codes and scales on
  the expert leaves are bitwise the reference's ``quantize_pack`` (the
  Pallas kernel in interpret mode) on the same rows and uniforms, and the
  reference's codec transform on the round's own packed deltas decodes
  bitwise to the port's.
* The params within 2e-5 of the reference's, and the billed bytes equal
  ``hub_round_bytes`` over the reference's ``codec_unit_bytes`` and the
  closed form ``Σ rows · (P + 4)`` of the selected units.
* Routing is made decisive (the params of ``test_torch_moe.py``: the
  first E embedding coordinates carry codes no layer writes, each router
  reads one), and the reference's least gap between a token's k-th and
  (k+1)-th router probability is at least 100 x the tolerance, so a near
  tie cannot pass for a fault.
* The reference's round is computed once per module, on one torch thread.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core import FLConfig as RFLConfig
from repro.core import build_round_step as r_build_round_step
from repro.core import codecs as rcodecs
from repro.core.codecs import CODEC_KEY_TAG
from repro.core.comm import hub_round_bytes
from repro.core.masking import build_units as r_build_units
from repro.kernels.codec import quantize_pack as r_quantize_pack
from repro.models import get_model as r_get_model
from repro.models import moe as r_moe
from repro_torch.common import unflatten
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import FLConfig, Federation, Replay
from repro_torch.core import codecs, topology

ARCH = "granite-moe-1b-a400m"
ROUND_TOL = 2e-5
MARGIN = 100
C, S_ROUND, B_ROUND, LR = 2, 32, 2, 2e-3
FL_KW = dict(n_clients=C, train_fraction=0.5, lr=LR, optimizer="sgd",
             packed=True, codec="qint8")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _decisive(cfg, tp, spacing=0.1, scale=5.0):
    """Decisive routing, as ``test_torch_moe._decisive``: each embedding
    row's first E coordinates a permutation of E codes ``spacing`` apart,
    no layer writing there, each router reading its expert's code."""
    e = cfg.moe.num_experts
    rng = np.random.default_rng(0)
    out = {p: x.clone() for p, x in tp.items()}
    table = out["embed/table"]
    codes = np.stack([rng.permutation(e) for _ in range(table.shape[0])])
    table[:, :e] = torch.as_tensor((codes - (e - 1) / 2) * spacing,
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
    """The reference's least gap between each token's k-th and (k+1)-th
    router probability, per ``apply_moe`` call traced inside the block."""
    gaps, orig = [], r_moe.apply_moe

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


@pytest.fixture(scope="module")
def case():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    rcfg, cfg = r_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    rp0 = jax.jit(r_get_model(rcfg).init_params)(jax.random.PRNGKey(0))
    tp = _decisive(cfg, from_reference(_np(rp0)))
    rp = _jnp(to_reference(tp))
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab, (C, 1, B_ROUND, S_ROUND + 1), dtype=np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    ra = r_build_units(rcfg, rp)
    key = jax.random.PRNGKey(5)
    with _ref_margins() as gaps:
        step = jax.jit(r_build_round_step(
            r_get_model(rcfg).loss_fn, ra, RFLConfig(**FL_KW),
            loss_kwargs={"attn_impl": "reference"}))
        new, m = step(rp, _jnp(batches), jnp.ones(C), key)
        new = _np(new)
    sel = np.asarray(m["sel"])

    # the port: the reference's selection and uniforms; the codec
    # transform's inputs and outputs and the grouped encode recorded
    ck = jax.random.fold_in(key, CODEC_KEY_TAG)
    seen, grouped = [], []
    build, encode = codecs.build_codec_transform, codecs.quantize_pack_group

    def recording(codec, assign, fl_):
        fn = build(codec, assign, fl_)

        def transform(pdeltas, rows, valid, weights, *a, **k):
            out = fn(pdeltas, rows, valid, weights, *a, **k)
            seen.append((pdeltas, rows, valid, weights, out[0]))
            return out
        return transform

    def group(xs, us, bits):
        out = encode(xs, us, bits)
        grouped.append((xs, us, out))
        return out

    topology._codecs.build_codec_transform = recording
    codecs.quantize_pack_group = group
    try:
        fed = Federation.from_config(cfg, FLConfig(**FL_KW),
                                     strategy=Replay([sel]), device="cpu")
        fed.server.params = {p: x.clone() for p, x in tp.items()}
        fed.server.codec_uniform = lambda i, shape: torch.tensor(
            np.asarray(jax.random.uniform(jax.random.fold_in(ck, i), shape,
                                          jnp.float32)))
        rec = fed.run_round({k: torch.as_tensor(v)
                             for k, v in batches.items()})
    finally:
        topology._codecs.build_codec_transform = build
        codecs.quantize_pack_group = encode
    torch.set_num_threads(before)
    return dict(rcfg=rcfg, cfg=cfg, tp=tp, rp=rp, ra=ra, sel=sel, ck=ck,
                want=from_reference(new), loss=float(m["loss_mean"]),
                gaps=gaps, fed=fed, rec=rec, seen=seen, grouped=grouped)


def _expert_size(cfg):
    m = cfg.moe
    return m.num_experts * cfg.d_model * m.expert_d_ff


def test_routing_is_decisive(case):
    assert case["gaps"], "the reference recorded no routing"
    assert min(case["gaps"]) >= MARGIN * ROUND_TOL, min(case["gaps"])


def test_packed_moe_round_matches_reference(case):
    fed, rec, tp = case["fed"], case["rec"], case["tp"]
    np.testing.assert_array_equal(fed.server.sel_history[0], case["sel"])
    assert abs(rec.loss - case["loss"]) <= ROUND_TOL
    moved = 0
    for path, x in case["want"].items():
        err = float((fed.params[path] - x).abs().max())
        assert err <= ROUND_TOL, (path, err)
        moved += int(not torch.equal(fed.params[path], tp[path]))
    assert moved > 0
    assert any(not torch.equal(fed.params[p], tp[p]) for p in fed.params
               if p.endswith("/moe/w_up"))


def test_one_grouped_encode_over_every_leaf(case):
    (xs, us, out), = case["grouped"]
    assert len(xs) == len(case["tp"])
    p = _expert_size(case["cfg"])
    experts = [i for i, x in enumerate(xs) if x.shape[1] == p]
    # w_up, w_gate, w_down: every client's slot rows, C x n_slots each
    n_slots = case["fed"].fl.resolve_n_slots(case["fed"].assign.n_units)
    assert len(experts) == 3
    assert all(xs[i].shape == (C * n_slots, p) for i in experts)


def test_expert_codes_bitwise_reference_kernel(case):
    """The expert leaves' codes and scales of the round's grouped encode
    against the reference's Pallas kernel (interpret mode) on the same
    rows and uniforms."""
    (xs, us, out), = case["grouped"]
    p = _expert_size(case["cfg"])
    checked = 0
    for x, u, (codes, scale) in zip(xs, us, out):
        if x.shape[1] != p:
            continue
        r_codes, r_scale = r_quantize_pack(jnp.asarray(x.numpy()),
                                           jnp.asarray(u.numpy()), 8,
                                           interpret=True)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(r_codes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(r_scale))
        assert int((codes != 0).sum()) > 0
        checked += 1
    assert checked == 3


def test_reference_codec_decodes_the_round_bitwise(case):
    """The reference's codec transform on the round's own packed deltas,
    slot rows, validity and weights, with the same codec key: every
    decoded leaf bitwise the port's."""
    (pd, rows, valid, weights, decoded), = case["seen"]
    nest = lambda t: _jnp(unflatten({p: x.numpy() for p, x in t.items()}))
    r_dec, _ = rcodecs.build_codec_transform(
        rcodecs.get_codec("qint8"), case["ra"], RFLConfig(**FL_KW))(
        nest(pd), nest(rows), nest(valid), jnp.asarray(weights.numpy()),
        case["ck"], None, jnp.ones((C,), jnp.float32))
    got = {p: x.numpy() for p, x in decoded.items()}
    want = {"/".join(str(k.key) for k in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(r_dec)[0]}
    assert set(got) == set(want)
    for path, x in want.items():
        np.testing.assert_array_equal(got[path], x, err_msg=path)


def test_packed_moe_bill_exact(case):
    fed, rec, sel = case["fed"], case["rec"], case["sel"]
    ub = rcodecs.codec_unit_bytes(rcodecs.get_codec("qint8"), case["ra"],
                                  case["rp"], RFLConfig(**FL_KW))
    assert rec.uplink_bytes == hub_round_bytes(sel, ub)["uplink"]
    # the closed form: a selected unit ships each of its rows as P int8
    # codes and one fp32 scale
    closed = np.zeros(fed.assign.n_units, np.int64)
    for path, x in case["tp"].items():
        lu = fed.assign.leaf_units[path]
        if lu.kind == "scalar":
            closed[lu.base] += x.numel() + 4
        else:
            for m in range(x.shape[0]):
                closed[lu.base + lu.stride * m] += x[0].numel() + 4
    assert rec.uplink_bytes == float((sel @ closed).sum()) > 0
    p = _expert_size(case["cfg"])
    assert sum(int(x[0].numel() == p) for x in case["tp"].values()) == 3
