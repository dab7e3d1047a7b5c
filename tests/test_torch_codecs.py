"""The port's uplink codecs, quantize-pack plain version, slot plan and
codec byte accounting against the reference, on the same numpy inputs.

Quantized codes, scales, decoded rows, the error-feedback residual and
every byte count are held to EXACT equality (the ROADMAP parity bar for
integer and exactly rounded outputs).  The stochastic-rounding uniforms
are the reference's own: the port's codec transform takes them through
its injected ``uniform(i, shape)`` callable.  JAX's ``quantize_pack``
runs in interpret mode here, as the reference's own tests run it on the
CPU.  Small sizes: the toy MLP at 6 blocks, d 16, hidden 32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FLConfig as RFLConfig
from repro.core import Federation as RFederation
from repro.core import codecs as rcodecs
from repro.core import federation as rfed
from repro.core.masking import slot_plan as r_slot_plan
from repro.kernels.codec import dequantize_unpack as r_dequantize
from repro.kernels.codec import quantize_pack as r_quantize_pack
from repro.kernels.codec import quantize_pack_ref as r_quantize_ref
from repro.models.toy import init_toy_mlp as r_init_toy
from repro.models.toy import toy_batches as r_toy_batches
from repro.models.toy import toy_loss as r_toy_loss
from repro.models.toy import toy_units as r_toy_units
from repro_torch.common import flatten, flatten_with_paths, unflatten
from repro_torch.convert import from_reference
from repro_torch.core import (Federation, FLConfig, NotPortedError, Replay,
                              codecs, masking)
from repro_torch.kernels.codec import ops
from repro_torch.kernels.codec.ref import dequantize_unpack, quantize_pack_ref
from repro_torch.models import toy

C = 4
tloss = functools.partial(toy.toy_loss, device="cpu")


def _np_flat(tree):
    """A reference tree (nested, jax or numpy leaves) -> flat numpy."""
    return flatten(jax.tree_util.tree_map(np.asarray, tree))


def _t(tree):
    return {p: torch.as_tensor(np.array(x)) for p, x in _np_flat(tree).items()}


@pytest.fixture(scope="module")
def toy_setup():
    rp = r_init_toy(jax.random.PRNGKey(0), n_blocks=6, d=16, hidden=32,
                    out=4)
    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    return {"rp": rp, "r_assign": r_toy_units(rp), "tp": tp,
            "assign": toy.toy_units(tp)}


# -- quantize-pack plain version --------------------------------------------

_WIDTHS = {"even": 4096, "odd": 4097, "short": 10, "long": 5001}


def _rows(case, bits):
    p = _WIDTHS[case]
    rng = np.random.default_rng(p * 10 + bits)
    x = (rng.standard_normal((9, p)) * 0.05).astype(np.float32)
    x[3] = 0.0                                       # an all-zero row
    x[5] = 0.0
    x[5, p // 3] = -0.7                              # a one-hot row
    u = rng.random((9, p), dtype=np.float32)
    return x, u


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["even", "odd", "short", "long"])
def test_quantize_pack_ref_equals_reference_bitwise(bits, case):
    x, u = _rows(case, bits)
    want_k = r_quantize_pack(jnp.asarray(x), jnp.asarray(u), bits,
                             interpret=True)
    want_r = r_quantize_ref(jnp.asarray(x), jnp.asarray(u), bits)
    got = quantize_pack_ref(torch.as_tensor(x), torch.as_tensor(u), bits)
    wrapped = ops.quantize_pack(torch.as_tensor(x), torch.as_tensor(u), bits)
    for want in (want_k, want_r):
        for g, w, name in zip(got, want, ("codes", "scale")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
            assert g.numpy().dtype == np.asarray(w).dtype
    for g, w in zip(wrapped, got):                   # CPU: the plain version
        assert torch.equal(g, w)
    if bits == 4:
        assert (got[0][3] == 0x88).all()             # zero row: q = 0 -> 8|8


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_unpack_equals_reference(bits):
    x, u = _rows("odd", bits)
    packed, scale = r_quantize_ref(jnp.asarray(x), jnp.asarray(u), bits)
    want = r_dequantize(packed, scale, bits, x.shape[1])
    got = dequantize_unpack(torch.as_tensor(np.asarray(packed)),
                            torch.as_tensor(np.asarray(scale)), bits,
                            x.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_pack_wrapper_checks():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="bits"):
        ops.quantize_pack(x, x, 2)
    with pytest.raises(ValueError, match="float32"):
        ops.quantize_pack(x.double(), x.double(), 8)
    with pytest.raises(ValueError, match="same"):
        ops.quantize_pack(x, x[:, :4], 8)


# -- the grouped wrapper -------------------------------------------------------

def _group_leaves(bits):
    """Mixed leaves as one round hands them over: 1-element rows, an odd
    P, an all-zero row, short rows, and long rows of several 8192-element
    chunks (one of them one-hot, its max in the third chunk)."""
    rng = np.random.default_rng(40 + bits)
    shapes = [(3, 1), (2, 4097), (5, 10), (2, 3 * 8192 + 1), (1, 8192),
              (4, 33)]
    leaves = [((rng.standard_normal(s) * 0.05).astype(np.float32),
               rng.random(s, dtype=np.float32)) for s in shapes]
    leaves[1][0][1] = 0.0
    leaves[3][0][0] = 0.0
    leaves[3][0][0, 20_000] = -0.9
    return leaves


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pack_group_equals_reference_bitwise(bits):
    leaves = _group_leaves(bits)
    got = ops.quantize_pack_group([torch.as_tensor(x) for x, _ in leaves],
                                  [torch.as_tensor(u) for _, u in leaves],
                                  bits)
    assert len(got) == len(leaves)
    for i, ((x, u), (codes, scale)) in enumerate(zip(leaves, got)):
        want = r_quantize_pack(jnp.asarray(x), jnp.asarray(u), bits,
                               interpret=True)
        for g, w, name in zip((codes, scale), want, ("codes", "scale")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"leaf {i} {name}")
            assert g.numpy().dtype == np.asarray(w).dtype
    if bits == 4:
        assert (got[1][0][1] == 0x88).all()          # the all-zero row


def test_quantize_pack_group_wrapper_checks():
    x = torch.zeros(2, 8)
    assert ops.quantize_pack_group([], [], 8) == []
    with pytest.raises(ValueError, match="bits"):
        ops.quantize_pack_group([x], [x], 2)
    with pytest.raises(ValueError, match="2 x leaves but 1 u"):
        ops.quantize_pack_group([x, x], [x], 8)
    with pytest.raises(ValueError, match="leaf 1: x and u must be the same"):
        ops.quantize_pack_group([x, x, x], [x, x[:, :4], x], 8)
    with pytest.raises(ValueError, match="leaf 2: u must be float32"):
        ops.quantize_pack_group([x, x, x], [x, x, x.double()], 4)
    with pytest.raises(ValueError, match="leaf 1: rows must not be empty"):
        ops.quantize_pack_group([x, x[:, :0]], [x, x[:, :0]], 8)


# -- slot plan ----------------------------------------------------------------

@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_slot_plan_gather_merge_equal_reference(toy_setup, n_slots):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    rng = np.random.default_rng(n_slots)
    rows_sel = [rng.integers(0, 2, ta.n_units).astype(np.float32)
                for _ in range(3)]
    rows_sel += [np.zeros(ta.n_units, np.float32),
                 np.ones(ta.n_units, np.float32)]
    for sel in rows_sel:
        r_rows, r_valid = r_slot_plan(ra, jnp.asarray(sel), n_slots, rp)
        rows, valid = masking.slot_plan(ta, torch.as_tensor(sel), n_slots, tp)
        for name, want, got in (("rows", r_rows, rows),
                                ("valid", r_valid, valid)):
            for path, w in _np_flat(want).items():
                np.testing.assert_array_equal(got[path].numpy(), w,
                                              err_msg=f"{name} {path}")
        gathered = masking.slot_gather(ta, tp, rows)
        for path, lu in ta.leaf_units.items():
            want = tp[path] if lu.kind == "scalar" else tp[path][rows[path]]
            assert torch.equal(gathered[path], want), path
        bumped = {p: x + 1.0 for p, x in gathered.items()}
        merged = masking.slot_merge(ta, tp, bumped, rows)
        for path, lu in ta.leaf_units.items():
            if lu.kind == "scalar":
                assert torch.equal(merged[path], bumped[path])
                continue
            moved = torch.zeros(tp[path].shape[0], dtype=torch.bool)
            moved[rows[path]] = True
            assert torch.equal(merged[path][moved], tp[path][moved] + 1.0)
            assert torch.equal(merged[path][~moved], tp[path][~moved])


# -- the codec transform -----------------------------------------------------

def _packed_payload(toy_setup, sel, n_slots, seed, ties=False):
    """Reference slot plan + a random packed payload of the decoded
    shapes, as numpy (reference layout: nested) and torch (flat)."""
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    r_rows, r_valid = jax.vmap(
        lambda s: r_slot_plan(ra, s, n_slots, rp))(jnp.asarray(sel))
    rng = np.random.default_rng(seed)
    flat_rows = _np_flat(r_rows)
    payload = {}
    for path, leaf in _np_flat(rp).items():
        if toy_setup["assign"].leaf_units[path].kind == "scalar":
            shape = (C,) + leaf.shape
        else:
            shape = (C, flat_rows[path].shape[1]) + leaf.shape[1:]
        x = rng.standard_normal(shape).astype(np.float32)
        if ties:
            x = np.round(x, 1)            # many equal magnitudes per row
        payload[path] = x
    return r_rows, r_valid, payload


def _nested(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten(flat))


@pytest.mark.parametrize("name", ["qint8", "qint4", "topk_ef", "topk_ties"])
def test_codec_transform_equals_reference_bitwise(toy_setup, name):
    ties = name == "topk_ties"
    name = "topk_ef" if ties else name
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    rfl = rfed.FLConfig(n_clients=C, train_fraction=0.5, packed=True,
                        codec=name, codec_topk=0.25)
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True, codec=name,
                  codec_topk=0.25)
    n_slots = fl.resolve_n_slots(ta.n_units)
    rng = np.random.default_rng(7)
    sel = np.zeros((C, ta.n_units), np.float32)
    for c in range(C - 1):
        sel[c, rng.choice(ta.n_units, n_slots, replace=False)] = 1.0
    # the last client trained nothing (all slots pad, all scalars 0)
    r_rows, r_valid, payload = _packed_payload(toy_setup, sel, n_slots, 3,
                                               ties)
    weights = np.ones(C, np.float32)
    weights[1] = 0.0                                  # a dropped client
    key = jax.random.PRNGKey(11)
    r_codec = rcodecs.get_codec(name)
    r_state = rcodecs.init_codec_state(r_codec, rp, C)
    if r_state is not None:                           # a non-zero residual
        r_state = jax.tree_util.tree_map(
            lambda s: jnp.asarray(rng.standard_normal(s.shape)
                                  .astype(np.float32)), r_state)
    decay = jnp.ones((C,), jnp.float32)
    r_dec, r_new = rcodecs.build_codec_transform(r_codec, ra, rfl)(
        _nested(payload), r_rows, r_valid, jnp.asarray(weights), key,
        r_state, decay)

    def uniform(i, shape):
        return torch.as_tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, i), shape, jnp.float32)))

    codec = codecs.get_codec(name)
    state = None if r_state is None else _t(r_state)
    got, new = codecs.build_codec_transform(codec, ta, fl)(
        {p: torch.as_tensor(x) for p, x in payload.items()},
        _t(r_rows), _t(r_valid), torch.as_tensor(weights), uniform, state)
    for path, w in _np_flat(r_dec).items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
    if r_new is None:
        assert new is None
        return
    for path, w in _np_flat(r_new).items():
        np.testing.assert_array_equal(new[path].numpy(), w, err_msg=path)
    # the residual identity inside the port: decoded + new residual ==
    # signal on the valid rows of clients that uploaded; a dropped
    # client's residual is untouched
    valid, rows = _t(r_valid), _t(r_rows)
    for path, d in payload.items():
        d = torch.as_tensor(d)
        v = valid[path].reshape(tuple(valid[path].shape) +
                                (1,) * (d.ndim - valid[path].ndim))
        res0, res1 = state[path], new[path]
        if ta.leaf_units[path].kind == "stacked":
            ci = torch.arange(C)[:, None]
            res0, res1 = res0[ci, rows[path]], res1[ci, rows[path]]
        active = (v > 0) & (torch.as_tensor(weights).reshape(
            (C,) + (1,) * (d.ndim - 1)) > 0)
        x = (d + res0) * v
        assert torch.equal(torch.where(active, got[path] + res1, 0.0),
                           torch.where(active, x, 0.0)), path
        assert torch.equal(new[path][1], state[path][1]), path


def _transform_inputs(toy_setup, name):
    """The port's transform inputs on the toy MLP: a selection with a
    client that trained nothing, a dropped client, and under topk_ef a
    non-zero residual."""
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True, codec=name,
                  codec_topk=0.25)
    n_slots = fl.resolve_n_slots(ta.n_units)
    rng = np.random.default_rng(5)
    sel = np.zeros((C, ta.n_units), np.float32)
    for c in range(C - 1):
        sel[c, rng.choice(ta.n_units, n_slots, replace=False)] = 1.0
    r_rows, r_valid, payload = _packed_payload(toy_setup, sel, n_slots, 9)
    weights = np.ones(C, np.float32)
    weights[1] = 0.0
    codec = codecs.get_codec(name)
    state = None
    if codec.stateful:
        state = {p: torch.as_tensor(rng.standard_normal(
            (C,) + tuple(x.shape)).astype(np.float32)) for p, x in tp.items()}
    args = ({p: torch.as_tensor(x) for p, x in payload.items()}, _t(r_rows),
            _t(r_valid), torch.as_tensor(weights))
    return fl, codec, args, state


def _uniform(i, shape):
    return torch.rand(shape, generator=torch.Generator().manual_seed(100 + i))


@pytest.mark.parametrize("name", ["qint8", "qint4", "topk_ef"])
def test_rows_roundtrip_default_is_the_per_leaf_loop(toy_setup, name,
                                                     monkeypatch):
    """A codec that overrides rows_roundtrip gets one call over every
    leaf, and gives bitwise what it gives with rows_roundtrip put back to
    Codec's default, which the transform calls one leaf at a time; the
    default is row_roundtrip leaf by leaf."""
    ta = toy_setup["assign"]
    fl, codec, args, state = _transform_inputs(toy_setup, name)
    calls, grouped = [], type(codec).rows_roundtrip
    default = codecs.Codec.rows_roundtrip

    def spy(self, xs, draws, fl=None):
        calls.append(len(xs))
        return grouped(self, xs, draws, fl)

    monkeypatch.setattr(type(codec), "rows_roundtrip", spy)
    got, new = codecs.build_codec_transform(codec, ta, fl)(
        *args, _uniform, state)
    assert calls == [len(args[0])]

    def default_spy(self, xs, draws, fl=None):
        calls.append(len(xs))
        return default(self, xs, draws, fl)

    calls.clear()
    monkeypatch.setattr(codecs.Codec, "rows_roundtrip", default_spy)
    monkeypatch.setattr(type(codec), "rows_roundtrip", default_spy)
    want, want_new = codecs.build_codec_transform(codec, ta, fl)(
        *args, _uniform, state)
    assert calls == [1] * len(args[0])
    for path in want:
        assert torch.equal(got[path], want[path]), path
        if state is not None:
            assert torch.equal(new[path], want_new[path]), path
    assert (new is None) == (want_new is None) == (state is None)
    xs = [torch.randn(3, 7), torch.randn(2, 9), torch.zeros(1, 4)]
    draws = [(lambda shape, i=i: _uniform(i, shape))
             if codec.stochastic else None for i in range(len(xs))]
    for a, b in zip(default(codec, xs, draws, fl),
                    [codec.row_roundtrip(x, d, fl) for x, d in
                     zip(xs, draws)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qint8", "qint4"])
def test_grouped_transform_draws_uniforms_in_leaf_order(toy_setup, name):
    """One grouped encode a round still draws uniform(i, shape) leaf by
    leaf in leaf order, each leaf's (rows, P), so the generator's stream
    is the per-leaf path's."""
    ta = toy_setup["assign"]
    fl, codec, args, state = _transform_inputs(toy_setup, name)
    seen = []

    def uniform(i, shape):
        seen.append((i, tuple(shape)))
        return _uniform(i, shape)

    codecs.build_codec_transform(codec, ta, fl)(*args, uniform, state)
    want = []
    for i, (path, d) in enumerate(flatten_with_paths(args[0])):
        lead = 1 if ta.leaf_units[path].kind == "scalar" else 2
        want.append((i, (int(np.prod(d.shape[:lead])),
                         int(np.prod(d.shape[lead:])))))
    assert seen == want


def test_none_codec_builds_no_transform(toy_setup):
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    none = codecs.get_codec("none")
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True)
    assert codecs.build_codec_transform(none, ta, fl) is None
    assert codecs.init_codec_state(none, tp, C) is None
    fed = Federation(loss_fn=tloss, params=tp, assign=ta, fl=fl,
                     device="cpu")
    assert fed.server.codec.name == "none"
    assert fed.server.codec_state is None
    assert fed.server.codec_generator is None


def test_codec_registry_and_plugin():
    with pytest.raises(codecs.UnknownCodecError) as got:
        codecs.get_codec("gzip")
    with pytest.raises(rcodecs.UnknownCodecError) as ref:
        rcodecs.get_codec("gzip")
    assert str(got.value) == str(ref.value)
    assert codecs.available_codecs() == rcodecs.available_codecs()

    @codecs.register_codec
    class Halve(codecs.Codec):
        name = "halve_test"

        def row_bytes(self, p, fl=None):
            return 2 * p

        def row_roundtrip(self, x2, draw, fl=None):
            return x2 * 0.5

    try:
        assert codecs.resolve_codec("halve_test").row_bytes(3) == 6
        FLConfig(n_clients=2, packed=True, codec="halve_test")
    finally:
        codecs.unregister_codec("halve_test")
    assert "halve_test" not in codecs.available_codecs()


# -- byte accounting -----------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "qint8", "qint4", "topk_ef"])
def test_codec_bytes_equal_reference(toy_setup, name):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    kw = {} if name == "none" else {"codec": name, "codec_topk": 0.25}
    rfl = rfed.FLConfig(n_clients=C, train_fraction=0.5, packed=True, **kw)
    fl = FLConfig(n_clients=C, train_fraction=0.5, packed=True, **kw)
    want_ub = rcodecs.codec_unit_bytes(rcodecs.get_codec(name), ra, rp, rfl)
    got_ub = codecs.codec_unit_bytes(codecs.get_codec(name), ta, tp, fl)
    np.testing.assert_array_equal(got_ub, want_ub)
    assert got_ub.dtype == want_ub.dtype
    n_slots = fl.resolve_n_slots(ta.n_units)
    n_train = fl.resolve_n_train(ta.n_units)
    rng = np.random.default_rng(0)
    sel = np.zeros((C, ta.n_units), np.float32)
    for c in range(C - 1):
        sel[c, rng.choice(ta.n_units, n_train, replace=False)] = 1.0
    _, r_valid = jax.vmap(lambda s: r_slot_plan(ra, s, n_slots, rp))(
        jnp.asarray(sel))
    plans = [masking.slot_plan(ta, torch.as_tensor(s), n_slots, tp)
             for s in sel]
    valid = {p: torch.stack([pl[1][p] for pl in plans]) for p in tp}
    want = rcodecs.encoded_wire_bytes(rcodecs.get_codec(name), ra, rp,
                                      r_valid, rfl)
    got = codecs.encoded_wire_bytes(codecs.get_codec(name), ta, tp, valid,
                                    fl)
    assert got == want == float((sel @ got_ub).sum())


def test_comm_summary_qint8_equals_reference(toy_setup):
    rp, ra = toy_setup["rp"], toy_setup["r_assign"]
    tp, ta = toy_setup["tp"], toy_setup["assign"]
    kw = dict(n_clients=C, train_fraction=0.5, packed=True, codec="qint8",
              lr=1e-2)
    batches = r_toy_batches(jax.random.PRNGKey(1), n_clients=C, steps=1,
                            batch=2, d=16, out=4)
    rfed_ = RFederation(loss_fn=r_toy_loss, params=rp, assign=ra,
                        fl=RFLConfig(fused_agg="off", **kw), seed=3)
    rfed_.server.run(3, lambda r: batches)
    fed = Federation(loss_fn=tloss, params=tp, assign=ta, fl=FLConfig(**kw),
                     strategy=Replay(rfed_.server.sel_history), device="cpu")
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batches.items()}
    fed.server.run(3, lambda r: tb)
    assert fed.comm_summary() == rfed_.comm_summary()
    np.testing.assert_array_equal(fed.server.wire_unit_bytes(),
                                  rfed_.server.wire_unit_bytes())
    for r, rr in zip(fed.history, rfed_.history):
        assert r.uplink_bytes == rr.uplink_bytes
        assert r.trained_params == rr.trained_params


# -- config-time validation ---------------------------------------------------

_SYNC = dict(n_clients=C, train_fraction=0.5, packed=True)


@pytest.mark.parametrize("kw", [
    {"codec": "qint8", "packed": False},
    {"codec": "qint8", "topology": "gossip"},
    {"codec": "topk_ef", "n_registered": C, "cohort_chunk": 2},
    {"codec": "gzip"},
    {"codec_topk": 1.5},
], ids=["needs-packed", "gossip", "ef-cohort", "unknown", "topk-range"])
def test_flconfig_codec_validators_match_reference(kw):
    with pytest.raises((ValueError, KeyError)) as ref:
        rfed.FLConfig(**dict(_SYNC, **kw))
    with pytest.raises((ValueError, KeyError)) as got:
        FLConfig(**dict(_SYNC, **kw))
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [{"faults": "nan:0.1"},
                                {"max_delta_norm": 1.0},
                                {"cohort_chunk": 2, "codec": "qint4"}])
def test_unported_engines_still_raise_with_codecs(kw):
    rfed.FLConfig(**dict(_SYNC, **kw))               # valid in the reference
    with pytest.raises(NotPortedError, match="not ported"):
        FLConfig(**dict(_SYNC, **kw))


def test_stochastic_codec_needs_uniforms(toy_setup):
    ta = toy_setup["assign"]
    fl = FLConfig(**_SYNC, codec="qint8")
    fn = codecs.build_codec_transform(codecs.get_codec("qint8"), ta, fl)
    with pytest.raises(ValueError, match="uniform"):
        fn({}, {}, {}, torch.ones(C))
    assert dataclasses.replace(fl, codec="qint4").codec == "qint4"
