"""The port's masked aggregation (plain and fused-wrapper paths) against
repro.core.aggregation.masked_fedavg and the reference Pallas kernel
run in interpret mode.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import masked_fedavg as r_masked_fedavg
from repro.core.masking import build_units_flat as r_build_units
from repro.kernels.masked_agg import kernel as r_kernel
from repro.kernels.masked_agg import ops as r_ops
from repro.models import paper_models as rpm
from repro_torch.convert import from_reference
from repro_torch.core.aggregation import fedavg, masked_fedavg
from repro_torch.core.masking import build_units_flat
from repro_torch.kernels import _build
from repro_torch.kernels.masked_agg import ops
from repro_torch.kernels.masked_agg.ref import masked_agg_ref
from repro_torch.models import paper_models as pm

TOL = 2e-5      # the reference's own kernel-vs-oracle bar
C = 4
NOBODY = 5      # a unit no client selected
ZERO_W = 2      # a client of weight 0


@pytest.fixture(scope="module")
def case():
    rp = rpm.init_vgg16(jax.random.PRNGKey(0), width_mult=0.125)
    np_params = jax.tree_util.tree_map(np.array, rp)
    rng = np.random.default_rng(0)
    np_deltas = jax.tree_util.tree_map(
        lambda x: (0.05 * rng.normal(size=(C,) + x.shape)).astype(np.float32),
        np_params)
    sel = rng.integers(0, 2, (C, 14)).astype(np.float32)
    sel[:, NOBODY] = 0.0
    sel[0, 0] = 1.0
    w = rng.uniform(0.5, 3.0, C).astype(np.float32)
    w[ZERO_W] = 0.0
    tp = from_reference(np_params)
    return {"rp": rp, "r_assign": r_build_units(rp, rpm.vgg16_units(rp)),
            "rd": jax.tree_util.tree_map(jnp.asarray, np_deltas),
            "tp": tp, "assign": build_units_flat(tp, pm.vgg16_units(tp)),
            "td": from_reference(np_deltas), "sel": sel, "w": w}


def _assert_tree_close(got, ref_tree, tol=TOL):
    ref = from_reference(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert list(got) == list(ref)
    for path in ref:
        np.testing.assert_allclose(got[path].numpy(), ref[path].numpy(),
                                   atol=tol, rtol=tol, err_msg=path)


def test_masked_fedavg_matches_reference(case):
    ref = r_masked_fedavg(case["rp"], case["rd"], jnp.asarray(case["sel"]),
                          jnp.asarray(case["w"]), case["r_assign"])
    got = masked_fedavg(case["tp"], case["td"], torch.as_tensor(case["sel"]),
                        torch.as_tensor(case["w"]), case["assign"])
    _assert_tree_close(got, ref)


def test_fedavg_matches_reference(case):
    from repro.core.aggregation import fedavg as r_fedavg
    ref = r_fedavg(case["rp"], case["rd"], jnp.asarray(case["w"]))
    got = fedavg(case["tp"], case["td"], torch.as_tensor(case["w"]))
    _assert_tree_close(got, ref)


@pytest.mark.parametrize("tile", [256, 2048])
def test_fused_matches_reference_kernel(case, tile):
    ref = r_ops.masked_fedavg_fused(
        case["rp"], case["rd"], jnp.asarray(case["sel"]),
        jnp.asarray(case["w"]), case["r_assign"], tile=tile, interpret=True)
    got = ops.masked_fedavg_fused(
        case["tp"], case["td"], torch.as_tensor(case["sel"]),
        torch.as_tensor(case["w"]), case["assign"], tile=tile)
    _assert_tree_close(got, ref)


@pytest.mark.parametrize("tile", [256, 2048])
def test_fused_matches_plain_oracle(case, tile):
    args = (torch.as_tensor(case["sel"]), torch.as_tensor(case["w"]),
            case["assign"])
    got = ops.masked_fedavg_fused(case["tp"], case["td"], *args, tile=tile)
    ref = masked_fedavg(case["tp"], case["td"], *args)
    for p in ref:
        torch.testing.assert_close(got[p], ref[p], atol=TOL, rtol=TOL)
    # the unit nobody selected keeps the global value exactly
    name = case["assign"].unit_names[NOBODY]
    for p in ref:
        if p.startswith(name + "/"):
            assert torch.equal(got[p], case["tp"][p])


@pytest.mark.parametrize("tile", [256, 2048])
def test_plan_matches_reference(case, tile):
    rplan = r_ops.build_agg_plan(case["r_assign"], case["rp"], tile)
    plan = ops.build_agg_plan(case["assign"], case["tp"], tile)
    assert plan.n_rows == rplan.n_rows
    assert [s[:5] for s in plan.segments] == [tuple(s) for s in rplan.segments]
    assert plan.row_unit.shape == (plan.n_rows,)
    assert any(s.n % tile for s in plan.segments)   # ragged leaves exist


def _tile_case(t, c, tile, n_units, seed):
    """Tile-level inputs from numpy: every unit owns some rows, ``NOBODY
    % n_units`` is selected by nobody and client ``c // 2`` weighs 0."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, tile)).astype(np.float32)
    d = rng.normal(size=(c, t, tile)).astype(np.float32)
    row_unit = np.concatenate([np.arange(n_units),
                               rng.integers(0, n_units, t - n_units)])
    sel = rng.integers(0, 2, (c, n_units)).astype(np.float32)
    sel[0] = 1.0
    sel[:, NOBODY % n_units] = 0.0
    w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    w[c // 2] = 0.0
    return g, d, sel, w, row_unit.astype(np.int32)


def _reference_tiles(g, d, sel, w, row_unit):
    """The reference kernel (interpret mode) on the same inputs, fed its
    own layout: (T, C, tile) deltas and the (T, C) weights
    ``sel[c, unit(t)]·w[c]``."""
    w_tc = (sel[:, row_unit] * w[:, None]).T
    return np.asarray(r_kernel.masked_agg(
        jnp.asarray(g), jnp.asarray(d.transpose(1, 0, 2)),
        jnp.asarray(np.ascontiguousarray(w_tc)), interpret=True))


def _port_tiles(g, d, sel, w, row_unit):
    args = [torch.as_tensor(x) for x in (g, d, sel, w, row_unit)]
    return ops.masked_agg(*args), masked_agg_ref(*args)


def test_tile_level_matches_reference_kernel():
    g, d, sel, w, row_unit = _tile_case(6, 3, 256, 4, 1)
    ref = _reference_tiles(g, d, sel, w, row_unit)
    got, plain = _port_tiles(g, d, sel, w, row_unit)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    still = row_unit == NOBODY % 4                   # denominator 0
    assert still.any()
    assert torch.equal(got[still], torch.as_tensor(g[still]))
    torch.testing.assert_close(plain, got)


@pytest.mark.parametrize("c", [1, 33])
def test_tile_level_client_counts(c):
    """One client, and more than a warp's 32 (the kernel's live list
    takes clients 32 at a time), with a unit nobody selected."""
    g, d, sel, w, row_unit = _tile_case(9, c, 256, 6, c)
    if c == 1:
        w[0] = 1.5
    ref = _reference_tiles(g, d, sel, w, row_unit)
    got, _ = _port_tiles(g, d, sel, w, row_unit)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    still = row_unit == NOBODY % 6
    assert torch.equal(got[still], torch.as_tensor(g[still]))


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_unselected_nonfinite_does_not_reach_the_output(bad):
    """The one difference from the reference, pinned: a non-finite value
    in a row whose unit the client did not select is skipped by the
    port (kernel and plain version alike), while the reference's einsum
    multiplies it by 0 and returns NaN there.  The port equals the
    reference on the same inputs with that value zeroed."""
    g, d, sel, w, row_unit = _tile_case(8, 4, 256, 4, 3)
    # a unit that client 0 trained (so the row moves) and another did not
    u0 = next(u for u in range(4) if sel[0, u] and not sel[:, u].all())
    c0 = int(np.flatnonzero(sel[:, u0] == 0)[0])
    t0 = int(np.flatnonzero(row_unit == u0)[0])
    d[c0, t0, 7] = bad
    got, plain = _port_tiles(g, d, sel, w, row_unit)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(plain)
                                                    .all())
    raw = _reference_tiles(g, d, sel, w, row_unit)
    assert np.isnan(raw[t0, 7])
    d[c0, t0, 7] = 0.0
    ref = _reference_tiles(g, d, sel, w, row_unit)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plain.numpy(), ref, atol=TOL, rtol=TOL)


def test_selected_nan_of_a_zero_weight_client_reaches_the_output():
    """A crashed client (weight 0) that selected the row's unit is still
    read: 0·NaN is NaN in the port as in the reference."""
    g, d, sel, w, row_unit = _tile_case(8, 4, 256, 4, 4)
    c0 = 4 // 2                                      # the weight-0 client
    sel[c0, 2] = 1.0
    t0 = int(np.flatnonzero(row_unit == 2)[0])
    d[c0, t0, 5] = np.nan
    got, plain = _port_tiles(g, d, sel, w, row_unit)
    raw = _reference_tiles(g, d, sel, w, row_unit)
    assert np.isnan(raw[t0, 5]) and bool(torch.isnan(got[t0, 5])) and \
        bool(torch.isnan(plain[t0, 5]))
    nan = np.zeros(got.shape, bool)
    nan[t0, 5] = True
    np.testing.assert_allclose(got.numpy()[~nan], raw[~nan], atol=TOL,
                               rtol=TOL)


def test_pack_unpack_roundtrip(case):
    plan = ops.build_agg_plan(case["assign"], case["tp"], 256)
    buf = ops.pack_into(plan, case["td"],
                        ops.new_tile_buffer(plan, (C,)).zero_())
    back = ops.unpack(plan, buf, case["tp"])
    for p, v in case["td"].items():
        assert torch.equal(back[p], v)
    # pack writes payload only: the zeroed padding stays zero
    used = sum(s.n for s in plan.segments)
    assert int(torch.count_nonzero(buf)) <= C * used


def test_fused_round_deltas_are_views_of_the_tile_buffer():
    """The fused hub round's ``metrics["deltas"]`` on the toy MLP's
    stacked leaves: every leaf a view into the one ``(C, T, tile)`` tile
    buffer (no second copy of the deltas), bitwise the deltas of the
    plain round on the same selection."""
    import functools
    from repro_torch.core import FLConfig, Replay, build_round_step
    from repro_torch.models import toy
    c = 3
    p = toy.init_toy_mlp(torch.Generator().manual_seed(0), n_blocks=5, d=12,
                         hidden=20, out=8)
    assign = toy.toy_units(p)
    b = toy.toy_batches(torch.Generator().manual_seed(1), n_clients=c,
                        steps=1, batch=4, d=12, out=8)
    sel = np.random.default_rng(2).integers(0, 2, (c, assign.n_units))
    sel[:, 1] = 1                          # block 0 trained by everyone
    out = {}
    for fused in ("on", "off"):
        step = build_round_step(
            functools.partial(toy.toy_loss, device="cpu"), assign,
            FLConfig(n_clients=c, n_train_units=3, fused_agg=fused),
            strategy=Replay([sel]), device="cpu")
        out[fused] = step(dict(p), b, torch.ones(c), None)
    deltas = out["on"][1]["deltas"]
    plan = ops.build_agg_plan(assign, p)
    buf_bytes = c * plan.n_rows * plan.tile * 4
    assert {x.untyped_storage().data_ptr() for x in deltas.values()} == \
        {deltas["blocks/w1"].untyped_storage().data_ptr()}
    assert all(x.untyped_storage().nbytes() == buf_bytes
               for x in deltas.values())
    # a stacked leaf's rows stride over padded segments: not a copy
    assert not deltas["blocks/w1"].is_contiguous()
    for path, x in out["off"][1]["deltas"].items():
        assert deltas[path].shape == x.shape
        assert torch.equal(deltas[path], x), path
    # the new params are views into the kernel's output buffer, too
    new = out["on"][0]
    assert len({x.untyped_storage().data_ptr() for x in new.values()}) == 1
    for path, x in out["off"][0].items():
        torch.testing.assert_close(new[path], x, atol=TOL, rtol=TOL)


def _small_args(t=4, c=2, tile=8, u=3):
    return [torch.zeros(t, tile), torch.zeros(c, t, tile), torch.ones(c, u),
            torch.ones(c), torch.zeros(t, dtype=torch.int32)]


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "row_unit_dtype",
                                 "row_unit_len", "sel_shape", "weights"])
def test_wrapper_rejects_bad_inputs(bad):
    g, d, sel, w, ru = _small_args()
    if bad == "dtype":
        d = d.double()
    elif bad == "shape":
        sel = torch.ones(3, 3)
    elif bad == "device":
        g = g.to("meta")
    elif bad == "row_unit_dtype":
        ru = ru.long()
    elif bad == "row_unit_len":
        ru = torch.zeros(5, dtype=torch.int32)
    elif bad == "sel_shape":
        sel = torch.ones(2)
    else:
        w = torch.ones(2, 1)
    with pytest.raises(ValueError, match="masked_agg"):
        ops.masked_agg(g, d, sel, w, ru)


def test_cpu_path_does_not_count_launches():
    before = ops.masked_agg.launches
    ops.masked_agg(*_small_args(t=2, c=3))
    assert ops.masked_agg.launches == before


def test_row_unit_table_is_cached_per_device(case):
    plan = ops.build_agg_plan(case["assign"], case["tp"], 256)
    table = plan.row_unit_on("cpu")
    assert table.dtype == torch.int32 and table.device.type == "cpu"
    assert np.array_equal(table.numpy(), plan.row_unit)
    assert plan.row_unit_on(torch.device("cpu")) is table
    assert plan.n_units == case["assign"].n_units


def test_launch_vec_fills_the_card():
    """Every plan K1 runs gets at least MIN_BLOCKS blocks where its rows
    allow it: 2 float4s a thread from 264 rows of 2,048 floats on, 1
    below (CASA's 44 rows)."""
    for t, vec in ((1, 1), (44, 1), (263, 1), (264, 2), (1293, 2),
                   (7252, 2), (840177, 2)):
        assert ops.launch_vec(t, ops.TILE) == vec, t
        blocks = t * -(-(ops.TILE // 4) // (ops.THREADS * vec))
        assert blocks >= ops.MIN_BLOCKS or vec == 1
    assert ops.launch_vec(1055, 12) == 1 and ops.launch_vec(1056, 12) == 2


def _pack_spy(monkeypatch):
    calls = []
    real = ops.pack_into

    def spy(plan, tree, buf):
        calls.append(tuple(buf.shape))
        return real(plan, tree, buf)

    monkeypatch.setattr(ops, "pack_into", spy)
    return calls


def test_second_fused_round_reads_global_tiles_in_place(case, monkeypatch):
    """A fused aggregate's result is the views of the kernel's output
    buffer; fed back as the next round's global params, it is read in
    place (no pack, the same buffer) and gives bitwise the packing
    path's result, without writing the previous params."""
    plan = ops.build_agg_plan(case["assign"], case["tp"], 256)
    sel, w = torch.as_tensor(case["sel"]), torch.as_tensor(case["w"])
    d_t = ops.pack_into(plan, case["td"], ops.new_tile_buffer(plan, (C,)))
    assert ops.tile_source(plan, case["tp"]) is None
    calls = _pack_spy(monkeypatch)
    first = ops.masked_combine_packed(case["tp"], d_t, sel, w, plan)
    assert calls == [(plan.n_rows, plan.tile)]       # round 1 packs
    src = ops.tile_source(plan, first)
    path0 = plan.leaves[0][0]
    assert src is not None and \
        src.data_ptr() == first[path0].untyped_storage().data_ptr()
    before = {p: x.clone() for p, x in first.items()}
    calls.clear()
    second = ops.masked_combine_packed(first, 0.5 * d_t, sel, w, plan)
    assert calls == []                               # read in place
    packed = ops.masked_combine_packed(
        {p: x.clone() for p, x in first.items()}, 0.5 * d_t, sel, w, plan)
    assert len(calls) == 1
    for p in packed:
        assert torch.equal(second[p], packed[p]), p
        assert torch.equal(first[p], before[p]), p   # never written
    assert second[path0].untyped_storage().data_ptr() != src.data_ptr()


def test_a_cloned_leaf_falls_back_to_packing(case, monkeypatch):
    plan = ops.build_agg_plan(case["assign"], case["tp"], 256)
    sel, w = torch.as_tensor(case["sel"]), torch.as_tensor(case["w"])
    d_t = ops.pack_into(plan, case["td"], ops.new_tile_buffer(plan, (C,)))
    first = ops.masked_combine_packed(case["tp"], d_t, sel, w, plan)
    path = plan.leaves[3][0]
    mixed = dict(first, **{path: first[path].clone()})
    assert ops.tile_source(plan, mixed) is None
    calls = _pack_spy(monkeypatch)
    got = ops.masked_combine_packed(mixed, d_t, sel, w, plan)
    want = ops.masked_combine_packed(first, d_t, sel, w, plan)
    assert len(calls) == 1
    for p in want:
        assert torch.equal(got[p], want[p]), p


def test_build_is_lazy_and_names_nvcc(monkeypatch, tmp_path):
    assert [s.name for s in _build.kernel_sources()] == [
        "quantize_pack.cu", "flash_attention.cu", "flash_attention_sm90.cu",
        "flash_decode_paged.cu", "masked_agg.cu", "rwkv6_scan.cu"]
    lib = _build.library_path(ops.SOURCE)
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert lib == _build.library_path(ops.SOURCE)     # content-addressed
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", ["casa", "hierarchical"])
def test_profile_inputs_bounds_and_check(name, monkeypatch):
    """``profile_masked_agg``'s inputs on the CPU: the check passes the
    wrapper (its plain version here), the live-plane count is the mean
    of selected planes a row, and a kernel that reads unselected planes
    as the reference does (NaN·0) fails the check."""
    from repro_torch import profile_masked_agg as pk
    from repro_torch.kernels.masked_agg.ref import k1_bytes
    plan, g, d, sel, w = pk.plan_inputs(name, torch.device("cpu"))
    k1_in = (g, d, sel, w, plan.row_unit_on("cpu"))
    assert ops.check_kernel(k1_in)["max_abs_err"] == 0.0
    nb = k1_bytes(plan.row_unit, sel, plan.tile)
    live = float((sel.numpy()[:, plan.row_unit] != 0).sum(0).mean())
    assert nb["live"] == pytest.approx(live) and nb["planes"] == sel.shape[0]
    assert nb["live_bytes"] <= nb["all"]

    def reads_all(g_t, d_t, sel_cu, w_c, row_unit, **_):
        wt = (sel_cu[:, row_unit.long()] * w_c[:, None]).t()
        num = torch.einsum("tc,ctk->tk", wt, d_t)
        den = wt.sum(1, keepdim=True)
        return g_t + torch.where(den > 0, num / den.clamp_min(1e-9), 0.0)

    if ops.check_kernel(k1_in)["nan_at"] is not None:
        monkeypatch.setattr(ops, "masked_agg", reads_all)
        with pytest.raises(RuntimeError, match="NaN"):
            ops.check_kernel(k1_in)


@pytest.mark.parametrize("fault", ["last_row", "nobody_row", "no_nobody"])
def test_check_kernel_holds_every_row(fault, monkeypatch):
    """``ops.check_kernel`` compares every row, the plain version taken
    CHECK_ROWS rows at a time: a kernel off in the last row, or one that
    moves a row of a unit nobody selected, fails it; and with
    ``nobody=True`` inputs with no such row fail it too."""
    g, d, sel, w, ru = (torch.as_tensor(x) for x in
                        _tile_case(23, 4, 256, 4, 5))
    monkeypatch.setattr(ops, "CHECK_ROWS", 5)
    assert ops.check_kernel((g, d, sel, w, ru), nobody=True)[
        "max_abs_err"] == 0.0
    real = ops.masked_agg
    if fault == "no_nobody":
        sel[:, NOBODY % 4] = 1.0
        with pytest.raises(RuntimeError, match="nobody selected"):
            ops.check_kernel((g, d, sel, w, ru), nobody=True)
        return
    row = 22 if fault == "last_row" else \
        int(np.flatnonzero(ru.numpy() == NOBODY % 4)[-1])

    def off(*args):
        out = real(*args)
        out[row, 3] += 1e-3
        return out

    monkeypatch.setattr(ops, "masked_agg", off)
    with pytest.raises(RuntimeError, match="disagrees"):
        ops.check_kernel((g, d, sel, w, ru))


@pytest.mark.parametrize("name,rows", [
    ("qwen3-1.7b", 840177), ("hymba-1.5b", 385673),
    ("whisper-medium", 371410), ("granite-moe-1b-a400m", 651761),
    ("internvl2-26b", 940050)])
def test_profile_zoo_plans_match_the_rounds(name, rows):
    """The zoo plans built from shapes on ``meta`` have the rows the
    zoo rounds' own plans have (the card runs' ``[zoo-round*]``)."""
    from repro_torch import profile_masked_agg as pk
    plan, c, n_train = pk._zoo_plan(name)
    assert plan.n_rows == rows and c == 2
    assert n_train == plan.n_units // 2
