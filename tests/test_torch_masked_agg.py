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


def test_tile_level_matches_reference_kernel():
    rng = np.random.default_rng(1)
    t, c, tile = 6, 3, 256
    g = rng.normal(size=(t, tile)).astype(np.float32)
    d = rng.normal(size=(t, c, tile)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (t, c)).astype(np.float32)
    w[1] = 0.0                                       # denominator 0
    ref = r_kernel.masked_agg(jnp.asarray(g), jnp.asarray(d), jnp.asarray(w),
                              interpret=True)
    # the port reads client-major (C, T, tile) planes
    d_ct = torch.as_tensor(d).permute(1, 0, 2)
    got = ops.masked_agg(torch.as_tensor(g), d_ct, torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    assert torch.equal(got[1], torch.as_tensor(g[1]))
    torch.testing.assert_close(masked_agg_ref(torch.as_tensor(g), d_ct,
                                              torch.as_tensor(w)), got)


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    g = torch.zeros(4, 8)
    d = torch.zeros(2, 4, 8)
    w = torch.ones(4, 2)
    if bad == "dtype":
        d = d.double()
    elif bad == "shape":
        w = torch.ones(4, 3)
    else:
        g = g.to("meta")
    with pytest.raises(ValueError, match="masked_agg"):
        ops.masked_agg(g, d, w)


def test_cpu_path_does_not_count_launches():
    before = ops.masked_agg.launches
    ops.masked_agg(torch.zeros(2, 8), torch.zeros(3, 2, 8), torch.ones(2, 3))
    assert ops.masked_agg.launches == before


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
