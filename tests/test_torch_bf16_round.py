"""The paper's round in bf16 (``param_dtype="bfloat16"``, the reference's
own switch) against the reference, on the CPU.

* ``convert``: the reference's bf16 draw (its ``jax.random`` params cast
  to ``jnp.bfloat16``, held by numpy as ``ml_dtypes.bfloat16``) crosses
  into torch and back bitwise, compared as 16-bit views; an fp32 tree
  crosses as before.
* K1's plain version on bf16 tiles against the reference's Pallas kernel
  (interpret mode) on the same tiles: within one bf16 step at every
  element, or the fp32 sums' own rounding where the update cancels the
  global value (``ref.bf16_agrees``); its fp32 sums rounded once (the
  same as the plain version on the tiles cast up, then cast down).  A dtype mix raises; ``unpack``
  gives views with no copy where the buffer's dtype is the leaves', and
  ``tile_source`` finds a bf16 buffer.
* Loss and gradients of reduced qwen3-1.7b and reduced gemma3-12b
  (windowed and global layers) in bf16, on the port's plain chunked
  attention, against the reference in bf16: the largest over leaves of
  ``||g - g_ref|| / ||g_ref||`` within ``BAR_FACTOR`` x the reference's
  own bf16-vs-fp32 distance (2.5e-2 and 4.2e-2 here; the port lies
  1.7e-2 and 2.6e-2 from the reference, CPU readings), the loss within
  the same relative bar.  The two losses' own bf16-vs-fp32 gaps (5e-5,
  1.3e-4) are too small and too much a matter of chance to scale a bar:
  the port's qwen3 loss lies 1.3e-4 from the reference's bf16 one.  A
  planted fault, layer 0's first key tile left out of every later query
  row, fails the gradient bar by 5x or more (9.9x at gemma3-12b, 21x
  at qwen3-1.7b, CPU readings).
* One ``Federation.from_config`` hub round of reduced qwen3-1.7b in bf16
  with ``fused_agg="on"`` (K1's plain version), a replayed selection and
  the reference's bf16 params injected: params bf16 after the round,
  the unit nobody trained bitwise unchanged, every frozen (client, unit)
  delta exactly zero, the port's aggregate of its own deltas within
  ``ref.bf16_agrees`` of the reference's ``masked_fedavg`` on the same
  deltas, the
  bill exact (Table 4's 4 bytes a param, whatever the dtype), the client
  planes bf16 and the global read in place next round; a tree with one
  fp32 leaf gets fp32 planes.

The reference's outputs are computed once per module, on one torch
thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core.aggregation import masked_fedavg as r_masked_fedavg
from repro.core.comm import hub_round_bytes, unit_bytes
from repro.core.masking import build_units as r_build_units
from repro.kernels.masked_agg import kernel as r_kernel
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference, to_reference, \
    to_reference_flat
from repro_torch.core import FLConfig, Federation, Replay
from repro_torch.core.masking import leaf_unit_ids
from repro_torch.data import lm_batch
from repro_torch.kernels.masked_agg import ops
from repro_torch.kernels.masked_agg.ref import bf16_agrees, masked_agg_ref
from repro_torch.models import get_model, transformer

BF16 = torch.bfloat16
BAR_FACTOR = 2.0
LOSS_ARCHS = ("qwen3-1.7b", "gemma3-12b")
S, Q_CHUNK = 256, 64                 # past the chunk: the chunked route
C, B_ROUND, S_ROUND, LR = 2, 2, 32, 2e-3
# reduced qwen3-1.7b has 4 units (embed, 2 layers, head); unit 0 trained
# by both clients, unit 3 by nobody
SEL = np.array([[1, 1, 0, 0], [1, 0, 1, 0]], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x):
    """A bf16 numpy array or torch tensor as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@functools.lru_cache(maxsize=None)
def _draw(arch, seed):
    """The reference's fp32 draw of reduced ``arch`` and the same cast to
    bf16 (its bf16 draw), once per module."""
    r32 = r_get_config(arch).reduced()
    rp32 = jax.jit(r_get_model(r32).init_params)(jax.random.PRNGKey(seed))
    rp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), rp32)
    return r32, rp32, rp16


def _dist(got, want):
    """The largest, over leaves, of ||got - want|| / ||want||."""
    out = 0.0
    for p, w in want.items():
        g = np.asarray(got[p], np.float64)
        w = np.asarray(w, np.float64)
        out = max(out, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
    return out


@pytest.fixture(scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- convert -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_carries_the_reference_draw_bitwise(dtype):
    _, rp32, rp16 = _draw("qwen3-1.7b", 0)
    ref = _np(rp16 if dtype == "bfloat16" else rp32)
    flat = {p: x for p, x in to_reference_flat(from_reference(ref)).items()}
    tp = from_reference(ref)
    want_dtype = BF16 if dtype == "bfloat16" else torch.float32
    assert {x.dtype for x in tp.values()} == {want_dtype}
    for p, x in tp.items():
        src = ref
        for k in p.split("/"):
            src = src[k]
        assert x.shape == src.shape
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_bits(tp[p]), _bits(src), p)
            assert flat[p].dtype.name == "bfloat16"
            np.testing.assert_array_equal(_bits(flat[p]), _bits(src), p)
        else:
            np.testing.assert_array_equal(tp[p].numpy(), src, p)
            assert flat[p].dtype == np.float32
            np.testing.assert_array_equal(flat[p], src, p)


# -- K1's plain version on bf16 tiles -----------------------------------------

def _tile_case(t=24, c=4, tile=256, n_units=5, seed=0):
    """bf16 tiles from numpy: every unit owns some rows, unit 3 selected
    by nobody, client 1 selecting unit 0 at weight 0, and each client's
    unselected planes zero (as a round writes them)."""
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.normal(size=(t, tile)), dtype=torch.float32)
    d = torch.as_tensor(0.05 * rng.normal(size=(c, t, tile)),
                        dtype=torch.float32)
    row_unit = np.concatenate([np.arange(n_units),
                               rng.integers(0, n_units, t - n_units)])
    sel = rng.integers(0, 2, (c, n_units)).astype(np.float32)
    sel[:, 0], sel[:, 3] = 1.0, 0.0
    w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    w[1] = 0.0
    d *= torch.as_tensor(sel[:, row_unit])[..., None]
    return (g.to(BF16), d.to(BF16), torch.as_tensor(sel), torch.as_tensor(w),
            torch.as_tensor(row_unit.astype(np.int32)))


def test_plain_bf16_tiles_match_reference_kernel():
    g, d, sel, w, ru = _tile_case()
    got = ops.masked_agg(g, d, sel, w, ru)
    w_tc = (sel[:, ru.long()] * w[:, None]).t().contiguous().numpy()
    to_j = lambda x: jnp.asarray(x.view(torch.int16).numpy()).view(  # noqa
        jnp.bfloat16)
    want = r_kernel.masked_agg(to_j(g), to_j(d.transpose(0, 1).contiguous()),
                               jnp.asarray(w_tc), interpret=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    want = from_reference({"x": np.asarray(want)})["x"]
    assert bool(bf16_agrees(got, want, g).all())
    # rows of the unit nobody selected keep the global bitwise
    still = (ru == 3)
    assert bool(still.any()) and torch.equal(got[still], g[still])
    # fp32 sums, one rounding: the plain version on the tiles cast up,
    # then cast down, is bitwise the bf16 call
    up = masked_agg_ref(g.float(), d.float(), sel, w, ru)
    assert torch.equal(got, up.to(BF16))


def test_bf16_agrees_allows_one_step_or_cancellation_only():
    """One bf16 step apart agrees, two do not; where the update cancels
    the global value (an H100 reading: g 0.0298, the kernel 1.86e-8, the
    plain version 1.68e-8), fp32 rounding of the operands agrees."""
    b = lambda *x: torch.tensor(x, dtype=BF16)          # noqa: E731
    step = 2.0 ** -7                                     # bf16 step at 1.x
    g = b(1.0, 1.0, 0.0297851562)
    want = b(1.5, 1.5, 1.6763806e-08)
    got = b(1.5 + step, 1.5 + 2 * step, 1.8626451e-08)
    assert bf16_agrees(got, want, g).tolist() == [True, False, True]
    # the same gap without the cancellation is many bf16 steps: refused
    assert not bool(bf16_agrees(b(1.8626451e-08), b(1.6763806e-08),
                                b(0.0))[0])


@pytest.mark.parametrize("mix", ["deltas fp32", "global fp32",
                                 "global fp16"])
def test_a_dtype_mix_raises(mix):
    g, d, sel, w, ru = _tile_case()
    if mix == "deltas fp32":
        d = d.float()
    elif mix == "global fp32":
        g = g.float()
    else:
        g, d = g.half(), d.half()
    with pytest.raises(ValueError, match="must be"):
        ops.masked_agg(g, d, sel, w, ru)


@pytest.fixture(scope="module")
def bf16_tree():
    cfg = get_config("qwen3-1.7b").reduced().replace(param_dtype="bfloat16")
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    from repro_torch.core import build_units
    assign = build_units(cfg, params)
    return params, assign, ops.build_agg_plan(assign, params)


def test_unpack_views_and_tile_source_in_bf16(bf16_tree):
    params, _, plan = bf16_tree
    assert ops.tile_dtype(params) == BF16
    buf = ops.pack_into(plan, params,
                        ops.new_tile_buffer(plan, dtype=BF16).zero_())
    views = ops.unpack(plan, buf, params)
    ptr = buf.untyped_storage().data_ptr()
    for p, x in views.items():
        assert x.dtype == BF16 and torch.equal(x, params[p])
        assert x.untyped_storage().data_ptr() == ptr, p
    found = ops.tile_source(plan, views)
    assert found is not None and found.dtype == BF16
    assert found.data_ptr() == buf.data_ptr()
    # an fp32 buffer's views of bf16 leaves are copies: nothing to find
    buf32 = ops.pack_into(plan, params, ops.new_tile_buffer(plan).zero_())
    assert ops.tile_source(plan, ops.unpack(plan, buf32, params)) is None
    # one leaf of another dtype: the tree is packed anew
    mixed = dict(views)
    path = next(iter(mixed))
    mixed[path] = mixed[path].float()
    assert ops.tile_source(plan, mixed) is None
    assert ops.tile_dtype(mixed) == torch.float32


def test_launch_vec_counts_vectors_of_either_dtype():
    tile = ops.TILE
    # qwen3-1.7b's plan: 840,177 rows; a bf16 row is 256 vectors, 2 blocks
    assert ops.launch_vec(840_177, tile, 2) == 2
    assert ops.launch_vec(840_177, tile, 4) == 2
    # CASA's 44 rows: 88 bf16 blocks at 2 vectors a thread, too few
    assert ops.launch_vec(44, tile, 2) == 1
    # the same bytes a row move in the same blocks: 528 bf16 rows of
    # 2,048 fill the card at 2 as 528 fp32 rows of 1,024 do
    assert ops.launch_vec(528, tile, 2) == ops.launch_vec(528, tile // 2, 4)
    assert ops.launch_vec(527, tile, 2) == 1


# -- loss and gradients ------------------------------------------------------

def _port_grads(cfg, tp, batch, fault=0):
    """The port's loss and gradients (fp32 numpy) on the plain chunked
    attention; ``fault`` > 0 leaves layer 0's first ``fault`` keys out of
    every query row past them."""
    orig, calls = transformer.attend, []

    def attend(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        if fault and not calls:
            o = o.clone()
            o[:, fault:] = orig(q[:, fault:], k[:, fault:], v[:, fault:],
                                **kw)
        calls.append(1)
        return o

    transformer.attend = attend
    try:
        leaves = {p: x.clone().requires_grad_(True) for p, x in tp.items()}
        loss, _ = get_model(cfg).loss_fn(
            leaves, {k: torch.as_tensor(v) for k, v in batch.items()},
            attn_impl="chunked", q_chunk=Q_CHUNK)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        transformer.attend = orig
    assert {g.dtype for g in grads} == {BF16}
    return float(loss.detach()), {p: g.float().numpy()
                                  for p, g in zip(leaves, grads)}


@pytest.fixture(scope="module")
def grad_cases(one_thread):
    """Per arch: the reference's loss and gradients in fp32 and bf16, the
    port's in bf16, and the bar."""
    out = {}
    for i, arch in enumerate(LOSS_ARCHS):
        r32, rp32, rp16 = _draw(arch, 3 + i)
        batch = lm_batch(2, S, r32.vocab, key=3 + i)
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        ref = {}
        for name, rcfg, rp in (("fp32", r32, rp32),
                               ("bf16", r32.replace(param_dtype="bfloat16"),
                                rp16)):
            (loss, _), g = jax.jit(jax.value_and_grad(functools.partial(
                r_get_model(rcfg).loss_fn, attn_impl="chunked",
                q_chunk=Q_CHUNK), has_aux=True))(rp, jb)
            ref[name] = (float(loss), {p: x.float().numpy() for p, x in
                                       from_reference(_np(g)).items()})
        cfg = get_config(arch).reduced().replace(param_dtype="bfloat16")
        tp = from_reference(_np(rp16))
        floor = _dist(ref["bf16"][1], ref["fp32"][1])
        out[arch] = dict(cfg=cfg, tp=tp, batch=batch, ref=ref, floor=floor,
                         bar=BAR_FACTOR * floor,
                         port=_port_grads(cfg, tp, batch))
    return out


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_bf16_gradient_bar_is_bf16_sized(grad_cases, arch):
    floor = grad_cases[arch]["floor"]
    assert 2.0 ** -10 < floor < 2.0 ** -3, floor


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_bf16_loss_and_grads_match_reference_bf16(grad_cases, arch):
    c = grad_cases[arch]
    loss, grads = c["port"]
    rloss, rgrads = c["ref"]["bf16"]
    assert set(grads) == set(rgrads)
    assert abs(loss - rloss) / abs(rloss) <= c["bar"], (loss, rloss)
    err = _dist(grads, rgrads)
    assert 0 < err <= c["bar"], (arch, err, c["bar"])


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_planted_fault_fails_the_gradient_bar(grad_cases, arch):
    c = grad_cases[arch]
    _, bad = _port_grads(c["cfg"], c["tp"], c["batch"], fault=Q_CHUNK)
    err = _dist(bad, c["ref"]["bf16"][1])
    assert err > 5 * c["bar"], (arch, err, c["bar"])


# -- one bf16 round ----------------------------------------------------------

class _Capture:
    """Server hook keeping the last round's metrics."""

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        self.metrics = metrics

    def on_fit_end(self, server, history):
        pass


def _round(cfg, params, batches, monkeypatch, rounds=1):
    """``rounds`` bf16 hub rounds of ``params`` with SEL replayed; returns
    the federation, the last round's record and metrics, and the dtypes
    and in-place reads of every K1 call."""
    calls, real_agg = [], ops.masked_agg
    real_source = ops.tile_source

    def spy(g_t, d_t, *a):
        calls[-1].update(global_dtype=g_t.dtype, planes_dtype=d_t.dtype)
        return real_agg(g_t, d_t, *a)

    def source(plan, tree):
        found = real_source(plan, tree)
        calls.append({"in_place": found is not None})
        return found

    monkeypatch.setattr(ops, "masked_agg", spy)
    monkeypatch.setattr(ops, "tile_source", source)
    fl = FLConfig(n_clients=C, train_fraction=0.5, lr=LR, optimizer="adam",
                  fused_agg="on")
    fed = Federation.from_config(cfg, fl, strategy=Replay([SEL] * rounds),
                                 device="cpu")
    fed.server.params = {p: x.clone() for p, x in params.items()}
    cap = _Capture()
    fed.server.add_hook(cap)
    for _ in range(rounds):
        rec = fed.run_round({k: torch.as_tensor(v)
                             for k, v in batches.items()})
    return fed, rec, cap.metrics, calls


@pytest.fixture(scope="module")
def round_case(one_thread):
    r32, rp32, rp16 = _draw("qwen3-1.7b", 0)
    cfg = get_config("qwen3-1.7b").reduced().replace(param_dtype="bfloat16")
    batch = lm_batch(C * B_ROUND, S_ROUND, cfg.vocab, key=7)
    batches = {k: v.reshape(C, 1, B_ROUND, S_ROUND) for k, v in batch.items()}
    return dict(r32=r32, rp32=rp32, rp16=rp16, cfg=cfg, batches=batches,
                tp=from_reference(_np(rp16)),
                ra=r_build_units(r32, rp16))


def test_bf16_round_matches_reference_aggregate(round_case, monkeypatch):
    rc = round_case
    fed, rec, m, calls = _round(rc["cfg"], rc["tp"], rc["batches"],
                                monkeypatch)
    assert np.isfinite(rec.loss)
    new = fed.params
    assert {x.dtype for x in new.values()} == {BF16}
    assert calls == [{"in_place": False, "global_dtype": BF16,
                      "planes_dtype": BF16}]
    # frozen (client, unit) deltas exactly zero, trained ones moved
    deltas = m["deltas"]
    assert {x.dtype for x in deltas.values()} == {BF16}
    moved = 0
    for p, d in deltas.items():
        lu = fed.assign.leaf_units[p]
        ids = leaf_unit_ids(lu, new[p].shape)
        for c in range(C):
            rows = d[c][None] if lu.kind == "scalar" else d[c]
            for r, u in zip(rows, ids):
                if SEL[c, u] == 0:
                    assert not bool(r.any()), (p, c, u)
                else:
                    moved += bool(r.any())
        # the unit nobody trained keeps the global bitwise
        frozen = [i for i, u in enumerate(ids) if SEL[:, u].sum() == 0]
        for i in frozen:
            got = new[p] if lu.kind == "scalar" else new[p][i]
            want = rc["tp"][p] if lu.kind == "scalar" else rc["tp"][p][i]
            assert torch.equal(got, want), p
    assert moved > 0
    # the port's aggregate of its own deltas against the reference's
    # masked_fedavg on the same bf16 deltas
    rdeltas = jax.tree_util.tree_map(jnp.asarray, to_reference(deltas))
    want = r_masked_fedavg(rc["rp16"], rdeltas, jnp.asarray(SEL),
                           jnp.ones(C), rc["ra"])
    want = from_reference(_np(want))
    for p, x in want.items():
        assert x.dtype == BF16
        assert bool(bf16_agrees(new[p], x, rc["tp"][p]).all()), p
    # the bill: Table 4 at 4 bytes a param, whatever the dtype
    bill = hub_round_bytes(SEL, unit_bytes(rc["ra"], rc["rp16"]))["uplink"]
    assert rec.uplink_bytes == bill == \
        hub_round_bytes(SEL, unit_bytes(rc["ra"], rc["rp32"]))["uplink"]


def test_second_bf16_round_reads_the_global_in_place(round_case,
                                                     monkeypatch):
    rc = round_case
    fed, _, _, calls = _round(rc["cfg"], rc["tp"], rc["batches"],
                              monkeypatch, rounds=2)
    assert [c["in_place"] for c in calls] == [False, True]
    assert {c["planes_dtype"] for c in calls} == {BF16}
    assert {x.dtype for x in fed.params.values()} == {BF16}


def test_a_mixed_tree_gets_fp32_planes(round_case, monkeypatch):
    rc = round_case
    mixed = dict(rc["tp"])
    path = "final_norm/scale" if "final_norm/scale" in mixed \
        else next(p for p, x in mixed.items() if x.ndim == 1)
    mixed[path] = mixed[path].float()
    fed, rec, _, calls = _round(rc["cfg"], mixed, rc["batches"],
                                monkeypatch)
    assert np.isfinite(rec.loss)
    assert calls == [{"in_place": False, "global_dtype": torch.float32,
                      "planes_dtype": torch.float32}]
    assert {p: x.dtype for p, x in fed.params.items()} == \
        {p: x.dtype for p, x in mixed.items()}
