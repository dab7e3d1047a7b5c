"""The port's serving engine (paged continuous batching) against the
reference's ``repro.serve`` on reduced qwen3-1.7b and reduced rwkv6-3b
(the ``ssm`` family: slot-row states, no pages; its prefill's scan is
K7's plain version on the CPU), and against its own static loop; the
host-side paging and scheduling units.

* Greedy streams of the port's engine equal the reference engine's, and
  its per-step logits rows agree within 1e-4 (fp32 math in another
  order); inside the port, on the CPU, the engine's rows equal the
  static loop's bitwise (both run the plain gather + dense decode).
* At temperature > 0 the reference samples with ``jax.random.categorical``
  = ``argmax(gumbel(key) + logits / T)``, key ``fold_in(fold_in(
  PRNGKey(seed), rid), gidx)``; the tests inject those Gumbel rows, so
  the port's sampled streams equal the reference's.
* The reference compiles its prefill, commit and decode once per shape,
  so its streams are computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.serve.engine import DecodeEngine as RDecodeEngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro.serve.engine import static_generate as r_static_generate
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference
from repro_torch.models import get_model
from repro_torch.serve.engine import (DecodeEngine, ServeConfig, gumbel_rows,
                                      sample_tokens, slotted_generate,
                                      static_generate)
from repro_torch.serve.paged_cache import (PageAllocator, PagedTables,
                                           build_layout)
from repro_torch.serve.scheduler import Request, Scheduler

TOL = 1e-4
N, PROMPT, GEN, MAX_LEN = 3, 24, 6, 32
TEMP, SEED = 0.9, 3


def _port_setup(arch, n_prompts=3, prompt_len=PROMPT, seed=0):
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(seed))
    prompts = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (n_prompts, prompt_len), dtype=np.int32)
    return cfg, params, prompts


@pytest.fixture(scope="module")
def ref():
    """Reduced qwen3: the reference's params, prompts and streams."""
    rcfg = r_get_config("qwen3-1.7b").reduced()
    rp = r_get_model(rcfg).init_params(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, rcfg.vocab, (N, PROMPT),
                                                dtype=np.int32)
    eng = RDecodeEngine(rcfg, rp, RServeConfig(
        n_slots=N, max_len=MAX_LEN, page_size=16, record_logits=True))
    for i in range(N):
        eng.submit(prompts[i], GEN)
    greedy = eng.run()
    sampled = r_static_generate(rcfg, rp, jnp.asarray(prompts), GEN,
                                max_len=MAX_LEN, temperature=TEMP, seed=SEED)
    # the reference's Gumbel rows for every (request, token index)
    gumbel = {}
    base = jax.random.PRNGKey(SEED)
    for rid in range(N):
        for g in range(GEN):
            k = jax.random.fold_in(jax.random.fold_in(base, rid), g)
            gumbel[rid, g] = np.array(jax.random.gumbel(
                k, (rcfg.padded_vocab,), jnp.float32))
    return {"cfg": get_config("qwen3-1.7b").reduced(), "prompts": prompts,
            "params": from_reference(jax.tree_util.tree_map(np.asarray, rp)),
            "greedy": greedy, "rows": eng.logits_rows,
            "sampled": sampled, "gumbel": gumbel}


def _injected(gumbel):
    def noise(rids, gidx, vocab):
        return torch.as_tensor(np.stack([gumbel[int(r), int(g)]
                                         for r, g in zip(rids, gidx)]))
    return noise


def _engine(cfg, params, *, max_len=MAX_LEN, gumbel=None, **kw):
    return DecodeEngine(cfg, params, ServeConfig(
        max_len=max_len, page_size=16, **kw), device="cpu", gumbel=gumbel)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_greedy_streams_match_reference_engine(ref):
    eng = _engine(ref["cfg"], ref["params"], n_slots=N, record_logits=True)
    for i in range(N):
        eng.submit(ref["prompts"][i], GEN)
    res = eng.run()
    for i in range(N):
        assert np.array_equal(res[i], ref["greedy"][i]), f"request {i}"
        np.testing.assert_allclose(np.stack(eng.logits_rows[i]),
                                   np.stack(ref["rows"][i]), atol=TOL,
                                   rtol=0, err_msg=f"request {i}")
    assert eng.decode_cache_size == 1


def test_sampled_streams_match_reference(ref):
    """Injected reference Gumbel rows: the port's static loop and its
    engine sample the reference's streams at temperature 0.9."""
    noise = _injected(ref["gumbel"])
    out = static_generate(ref["cfg"], ref["params"], ref["prompts"], GEN,
                          max_len=MAX_LEN, temperature=TEMP, seed=SEED,
                          device="cpu", gumbel=noise)
    assert np.array_equal(out, ref["sampled"])
    eng = _engine(ref["cfg"], ref["params"], n_slots=N, temperature=TEMP,
                  seed=SEED, gumbel=noise)
    for i in range(N):
        eng.submit(ref["prompts"][i], GEN)
    res = eng.run()
    for i in range(N):
        assert np.array_equal(res[i], ref["sampled"][i]), f"request {i}"
    # the formula itself, on one row: categorical == argmax(g + row / T)
    row = np.random.default_rng(7).standard_normal(ref["cfg"].padded_vocab)
    row = row.astype(np.float32)
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 1), 2)
    want = int(jax.random.categorical(k, jnp.asarray(row) / TEMP))
    got = sample_tokens(torch.as_tensor(row)[None],
                        torch.as_tensor(ref["gumbel"][1, 2])[None],
                        temperature=TEMP)
    assert int(got[0]) == want


# ---------------------------------------------------------------------------
# inside the port: continuous vs static
# ---------------------------------------------------------------------------

def test_greedy_continuous_bitwise_equals_static(ref):
    eng = _engine(ref["cfg"], ref["params"], n_slots=N, record_logits=True)
    for i in range(N):
        eng.submit(ref["prompts"][i], GEN)
    res = eng.run()
    out, rows = static_generate(ref["cfg"], ref["params"], ref["prompts"],
                                GEN, max_len=eng.layout.max_len,
                                collect_logits=True, device="cpu")
    for i in range(N):
        assert np.array_equal(res[i], out[i])
        assert np.array_equal(np.stack(eng.logits_rows[i]),
                              np.stack([r[i] for r in rows]))


def test_ring_wrap_bitwise_equals_static():
    """gemma3 with max_len past its reduced window (64): ring pages wrap."""
    cfg, params, prompts = _port_setup("gemma3-12b", prompt_len=70)
    eng = _engine(cfg, params, n_slots=3, max_len=96, record_logits=True)
    assert any(s.ring for s in eng.layout.subs)
    for i in range(3):
        eng.submit(prompts[i], 8)
    res = eng.run()
    out, rows = static_generate(cfg, params, prompts, 8,
                                max_len=eng.layout.max_len,
                                collect_logits=True, device="cpu")
    for i in range(3):
        assert np.array_equal(res[i], out[i])
        assert np.array_equal(np.stack(eng.logits_rows[i]),
                              np.stack([r[i] for r in rows]))
    assert eng.decode_cache_size == 1


def test_multiwave_and_mixed_lengths_match_solo_runs():
    """Mixed prompt/gen lengths over 3 slots, admitted mid-flight: every
    stream equals a solo static run of that request."""
    cfg, params, prompts = _port_setup("qwen3-1.7b", n_prompts=6)
    specs = [(16, 8), (24, 4), (8, 10), (16, 3), (24, 6), (8, 5)]
    eng = _engine(cfg, params, n_slots=3)
    for i, (pl, g) in enumerate(specs):
        eng.submit(prompts[i][:pl], g)
    res = eng.run()
    for i, (pl, g) in enumerate(specs):
        solo = static_generate(cfg, params, prompts[i][:pl][None], g,
                               max_len=eng.layout.max_len, rids=[i],
                               device="cpu")
        assert np.array_equal(res[i], solo[0]), f"request {i}"
    assert eng.decode_cache_size == 1
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_preemption_recovers_streams():
    cfg, params, prompts = _port_setup("gemma3-12b", n_prompts=6)
    specs = [(16, 10), (24, 6), (8, 12), (16, 4), (24, 8), (8, 6)]
    lay = build_layout(cfg, 16, 32)
    eng = _engine(cfg, params, n_slots=3,
                  n_pages=2 * lay.pages_per_seq + 2)
    for i, (pl, g) in enumerate(specs):
        eng.submit(prompts[i][:pl], g)
    res = eng.run()
    assert eng.scheduler.n_preemptions > 0
    for i, (pl, g) in enumerate(specs):
        solo = static_generate(cfg, params, prompts[i][:pl][None], g,
                               max_len=eng.layout.max_len, rids=[i],
                               device="cpu")
        assert np.array_equal(res[i], solo[0]), f"request {i}"
    assert eng.decode_cache_size == 1


def test_temperature_continuous_matches_static_default_noise():
    """The port's own noise is a function of (seed, rid, gidx) only."""
    cfg, params, prompts = _port_setup("qwen3-1.7b")
    eng = _engine(cfg, params, n_slots=2, temperature=TEMP, seed=SEED)
    for i in range(3):
        eng.submit(prompts[i], 5)
    res = eng.run()
    out = static_generate(cfg, params, prompts, 5, max_len=eng.layout.max_len,
                          temperature=TEMP, seed=SEED, device="cpu")
    greedy = static_generate(cfg, params, prompts, 5, max_len=MAX_LEN,
                             device="cpu")
    other = static_generate(cfg, params, prompts, 5, max_len=MAX_LEN,
                            temperature=TEMP, seed=SEED + 1, device="cpu")
    for i in range(3):
        assert np.array_equal(res[i], out[i])
    assert not np.array_equal(out, other)              # the seed matters
    assert not np.array_equal(out, greedy)             # sampled, not argmax
    a = gumbel_rows(SEED, [1, 1], [2, 3], 64)
    assert torch.equal(a[0], gumbel_rows(SEED, [1], [2], 64)[0])
    assert not torch.equal(a[0], a[1])


def test_eos_frees_slot_early():
    cfg, params, prompts = _port_setup("qwen3-1.7b", n_prompts=4)
    probe = _engine(cfg, params, n_slots=2)
    for i in range(2):
        probe.submit(prompts[i], 6)
    eos = int(probe.run()[0][2])
    eng = _engine(cfg, params, n_slots=2, eos_id=eos)
    for i in range(4):
        eng.submit(prompts[i], 6)
    res = eng.run()
    first = int(np.flatnonzero(res[0] == eos)[0])
    assert res[0][-1] == eos and len(res[0]) == first + 1 <= 3
    assert all(len(res[i]) <= 6 for i in range(4))
    assert eng.decode_cache_size == 1


def test_engine_defaults_to_the_card():
    cfg, params, _ = _port_setup("qwen3-1.7b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(cfg, params, ServeConfig(n_slots=2, max_len=MAX_LEN))
    with pytest.raises(RuntimeError, match="CUDA"):
        static_generate(cfg, params, np.zeros((1, 4), np.int32), 2,
                        max_len=MAX_LEN)


# ---------------------------------------------------------------------------
# paged_cache / scheduler units (no device work)
# ---------------------------------------------------------------------------

def test_allocator_all_or_nothing_and_reuse():
    al = PageAllocator(6)                  # pages 1..5 usable
    assert al.n_free == 5
    a = al.alloc(3)
    assert a is not None and len(a) == 3 and 0 not in a
    assert al.alloc(3) is None             # only 2 left: nothing taken
    assert al.n_free == 2
    b = al.alloc(2)
    assert al.n_free == 0 and al.peak_in_use == 5
    al.free(a)
    assert al.n_free == 3
    c = al.alloc(3)
    assert sorted(c) == sorted(a)          # freed pages recycle
    al.free(b + c)
    with pytest.raises(ValueError):
        al.free([0])                       # trash page is never freeable


def test_tables_trash_page_and_release():
    cfg = get_config("gemma3-12b").reduced()
    lay = build_layout(cfg, 16, 32)
    al = PageAllocator(1 + 2 * lay.pages_per_seq)
    tb = PagedTables(lay, n_slots=2, allocator=al)
    assert all((t == 0).all() for t in tb.tables.values())
    assert tb.admit(0, prompt_len=20)
    held = tb.pages_held(0)
    assert held > 0 and al.n_in_use == held
    dev = tb.device_tables()
    assert all(t.dtype == torch.int32 for t in dev.values())
    assert tb.grow(0, step=31)
    tb.release(0)
    assert al.n_in_use == 0
    assert all((t == 0).all() for t in tb.tables.values())


def test_layout_validation():
    qwen = get_config("qwen3-1.7b").reduced()
    with pytest.raises(ValueError, match="vlm|audio|family"):
        build_layout(qwen.replace(family="vlm"), 16, 32)
    with pytest.raises(ValueError, match="page-aligned|multiple"):
        build_layout(get_config("gemma3-12b").reduced(), 24, 96)
    lay = build_layout(qwen, 16, 30)
    assert lay.max_len == 32               # rounded up to a page multiple


def test_scheduler_validates_submissions():
    cfg = get_config("qwen3-1.7b").reduced()
    lay = build_layout(cfg, 16, 32)
    al = PageAllocator(1 + lay.pages_per_seq)
    sched = Scheduler(lay, PagedTables(lay, 2, al), 2)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(rid=0, prompt=np.zeros(30, np.int32),
                             max_gen=10))
    sched2 = Scheduler(lay, PagedTables(lay, 2, PageAllocator(2)), 2)
    with pytest.raises(ValueError, match="pool"):
        sched2.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                              max_gen=4))


def test_scheduler_preempts_most_recent_and_requeues_front():
    cfg = get_config("qwen3-1.7b").reduced()
    lay = build_layout(cfg, 16, 32)
    tb = PagedTables(lay, 3, PageAllocator(1 + 3 * lay.pages_per_seq))
    sched = Scheduler(lay, tb, 3)
    for rid in range(3):
        sched.submit(Request(rid=rid, prompt=np.zeros(16, np.int32),
                             max_gen=8))
    group = sched.admit_group()
    assert [r.rid for _, r in group] == [0, 1, 2]
    for slot, req in group:
        req.generated = [11, 22]
        sched.slots[slot].step += 2
    sched.preempt(2)
    victim = sched.queue[0]
    assert victim.rid == 2 and victim.resume_pending == 22
    assert list(victim.prefill_tokens) == [0] * 16 + [11]
    assert tb.pages_held(2) == 0


# ---------------------------------------------------------------------------
# rwkv6-3b (ssm): slot-row state, prefill through K7's entry point
# ---------------------------------------------------------------------------

RWKV = "rwkv6-3b"


def _rwkv_reference_params(rcfg, seed=0):
    """The reference's init with ``u``, ``decay_base``, ``ln_b`` and the
    mu vectors (zeros / 0.5 at init) redrawn from a numpy seed, so the
    bonus term and the lerps are exercised."""
    rp = jax.tree_util.tree_map(np.asarray, r_get_model(rcfg).init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    blk = rp["blocks"]["sub0"]
    for group, names in (("wkv", ("u", "decay_base", "ln_b", "mu_r", "mu_k",
                                  "mu_v", "mu_w", "mu_g")),
                         ("cmix", ("mu_k", "mu_r"))):
        for name in names:
            x = blk[group][name]
            blk[group][name] = (0.5 * rng.standard_normal(x.shape)
                                ).astype(x.dtype)
    return rp


@pytest.fixture(scope="module")
def rwkv_ref():
    """Reduced rwkv6: the reference engine's greedy streams and logits
    rows, its static loop's sampled streams, and its Gumbel rows."""
    rcfg = r_get_config(RWKV).reduced()
    np_rp = _rwkv_reference_params(rcfg)
    rp = jax.tree_util.tree_map(jnp.asarray, np_rp)
    prompts = np.random.default_rng(1).integers(0, rcfg.vocab, (N, PROMPT),
                                                dtype=np.int32)
    eng = RDecodeEngine(rcfg, rp, RServeConfig(
        n_slots=N, max_len=MAX_LEN, page_size=16, record_logits=True))
    for i in range(N):
        eng.submit(prompts[i], GEN)
    greedy = eng.run()
    sampled = r_static_generate(rcfg, rp, jnp.asarray(prompts), GEN,
                                max_len=MAX_LEN, temperature=TEMP, seed=SEED)
    gumbel = {}
    base = jax.random.PRNGKey(SEED)
    for rid in range(N):
        for g in range(GEN):
            k = jax.random.fold_in(jax.random.fold_in(base, rid), g)
            gumbel[rid, g] = np.array(jax.random.gumbel(
                k, (rcfg.padded_vocab,), jnp.float32))
    return {"cfg": get_config(RWKV).reduced(), "prompts": prompts,
            "params": from_reference(np_rp), "greedy": greedy,
            "rows": eng.logits_rows, "sampled": sampled, "gumbel": gumbel}


def test_rwkv6_greedy_streams_match_reference_engine(rwkv_ref):
    eng = _engine(rwkv_ref["cfg"], rwkv_ref["params"], n_slots=N,
                  record_logits=True)
    assert eng.layout.subs == () and eng.layout.has_state
    for i in range(N):
        eng.submit(rwkv_ref["prompts"][i], GEN)
    res = eng.run()
    for i in range(N):
        assert np.array_equal(res[i], rwkv_ref["greedy"][i]), f"request {i}"
        np.testing.assert_allclose(np.stack(eng.logits_rows[i]),
                                   np.stack(rwkv_ref["rows"][i]), atol=TOL,
                                   rtol=0, err_msg=f"request {i}")
    assert eng.decode_cache_size == 1
    assert eng.stats()["n_prefill_calls"] == 1


def test_rwkv6_sampled_streams_match_reference(rwkv_ref):
    noise = _injected(rwkv_ref["gumbel"])
    out = static_generate(rwkv_ref["cfg"], rwkv_ref["params"],
                          rwkv_ref["prompts"], GEN, max_len=MAX_LEN,
                          temperature=TEMP, seed=SEED, device="cpu",
                          gumbel=noise)
    assert np.array_equal(out, rwkv_ref["sampled"])
    eng = _engine(rwkv_ref["cfg"], rwkv_ref["params"], n_slots=N,
                  temperature=TEMP, seed=SEED, gumbel=noise)
    for i in range(N):
        eng.submit(rwkv_ref["prompts"][i], GEN)
    res = eng.run()
    for i in range(N):
        assert np.array_equal(res[i], rwkv_ref["sampled"][i]), f"request {i}"


def test_rwkv6_continuous_bitwise_equals_static(rwkv_ref):
    eng = _engine(rwkv_ref["cfg"], rwkv_ref["params"], n_slots=N,
                  record_logits=True)
    for i in range(N):
        eng.submit(rwkv_ref["prompts"][i], GEN)
    res = eng.run()
    out, rows = static_generate(rwkv_ref["cfg"], rwkv_ref["params"],
                                rwkv_ref["prompts"], GEN,
                                max_len=eng.layout.max_len,
                                collect_logits=True, device="cpu")
    for i in range(N):
        assert np.array_equal(res[i], out[i])
        assert np.array_equal(np.stack(eng.logits_rows[i]),
                              np.stack([r[i] for r in rows]))


def _solo_streams_equal(cfg, params, prompts, specs, eng, res):
    for i, (pl, g) in enumerate(specs):
        solo = static_generate(cfg, params, prompts[i][:pl][None], g,
                               max_len=eng.layout.max_len, rids=[i],
                               device="cpu")
        assert np.array_equal(res[i], solo[0]), f"request {i}"


def test_rwkv6_mixed_prompt_lengths_match_solo_runs():
    """Prompt lengths 16, 21, 8, 17, 24 and 5 take scan chunks 16, 7, 8,
    1, 12 and 5 in the prefill; admitted mid-flight over 3 slots, every
    stream equals a solo static run of that request."""
    cfg, params, prompts = _port_setup(RWKV, n_prompts=6)
    specs = [(16, 8), (21, 4), (8, 10), (17, 3), (24, 6), (5, 5)]
    eng = _engine(cfg, params, n_slots=3)
    for i, (pl, g) in enumerate(specs):
        eng.submit(prompts[i][:pl], g)
    res = eng.run()
    _solo_streams_equal(cfg, params, prompts, specs, eng, res)
    assert eng.decode_cache_size == 1
    assert eng.stats()["n_prefill_calls"] >= 4


class _PreemptingEngine(DecodeEngine):
    """Preempts the most recently admitted running slot after the first
    decode micro-run: the ssm state has no pages, so a dry pool never
    forces it.  The victim resumes by re-prefilling prompt + generated."""

    def _decode_one_step(self):
        super()._decode_one_step()
        sched = self.scheduler
        if sched.n_preemptions == 0 and sched.running_slots():
            victim = max(sched.running_slots(),
                         key=lambda s: sched.slots[s].admit_seq)
            sched.preempt(victim)


def test_rwkv6_preemption_recovers_streams():
    cfg, params, prompts = _port_setup(RWKV, n_prompts=4)
    specs = [(16, 10), (24, 6), (8, 12), (16, 4)]
    eng = _PreemptingEngine(cfg, params, ServeConfig(
        n_slots=2, max_len=MAX_LEN, page_size=16), device="cpu")
    for i, (pl, g) in enumerate(specs):
        eng.submit(prompts[i][:pl], g)
    res = eng.run()
    assert eng.scheduler.n_preemptions == 1
    _solo_streams_equal(cfg, params, prompts, specs, eng, res)
    assert eng.decode_cache_size == 1


def test_rwkv6_eos_frees_slot_early():
    cfg, params, prompts = _port_setup(RWKV, n_prompts=4)
    probe = _engine(cfg, params, n_slots=2)
    for i in range(2):
        probe.submit(prompts[i], 6)
    eos = int(probe.run()[0][2])
    eng = _engine(cfg, params, n_slots=2, eos_id=eos)
    for i in range(4):
        eng.submit(prompts[i], 6)
    res = eng.run()
    first = int(np.flatnonzero(res[0] == eos)[0])
    assert res[0][-1] == eos and len(res[0]) == first + 1 <= 3
    assert all(len(res[i]) <= 6 for i in range(4))
    assert eng.decode_cache_size == 1


def test_ssm_prefill_gets_no_attn_impl():
    """The engine and the static loop pass ``attn_impl`` to the dense
    family's prefill only, as the reference's engine does."""
    seen = []
    for arch in (RWKV, "qwen3-1.7b"):
        cfg, params, prompts = _port_setup(arch, n_prompts=1, prompt_len=8)
        eng = _engine(cfg, params, n_slots=1)
        inner = eng.model.prefill

        def prefill(p, tokens, inner=inner, **kw):
            seen.append((arch, "attn_impl" in kw))
            return inner(p, tokens, **kw)

        eng.model = eng.model._replace(prefill=prefill)
        eng.submit(prompts[0], 2)
        eng.run()
    assert seen == [(RWKV, False), ("qwen3-1.7b", True)]


def test_rwkv6_slotted_reference_matches_engine():
    """The same-batching reference (``slotted_generate``) against the
    engine over fewer slots than requests, as the serving workload runs
    it: a first wave prefilled as one batch, later prompts admitted alone
    as slots free (two of length 16 together, once), every decode step
    over all slots.  The same batch shapes give the same numbers."""
    cfg, params, prompts = _port_setup(RWKV, n_prompts=7)
    specs = [(24, 5), (24, 7), (24, 3), (24, 6), (16, 4), (16, 2), (24, 1)]
    eng = _engine(cfg, params, n_slots=3, record_logits=True)
    for i, (pl, g) in enumerate(specs):
        eng.submit(prompts[i][:pl], g)
    res = eng.run()
    toks, rows = slotted_generate(
        cfg, params, [prompts[i][:pl] for i, (pl, _) in enumerate(specs)],
        [g for _, g in specs], n_slots=3, max_len=eng.layout.max_len,
        device="cpu")
    assert eng.stats()["n_prefill_calls"] == 5
    for i, (_, g) in enumerate(specs):
        assert np.array_equal(res[i], toks[i]), f"request {i}"
        mine = np.stack(eng.logits_rows[i])
        assert mine.shape == rows[i].shape == (g, cfg.padded_vocab)
        np.testing.assert_allclose(mine, rows[i], atol=1e-6, rtol=0,
                                   err_msg=f"request {i}")


def test_slotted_generate_is_for_state_space_models():
    cfg, params, prompts = _port_setup("qwen3-1.7b", n_prompts=1,
                                       prompt_len=8)
    with pytest.raises(ValueError, match="one position"):
        slotted_generate(cfg, params, prompts, [2], n_slots=1, max_len=16,
                         device="cpu")
