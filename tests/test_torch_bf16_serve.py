"""bf16 serving through the paged engine: the port's ``DecodeEngine`` on
bf16 params (``param_dtype="bfloat16"``, the reference's own switch)
against the reference's bf16 ``DecodeEngine``, on reduced qwen3-1.7b,
gemma3-12b and hymba-1.5b (``max_len`` past their reduced window of 64,
so the rings wrap; hymba's SSM branch beside its attention, K3 at a GQA
group of 2 here), stablelm-3b and rwkv6-3b (slot-row states, no
pages).  Both
engines get the reference's bf16 draw (its fp32 draw cast), converted by
``convert.from_reference``, and the same numpy prompts.

The bar.  Two bf16 runs of one function differ by where they round, so
the port's bf16 rows are held to ``BAR = BAR_FACTOR`` x the reference's
own bf16 run's distance from its fp32 run, each distance the largest
over logits rows of ``||x - y|| / ||y||``.  Rows are comparable only
while the runs' token histories agree, and on random weights greedy
streams part at near ties within a few steps (on these models 22-81% of
the steps come before the first near tie, by seed).  So the bf16 runs
held to the bar are teacher-forced through the engines' own sampling to
the reference's fp32 greedy streams (the port's through its injected
noise, a one-hot of ``FORCE`` at the forced token; the reference's
through its ``sample_tokens``, replaced for the run): every step of
every request is compared.  The free greedy streams are held to the
near-tie rule: the port's bf16 stream equals the reference's fp32
stream up to the first step where the fp32 row's two largest logits lie
closer than the largest elementwise difference between the reference's
bf16 and fp32 rows there.

* A planted fault fails the bar: layer 0's attention with the first page
  of every sequence left out (K3's call), or rwkv6 layer 0's prefill
  scan with the carry between chunks dropped (K7's call).
* ``record_logits=True`` and ``slotted_generate`` run on bf16 params,
  their rows float32 on the host.
* The page pool is bf16, rwkv6's mixes bf16 and its WKV state fp32,
  hymba's conv state bf16 and its SSM state fp32, and the decode step
  sees one input signature.
* ``serve_workload.build`` refuses params whose dtype is not the
  config's; ``serve_workload.cast`` makes a workload's bf16 twin.

The reference's outputs are computed once per module, on one torch
thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as r_engine
from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro_torch import serve_workload as sw
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference
from repro_torch.kernels.flash_decode.ops import paged_decode_attention
from repro_torch.kernels.rwkv6_scan.ops import wkv
from repro_torch.models import hymba, rwkv6, transformer
from repro_torch.serve.engine import DecodeEngine, ServeConfig, \
    slotted_generate

ARCHS = ("qwen3-1.7b", "gemma3-12b", "stablelm-3b", "rwkv6-3b",
         "hymba-1.5b")
BAR_FACTOR = 2.0
FORCE = 1e4                   # the forced token's noise: above any logit
N_SLOTS, PAGE = 2, 16
# (prompt length, max_len): gemma3's and hymba's reduced window is 64, so
# their rings wrap in the prefill and again in the decode steps
SHAPES = {"gemma3-12b": (70, 96), "hymba-1.5b": (70, 96)}
PROMPT, MAX_LEN = 24, 48
GENS = (8, 5, 7)              # 3 requests over 2 slots: one waits
BF16 = torch.bfloat16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_run(rcfg, rp, prompts, max_len, forced=None):
    """The reference's engine, greedy, or with every token forced to
    ``forced[rid][gidx]`` (its ``sample_tokens`` replaced for the run);
    returns (tokens, float32 rows) by request."""
    real = r_engine.sample_tokens
    if forced is not None:
        width = max(len(t) for t in forced.values())
        table = jnp.asarray(np.stack([np.pad(forced[i], (0, width - len(
            forced[i]))) for i in range(len(forced))]))

        def sample(logits, rids, gidx, **_):
            return table[jnp.clip(rids, 0, table.shape[0] - 1),
                         jnp.clip(gidx, 0, width - 1)]
        r_engine.sample_tokens = sample
    try:
        eng = r_engine.DecodeEngine(rcfg, rp, r_engine.ServeConfig(
            n_slots=N_SLOTS, max_len=max_len, page_size=PAGE,
            record_logits=True))
        for p, g in zip(prompts, GENS):
            eng.submit(p, g)
        out = eng.run()
    finally:
        r_engine.sample_tokens = real
    return out, {i: np.stack([np.asarray(r, np.float32) for r in rs])
                 for i, rs in eng.logits_rows.items()}


def _forcing(forced):
    """The port's injected noise that forces ``forced[rid][gidx]``: a
    one-hot of FORCE (zeros for a slot with nothing to force)."""
    def noise(rids, gidx, vocab):
        g = torch.zeros((len(rids), vocab))
        for j, (r, x) in enumerate(zip(rids.tolist(), gidx.tolist())):
            if r in forced and x < len(forced[r]):
                g[j, forced[r][x]] = FORCE
        return g
    return noise


def _port_run(cfg, params, prompts, max_len, forced=None):
    """The port's engine on the CPU, greedy or forced as ``_ref_run``;
    returns (engine, tokens, rows) by request."""
    eng = DecodeEngine(cfg, params, ServeConfig(
        n_slots=N_SLOTS, max_len=max_len, page_size=PAGE,
        temperature=0.0 if forced is None else 1.0, record_logits=True),
        device="cpu", gumbel=None if forced is None else _forcing(forced))
    for p, g in zip(prompts, GENS):
        eng.submit(p, g)
    out = eng.run()
    return eng, out, {i: np.stack(rs) for i, rs in eng.logits_rows.items()}


def _near_tie_steps(rows32, rows16):
    """Per request, the steps up to and including the first where the
    fp32 row's top-2 gap is below the largest elementwise difference
    between the bf16 and fp32 rows (the streams may part there)."""
    n = {}
    for i, r32 in rows32.items():
        n[i] = len(r32)
        for t in range(len(r32)):
            top2 = np.sort(r32[t])[-2:]
            if top2[1] - top2[0] < np.abs(rows16[i][t] - r32[t]).max():
                n[i] = t + 1
                break
    return n


def _dist(got, want):
    """The largest, over every row, of ||got - want|| / ||want||."""
    return max(float((np.linalg.norm(got[i] - want[i], axis=1)
                      / np.linalg.norm(want[i], axis=1)).max())
               for i in want)


class _Fault:
    """Layer 0's K3 call (the first of every ``n_layers``) with the first
    page of every sequence left out, or its K7 call with the carry
    between chunks dropped (each chunk scanned from a zero state), on the
    port's module attributes (hymba's K3 call site is its own module's);
    restored on exit."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, 0

    def _k3(self, q, kp, vp, pt, valid):
        self.calls += 1
        if (self.calls - 1) % self.cfg.n_layers:
            return paged_decode_attention(q, kp, vp, pt, valid)
        ps = kp.shape[1]
        return paged_decode_attention(q, kp, vp, pt[:, 1:].contiguous(),
                                      torch.where(valid > ps, valid - ps,
                                                  valid))

    def _k7(self, r, k, v, ld, u, *, chunk):
        self.calls += 1
        if (self.calls - 1) % self.cfg.n_layers:
            return wkv(r, k, v, ld, u, chunk=chunk)
        b, s, h, dk = r.shape
        n = s // chunk

        def split(x):
            return x.reshape(b * n, chunk, h, x.shape[-1])
        o, st = wkv(split(r), split(k), split(v), split(ld), u, chunk=chunk)
        return (o.reshape(b, s, h, -1),
                st.reshape(b, n, h, dk, -1)[:, -1].contiguous())

    def __enter__(self):
        if self.cfg.family == "ssm":
            self.mod, self.name, fn = rwkv6, "wkv", self._k7
        else:
            self.mod, self.name, fn = (
                hymba if self.cfg.family == "hybrid" else transformer,
                "paged_decode_attention", self._k3)
        self.real = getattr(self.mod, self.name)
        setattr(self.mod, self.name, fn)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


@pytest.fixture(scope="module")
def cases():
    """Per arch: the reference's fp32 greedy run and its bf16 run forced
    to that stream, the port's bf16 runs greedy and forced, and the bar;
    computed once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for i, arch in enumerate(ARCHS):
        prompt_len, max_len = SHAPES.get(arch, (PROMPT, MAX_LEN))
        r32 = r_get_config(arch).reduced()
        r16 = r32.replace(param_dtype="bfloat16")
        c16 = get_config(arch).reduced().replace(param_dtype="bfloat16")
        rp32 = jax.jit(r_get_model(r32).init_params)(jax.random.PRNGKey(5 + i))
        if r32.family == "ssm":
            rp32["blocks"]["sub0"]["wkv"]["decay_base"] = jnp.asarray(
                rwkv6.decay_base_init(r32.n_layers, r32.n_heads,
                                      r32.head_dim).numpy())
        rp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), rp32)
        tp16 = from_reference(_np(rp16))
        prompts = np.random.default_rng(21 + i).integers(
            0, r32.vocab, (len(GENS), prompt_len), dtype=np.int32)
        toks32, ref32 = _ref_run(r32, rp32, prompts, max_len)
        _, ref16 = _ref_run(r16, rp16, prompts, max_len, forced=toks32)
        eng, toks, greedy16 = _port_run(c16, tp16, prompts, max_len)
        _, _, port16 = _port_run(c16, tp16, prompts, max_len, forced=toks32)
        floor = _dist(ref16, ref32)
        out[arch] = dict(c16=c16, tp16=tp16, prompts=prompts, max_len=max_len,
                         toks32=toks32, ref32=ref32, ref16=ref16, eng=eng,
                         toks=toks, greedy16=greedy16, port16=port16,
                         floor=floor, bar=BAR_FACTOR * floor)
    torch.set_num_threads(before)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_bar_is_bf16_sized(cases, arch):
    """The reference's own bf16 error on this model: bf16-sized, neither
    0 (a run that never rounded) nor large (a broken bf16 path)."""
    floor = cases[arch]["floor"]
    assert 2.0 ** -10 < floor < 2.0 ** -4, floor


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_engine_rows_match_reference_bf16(cases, arch):
    """Forced to the fp32 streams, every row of every request: the port's
    bf16 engine within the bar of the reference's."""
    c = cases[arch]
    assert {i: len(r) for i, r in c["port16"].items()} == dict(
        enumerate(GENS))
    err = _dist(c["port16"], c["ref16"])
    assert 0 < err <= c["bar"], (arch, err, c["bar"])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_part_only_at_near_ties(cases, arch):
    """The port's free bf16 stream equals the reference's fp32 stream up
    to the first near tie; up to there its rows are the forced run's."""
    c = cases[arch]
    n = _near_tie_steps(c["ref32"], c["ref16"])
    for i, k in n.items():
        assert len(c["toks"][i]) == GENS[i]
        assert np.array_equal(c["toks"][i][:k - 1],
                              c["toks32"][i][:k - 1]), (arch, i, k)
        assert np.array_equal(c["greedy16"][i][:k], c["port16"][i][:k])


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_fault_fails_the_bar(cases, arch):
    c = cases[arch]
    with _Fault(c["c16"]) as fault:
        _, _, bad = _port_run(c["c16"], c["tp16"], c["prompts"],
                              c["max_len"], forced=c["toks32"])
    assert fault.calls > 0
    err = _dist(bad, c["ref16"])
    assert err > 4 * c["bar"], (arch, err, c["bar"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_engine_types(cases, arch):
    """float32 rows on the host from bf16 params (prefill and decode
    rows), bf16 pools and mixes, fp32 WKV state, one decode signature."""
    c = cases[arch]
    eng = c["eng"]
    assert {x.dtype for x in c["tp16"].values()} == {BF16}
    assert all(r.dtype == np.float32 and r.shape[0] == g
               for r, g in zip(c["greedy16"].values(), GENS))
    if c["c16"].family == "ssm":
        assert eng.paged["state/sub0/x_tmix"].dtype == BF16
        assert eng.paged["state/sub0/x_cmix"].dtype == BF16
        assert eng.paged["state/sub0/wkv"].dtype == torch.float32
    else:
        assert {eng.paged["pool/k"].dtype, eng.paged["pool/v"].dtype} == {BF16}
    if c["c16"].family == "hybrid":
        assert eng.paged["state/sub0/conv"].dtype == BF16
        assert eng.paged["state/sub0/ssm"].dtype == torch.float32
    assert eng.decode_cache_size == 1
    if arch in SHAPES:
        assert any(s.ring for s in eng.layout.subs)


def test_slotted_generate_on_bf16_params(cases):
    """rwkv6's slot-batched oracle on bf16 params: float32 rows, equal to
    the engine's (on the CPU both run the same batches)."""
    c = cases["rwkv6-3b"]
    toks, rows = slotted_generate(c["c16"], c["tp16"], c["prompts"], GENS,
                                  n_slots=N_SLOTS, max_len=c["max_len"],
                                  device="cpu")
    for i, g in enumerate(GENS):
        assert rows[i].dtype == np.float32 and rows[i].shape[0] == g
        assert np.array_equal(toks[i], c["toks"][i])
        assert np.array_equal(rows[i], c["greedy16"][i])


def _tiny(dtype):
    return {"embed/table": torch.zeros((4, 8), dtype=dtype),
            "final_norm/scale": torch.ones((8,), dtype=dtype)}


def test_build_refuses_params_of_another_dtype():
    with pytest.raises(ValueError, match="param_dtype float32"):
        sw.build("cpu", params=_tiny(BF16))
    with pytest.raises(ValueError, match="param_dtype bfloat16"):
        sw.build("cpu", params=_tiny(torch.float32),
                 param_dtype="bfloat16")
    w = sw.build("cpu", params=_tiny(BF16), param_dtype="bfloat16")
    assert w.cfg.param_dtype == "bfloat16"


def test_cast_makes_the_bf16_twin():
    w32 = sw.build("cpu", params=_tiny(torch.float32))
    want = {p: x.clone() for p, x in w32.params.items()}
    old = w32.params
    w16 = sw.cast(w32)
    assert old == {} and w32.params is old
    assert w16.cfg.param_dtype == "bfloat16"
    assert w32.cfg.param_dtype == "float32"
    assert list(w16.params) == list(want)
    for p, x in want.items():
        assert torch.equal(w16.params[p], x.to(BF16))
    assert np.array_equal(w16.prompts, w32.prompts)
    assert (w16.gens, w16.serve, w16.traffic) == (w32.gens, w32.serve,
                                                  w32.traffic)
