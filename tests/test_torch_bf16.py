"""The port in bf16 (``param_dtype="bfloat16"``, the reference's own
switch) against ``repro.models.transformer`` in bf16, on reduced
internvl2-26b (the VLM: 2 layers, 8 patches of width 128) and reduced
gemma3-12b (4 layers, windowed 64 and global, head dim 32), the same
params (the reference's fp32 draw cast to bf16, which equals its bf16
draw) and the same numpy tokens and patches.

The bar.  Two bf16 evaluations of one function differ by where they
round, so they are held to a multiple of bf16's own rounding error on
this model: ``BAR = BAR_FACTOR`` x the reference's bf16 run's distance to
its fp32 run, each distance the largest over logits rows of
``||x - y|| / ||y||``.  On these models that distance is 2.7e-2-2.9e-2;
the port's bf16 run lies 2.1e-2-2.3e-2 from the reference's and
2.6e-2-3.0e-2 from its own fp32 run, and the planted fault below
1.2-1.3 from the reference's bf16 run (CPU readings), so 2 x leaves
room for where the two frameworks round.

* Prefill logits (the text positions; ``attend_reference``), a chunked
  forward past the chunk (``attend_chunked`` / ``attend_windowed``
  in bf16) and five teacher-forced ``decode_step`` logits: the port's bf16
  run within BAR of the reference's bf16 run, and of the port's fp32 run.
* A planted fault, one block of keys left out of layer 0's attention for
  every query past it (what a kernel that skipped its first key tile
  would give), fails the bar by far.
* Params, prefill and decode caches stay bf16; the VLM's fp32 patches
  are cast to bf16 before the projector's product; ``static_generate``
  returns float32 logits rows on a bf16 model.
* The reference's outputs are computed once per module, on one torch
  thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference
from repro_torch.models import get_model, transformer
from repro_torch.serve.engine import static_generate

ARCHS = ("internvl2-26b", "gemma3-12b")
BAR_FACTOR = 2.0
B, S, FEED, S_LONG, Q_CHUNK = 2, 24, 5, 192, 64
BF16 = torch.bfloat16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    """The largest, over logits rows, of ||got - want|| / ||want||."""
    got = np.asarray(got, np.float32).reshape(-1, np.shape(got)[-1])
    want = np.asarray(want, np.float32).reshape(-1, np.shape(want)[-1])
    return float((np.linalg.norm(got - want, axis=1)
                  / np.linalg.norm(want, axis=1)).max())


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + FEED), dtype=np.int32)
    long = rng.integers(0, cfg.vocab, (B, S_LONG), dtype=np.int32)
    extra = {}
    if cfg.n_patches:
        extra["patches"] = rng.normal(size=(
            B, cfg.n_patches, transformer.vit_width(cfg))).astype(np.float32)
    return toks, long, extra


def _ref_outputs(rcfg, rp, toks, long, extra):
    """The reference's (prefill text logits, chunked forward text logits,
    [decode logits]) in fp32 numpy."""
    m = r_get_model(rcfg)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    max_len = rcfg.n_patches + S + FEED + 2
    pre, cache = m.prefill(rp, jnp.asarray(toks[:, :S]), max_len=max_len,
                           attn_impl="reference", **jx)
    fwd = m.forward(rp, jnp.asarray(long), attn_impl="chunked",
                    q_chunk=Q_CHUNK, **jx)[0]
    step = jax.jit(m.decode_step)
    dec = []
    for t in range(S, S + FEED):
        out, cache = step(rp, cache, jnp.asarray(toks[:, t:t + 1]))
        dec.append(np.asarray(out.astype(jnp.float32)))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))
    return f32(pre)[:, -S:], f32(fwd)[:, -S_LONG:], dec


def _port_outputs(cfg, tp, toks, long, extra, fault=0):
    """The port's outputs as ``_ref_outputs``; ``fault`` > 0 leaves layer
    0's first ``fault`` keys out of every query row past them."""
    m = get_model(cfg)
    tx = {k: torch.as_tensor(v) for k, v in extra.items()}
    max_len = cfg.n_patches + S + FEED + 2
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
        with torch.no_grad():
            pre, cache = m.prefill(tp, torch.as_tensor(toks[:, :S]),
                                   max_len=max_len, attn_impl="reference",
                                   **tx)
            calls.clear()
            fwd = m.forward(tp, torch.as_tensor(long), attn_impl="chunked",
                            q_chunk=Q_CHUNK, **tx)[0]
            dec = []
            for t in range(S, S + FEED):
                out, cache = m.decode_step(tp, cache,
                                           torch.as_tensor(toks[:, t:t + 1]))
                dec.append(out.float().numpy())
    finally:
        transformer.attend = orig
    return pre.float().numpy()[:, -S:], fwd.float().numpy()[:, -S_LONG:], \
        dec, cache


@pytest.fixture(scope="module")
def cases():
    """Per arch: the reference in fp32 and bf16, the port in fp32 and
    bf16, and the bar; computed once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for i, arch in enumerate(ARCHS):
        r32 = r_get_config(arch).reduced()
        r16 = r32.replace(param_dtype="bfloat16")
        c32 = get_config(arch).reduced()
        c16 = c32.replace(param_dtype="bfloat16")
        rp32 = jax.jit(r_get_model(r32).init_params)(jax.random.PRNGKey(3 + i))
        rp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), rp32)
        tp32 = from_reference(_np(rp32))
        tp16 = {p: x.to(BF16) for p, x in tp32.items()}
        toks, long, extra = _inputs(c32, 11 + i)
        ref32 = _ref_outputs(r32, rp32, toks, long, extra)
        ref16 = _ref_outputs(r16, rp16, toks, long, extra)
        port32 = _port_outputs(c32, tp32, toks, long, extra)
        port16 = _port_outputs(c16, tp16, toks, long, extra)
        floor = max(_rel(a, b) for a, b in
                    zip(_rows(ref16), _rows(ref32)))
        out[arch] = dict(c16=c16, rp16=rp16, rp32=rp32, tp16=tp16, toks=toks,
                         long=long, extra=extra, ref16=ref16, port32=port32,
                         port16=port16, bar=BAR_FACTOR * floor, floor=floor)
    torch.set_num_threads(before)
    return out


def _rows(outs):
    """(prefill, forward, decode...) as one list of logits arrays."""
    return [outs[0], outs[1], *outs[2]]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_bar_is_bf16_sized(cases, arch):
    """The reference's own bf16 error on this model: bf16-sized, neither
    0 (a run that never rounded) nor large (a broken bf16 path)."""
    floor = cases[arch]["floor"]
    assert 2.0 ** -10 < floor < 2.0 ** -4, floor


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("part", ["prefill", "forward", "decode"])
def test_bf16_logits_match_reference_bf16(cases, arch, part):
    c = cases[arch]
    idx = {"prefill": [0], "forward": [1], "decode": range(2, 2 + FEED)}[part]
    got, want = _rows(c["port16"]), _rows(c["ref16"])
    for i in idx:
        assert got[i].dtype == np.float32
        err = _rel(got[i], want[i])
        assert err <= c["bar"], (arch, part, i, err, c["bar"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_port_within_bar_of_fp32_port(cases, arch):
    c = cases[arch]
    for i, (got, want) in enumerate(zip(_rows(c["port16"]),
                                        _rows(c["port32"]))):
        err = _rel(got, want)
        assert 0 < err <= c["bar"], (arch, i, err, c["bar"])


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_fault_fails_the_bar(cases, arch):
    c = cases[arch]
    bad = _port_outputs(c["c16"], c["tp16"], c["toks"], c["long"],
                        c["extra"], fault=4)
    err = _rel(bad[0], c["ref16"][0])
    assert err > 10 * c["bar"], (arch, err, c["bar"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_caches_and_patches(cases, arch):
    c = cases[arch]
    cfg = c["c16"]
    m = get_model(cfg)
    drawn = m.init_params(torch.Generator().manual_seed(0))
    assert {x.dtype for x in drawn.values()} == {BF16}
    assert {x.dtype for x in c["tp16"].values()} == {BF16}
    cache = c["port16"][3]
    assert cache["step"].dtype == torch.int32
    assert {x.dtype for p, x in cache.items() if p != "step"} == {BF16}
    assert int(cache["step"]) == cfg.n_patches + S + FEED
    assert {x.dtype for p, x in m.init_cache(B, 8, device="cpu").items()
            if p != "step"} == {BF16}
    if cfg.n_patches:
        patches = torch.as_tensor(c["extra"]["patches"])
        assert patches.dtype == torch.float32
        x = transformer._embed_inputs(cfg, c["tp16"],
                                      torch.as_tensor(c["toks"][:, :S]),
                                      patches)
        assert x.dtype == BF16
        w, b = c["tp16"]["projector/w"], c["tp16"]["projector/b"]
        assert torch.equal(x[:, :cfg.n_patches], patches.to(BF16) @ w + b)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_on_bf16_params(cases, arch):
    """The static loop on bf16 params: float32 rows, and its first row is
    the bf16 prefill's last row."""
    c = cases[arch]
    cfg = c["c16"]
    extra = {k: torch.as_tensor(v) for k, v in c["extra"].items()}
    toks, rows = static_generate(cfg, c["tp16"], c["toks"][:, :S], 3,
                                 max_len=cfg.n_patches + S + 4,
                                 collect_logits=True, device="cpu",
                                 extra=extra)
    assert toks.shape == (B, 3) and len(rows) == 3
    assert all(r.dtype == np.float32 for r in rows)
    np.testing.assert_array_equal(rows[0], c["port16"][0][:, -1])
    np.testing.assert_array_equal(toks[:, 0], rows[0].argmax(-1))
