"""The shapes the port's configs give the attention kernels, checked on
the CPU so that an unsupported one fails here and not on the card.

* Every config the port registers whose family ``get_model`` accepts has
  a head dim that K3/K4's wrapper (``flash_decode.ops.HEAD_DIMS``) and
  K5/K6's (``flash_attention.ops.HEAD_DIMS``) take, and a GQA group in
  ``flash_decode.ops.N_REPS``; each of those constants has its case in
  the CUDA sources' dispatch switches.  ``reduced()`` cuts every config
  to head dim 32, which is how stablelm-3b's 80 hid until the kernels
  took it.
* stablelm-3b at a reduced size that keeps head dim 80 (d_model 160, 2
  heads of 80, 25% rotary: 20 rotated dims) against the reference:
  ``forward`` (chunked, past 512 positions) and ``prefill`` logits, three
  teacher-forced ``decode_step`` logits, and the paged engine's greedy
  streams (K3's plain version on CPU tensors) against the reference
  engine's, at 1e-4 (the dense family's bar).
* K5/K6's ``kv_len`` on CPU tensors (the plain versions): attention over
  a call padded with zero keys equals attention over the unpadded keys,
  and the padded rows of dK/dV are zero.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.serve.engine import DecodeEngine as RDecodeEngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import from_reference
from repro_torch.core import NotPortedError
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.models import get_model
from repro_torch.serve.engine import DecodeEngine, ServeConfig

TOL = 1e-4
HD80 = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80)


def _ported_configs():
    out = []
    for name in list_configs():
        cfg = get_config(name)
        try:
            get_model(cfg)
        except NotPortedError:
            continue
        out.append(cfg)
    return out


def _switch_cases(source: Path, fn: str):
    """The ``case N:`` labels of the C++ function ``fn``'s switch."""
    text = source.read_text()
    body = text[text.index(f" {fn}("):]
    body = body[:body.index("\n}\n")]
    return {int(x) for x in re.findall(r"case (\d+):", body)}


def test_every_ported_config_fits_the_kernels():
    cfgs = _ported_configs()
    assert {c.name for c in cfgs} >= {"stablelm-3b", "whisper-medium",
                                      "hymba-1.5b", "qwen2.5-14b"}
    for cfg in cfgs:
        hd, rep = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        assert cfg.n_heads % cfg.n_kv_heads == 0, cfg.name
        assert hd in decode_ops.HEAD_DIMS, (cfg.name, hd)
        assert hd in attn_ops.HEAD_DIMS, (cfg.name, hd)
        assert rep in decode_ops.N_REPS, (cfg.name, rep)
        # the wrappers' 16-byte rows in both dtypes
        assert hd % 8 == 0, (cfg.name, hd)
    assert get_config("stablelm-3b").head_dim == 80


def test_wrapper_constants_have_kernel_cases():
    assert _switch_cases(decode_ops.SOURCE, "by_head_dim") == \
        set(decode_ops.HEAD_DIMS)
    assert _switch_cases(decode_ops.SOURCE, "by_rep") == \
        set(decode_ops.N_REPS)
    for source in attn_ops.SOURCES.values():
        fn = "flash_attention" if source.name.endswith("sm90.cu") else \
            "by_head_dim"
        assert _switch_cases(source, fn) == set(attn_ops.HEAD_DIMS), source


# ---------------------------------------------------------------------------
# stablelm-3b at head dim 80 against the reference
# ---------------------------------------------------------------------------

S, S_LONG, MAX_LEN, FEED, N_REQ, GEN, PS = 12, 520, 32, 3, 2, 4, 16


@pytest.fixture(scope="module")
def stablelm():
    torch.set_num_threads(1)
    rcfg = r_get_config("stablelm-3b").reduced().replace(**HD80)
    cfg = get_config("stablelm-3b").reduced().replace(**HD80)
    rmodel = r_get_model(rcfg)
    rp = rmodel.init_params(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    long = rng.integers(0, cfg.vocab, (1, S_LONG), dtype=np.int32)
    toks = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
    fed = rng.integers(0, cfg.vocab, (FEED, 2, 1), dtype=np.int32)
    logits = rmodel.forward(rp, jnp.asarray(long), attn_impl="chunked",
                            q_chunk=1024)[0]
    pre, cache = rmodel.prefill(rp, jnp.asarray(toks), max_len=MAX_LEN,
                                attn_impl="reference")
    dec = []
    for t in fed:
        out, cache = rmodel.decode_step(rp, cache, jnp.asarray(t))
        dec.append(np.asarray(out))
    eng = RDecodeEngine(rcfg, rp, RServeConfig(
        n_slots=N_REQ, max_len=MAX_LEN, page_size=PS, record_logits=True))
    for i in range(N_REQ):
        eng.submit(toks[i], GEN)
    return {"cfg": cfg, "tp": from_reference(jax.tree_util.tree_map(
        np.asarray, rp)), "long": long, "toks": toks, "fed": fed,
        "logits": np.asarray(logits), "prefill": np.asarray(pre),
        "decode": dec, "greedy": eng.run(), "rows": eng.logits_rows}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0, err_msg=what)


def test_stablelm_head_dim_80_forward_and_decode(stablelm):
    cfg, tp = stablelm["cfg"], stablelm["tp"]
    assert cfg.head_dim == 80
    model = get_model(cfg)
    got = model.forward(tp, torch.as_tensor(stablelm["long"]),
                        attn_impl="chunked", q_chunk=1024)[0]
    _close(got, stablelm["logits"], "forward logits (chunked)")
    logits, cache = model.prefill(tp, torch.as_tensor(stablelm["toks"]),
                                  max_len=MAX_LEN, attn_impl="reference")
    _close(logits, stablelm["prefill"], "prefill logits")
    for i, (tok, want) in enumerate(zip(stablelm["fed"], stablelm["decode"])):
        logits, cache = model.decode_step(tp, cache, torch.as_tensor(tok))
        _close(logits, want, f"decode step {i}")


def test_stablelm_head_dim_80_engine_matches_reference(stablelm):
    eng = DecodeEngine(stablelm["cfg"], stablelm["tp"], ServeConfig(
        n_slots=N_REQ, max_len=MAX_LEN, page_size=PS, record_logits=True),
        device="cpu")
    for i in range(N_REQ):
        eng.submit(stablelm["toks"][i], GEN)
    res = eng.run()
    for i in range(N_REQ):
        np.testing.assert_array_equal(res[i], stablelm["greedy"][i])
        np.testing.assert_allclose(np.stack(eng.logits_rows[i]),
                                   np.stack(stablelm["rows"][i]), atol=TOL,
                                   rtol=0, err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# K5/K6's kv_len on the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 80])
def test_kv_len_equals_the_unpadded_call(hd):
    rng = np.random.default_rng(hd)
    sq, sk, pad = 20, 13, 7
    q, do = (torch.tensor(rng.normal(size=(2, sq, 4, hd)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(2, sk, 2, hd)), dtype=torch.float32)
            for _ in range(2))
    kp, vp = (torch.cat([x, torch.zeros(2, pad, 2, hd)], 1) for x in (k, v))
    o, lse = attn_ops.attention_fwd(q, k, v, causal=False)
    op, lsep = attn_ops.attention_fwd(q, kp, vp, causal=False, kv_len=sk)
    assert torch.allclose(o, op, atol=1e-6) and \
        torch.allclose(lse, lsep, atol=1e-6)
    dq, dk, dv = attn_ops.attention_bwd(q, k, v, o, lse, do, causal=False)
    dqp, dkp, dvp = attn_ops.attention_bwd(q, kp, vp, op, lsep, do,
                                           causal=False, kv_len=sk)
    assert torch.allclose(dq, dqp, atol=1e-5)
    assert torch.allclose(dk, dkp[:, :sk], atol=1e-5)
    assert torch.allclose(dv, dvp[:, :sk], atol=1e-5)
    assert not dkp[:, sk:].any() and not dvp[:, sk:].any()
    with pytest.raises(ValueError, match="kv_len"):
        attn_ops.attention_fwd(q, kp, vp, causal=False, kv_len=sk + pad + 1)
