"""whisper-medium (the ``audio`` family) in bf16 (``param_dtype=
"bfloat16"``, the reference's own switch) against ``repro.models.whisper``
in bf16, on reduced whisper-medium with 300 frames (the encoder past
``attend``'s chunk, so its non-causal attention takes the chunked
route), the same numpy params (the reference's bf16 draw, its fp32 draw
cast, through ``convert.from_reference``) and the same bf16 frames.

The frames are bf16 in both packages: on bf16 params both refuse fp32
frames (the reference's encoder promotes to fp32 and its decoder's
``lax.scan`` raises ``TypeError``; the port's first projection raises
``RuntimeError``), and neither casts them.  One test pins that refusal.

The bars, as ``test_torch_bf16_serve.py`` and ``test_torch_bf16_round.py``
set them: two bf16 runs of one function differ by where they round, so
the port is held to ``BAR_FACTOR`` x the reference's own bf16 run's
distance from its fp32 run.

* ``static_generate`` (the family's only serving loop): the rows of both
  bf16 runs teacher-forced to the reference's fp32 greedy streams (the
  port's through its injected noise, the reference's through its
  ``sample_tokens`` replaced for the run), every row compared; the port's
  free greedy stream equals the reference's fp32 stream up to the first
  near tie.
* One step's loss and gradients, on the CPU's chunked route and on the
  card's route (``attention._attend_kernel``: the encoder's and the
  cross-attention's keys padded to whole blocks and masked by ``kv_len``
  through ``pad_noncausal``, which on CPU tensors runs K5/K6's plain
  versions in bf16).
* Planted faults fail both bars: layer 0's first 64 cross-cache
  positions left out of its decode steps' cross-attention (K4's call),
  and layer 0's first encoder key tile left out of every later query
  tile.
* The self and cross caches are bf16 (``init_cache`` and ``prefill``),
  the rows float32 on the host.
* The round's data path: ``FederatedLoader`` takes bf16 frames as a
  tensor and draws bitwise the rows the reference's loader draws from
  the same frames as ``ml_dtypes.bfloat16``; one hub round of reduced
  whisper in bf16 through ``Federation.from_config`` on them keeps every
  param bf16.

The reference's outputs are computed once per module, on one torch
thread.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.data.partition as r_partition
import repro.serve.engine as r_engine
from repro.configs.base import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config
from repro_torch.convert import from_reference
from repro_torch.core import FLConfig, Federation
from repro_torch.data import FederatedLoader, iid_partition, lm_batch
from repro_torch.launch import steps
from repro_torch.models import attention, get_model, whisper
from repro_torch.serve.engine import static_generate

ARCH = "whisper-medium"
OVER = {"enc_seq": 300}        # past the encoder's chunk: the chunked route
BF16 = torch.bfloat16
BAR_FACTOR = 2.0
FORCE = 1e4                    # the forced token's noise: above any logit
B, PROMPT, GEN, MAX_LEN = 3, 8, 10, 24
S, Q_CHUNK = 64, 64            # the loss's decoder tokens, past q_chunk / 2
FAULT_KEYS = 64                # positions a fault leaves out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch16(x):
    """An ``ml_dtypes.bfloat16`` array as a bf16 tensor, bit for bit."""
    return torch.from_numpy(x.view(np.int16).copy()).view(BF16)


def _rows_dist(got, want):
    """The largest, over every row, of ||got - want|| / ||want||."""
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


def _grad_dist(got, want):
    """The largest, over leaves, of ||got - want|| / ||want||."""
    return max(float(np.linalg.norm(np.float64(got[p]) - w)
                     / np.linalg.norm(w))
               for p, w in ((p, np.float64(w)) for p, w in want.items()))


def _ref_generate(rcfg, rp, prompts, frames, forced=None):
    """The reference's ``static_generate``, greedy, or with every token
    forced to ``forced[b, t]`` (its ``sample_tokens`` replaced for the
    run); returns (tokens, float32 rows (GEN, B, V))."""
    real = r_engine.sample_tokens
    if forced is not None:
        table = jnp.asarray(forced)
        r_engine.sample_tokens = lambda logits, rids, gidx, **_: \
            table[rids, gidx]
    try:
        toks, rows = r_engine.static_generate(
            rcfg, rp, jnp.asarray(prompts), GEN, max_len=MAX_LEN,
            collect_logits=True, extra={"frames": jnp.asarray(frames)})
    finally:
        r_engine.sample_tokens = real
    return np.asarray(toks), np.stack([np.asarray(r, np.float32)
                                       for r in rows])


def _forcing(forced):
    """The port's injected noise that forces ``forced[b, t]``: a one-hot
    of FORCE."""
    def noise(rids, gidx, vocab):
        g = torch.zeros((len(rids), vocab))
        g[torch.arange(len(rids)), torch.as_tensor(
            forced[rids, gidx], dtype=torch.long)] = FORCE
        return g
    return noise


class _CrossFault:
    """Layer 0's cross-attention in every decode step (the second
    ``_decode_attend`` call of each step) with the first FAULT_KEYS
    cross-cache positions left out."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, 0

    def __enter__(self):
        self.real = whisper._decode_attend

        def faulty(q, k, v, valid):
            self.calls += 1
            if (self.calls - 1) % (2 * self.cfg.n_layers) != 1:
                return self.real(q, k, v, valid)
            t = FAULT_KEYS
            return self.real(q, k[:, t:], v[:, t:], valid - t)
        whisper._decode_attend = faulty
        return self

    def __exit__(self, *exc):
        whisper._decode_attend = self.real


def _port_generate(cfg, tp, prompts, frames, forced=None, fault=False):
    """The port's ``static_generate`` on the CPU, greedy or forced as
    ``_ref_generate``; returns (tokens, float32 rows (GEN, B, V))."""
    kw = {} if forced is None else dict(temperature=1.0,
                                        gumbel=_forcing(forced))
    with (_CrossFault(cfg) if fault else contextlib.nullcontext()):
        toks, rows = static_generate(
            cfg, tp, prompts, GEN, max_len=MAX_LEN, collect_logits=True,
            device="cpu", extra={"frames": frames}, **kw)
    return toks, np.stack(rows)


def _port_grads(cfg, tp, batch, route="chunked", fault=False):
    """The port's loss and gradients (fp32 numpy) in bf16.  ``route``
    ``"padded"`` sends every attention call through the card's route on
    CPU tensors (``attention._attend_kernel``: K5/K6's plain versions,
    the encoder's and the cross-attention's calls through
    ``pad_noncausal``, the decoder's causal one padded to whole blocks
    and sliced back); ``fault`` leaves
    the encoder's layer 0 key tile 0 out of every later query tile."""
    orig, calls = whisper.attend, []

    def attend(q, k, v, *, impl, causal, q_chunk):
        def one(q, k, v):
            if route == "padded":
                return attention._attend_kernel(q, k, v, causal=causal,
                                                window=0, q_offset=0)
            return orig(q, k, v, impl=impl, causal=causal, q_chunk=q_chunk)
        o = one(q, k, v)
        if fault and not calls:
            o = o.clone()
            t = FAULT_KEYS
            o[:, t:] = one(q[:, t:], k[:, t:], v[:, t:])
        calls.append(causal)
        return o

    whisper.attend = attend
    try:
        leaves = {p: x.clone().requires_grad_(True) for p, x in tp.items()}
        loss, _ = get_model(cfg).loss_fn(leaves, batch, attn_impl="chunked",
                                         q_chunk=Q_CHUNK)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        whisper.attend = orig
    assert {g.dtype for g in grads} == {BF16}
    assert calls[:cfg.n_enc_layers] == [False] * cfg.n_enc_layers
    return float(loss.detach()), {p: g.float().numpy()
                                  for p, g in zip(leaves, grads)}


@pytest.fixture(scope="module")
def case():
    """The reference's fp32 and bf16 runs (generation and one step's
    gradients), the port's bf16 runs, and the bars; computed once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    r32 = r_get_config(ARCH).reduced().replace(**OVER)
    r16 = r32.replace(param_dtype="bfloat16")
    c16 = get_config(ARCH).reduced().replace(param_dtype="bfloat16", **OVER)
    rp32 = jax.jit(r_get_model(r32).init_params)(jax.random.PRNGKey(3))
    rp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), rp32)
    tp16 = from_reference(_np(rp16))
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, r32.vocab, (B, PROMPT), dtype=np.int32)
    frames32 = rng.normal(size=(B, r32.enc_seq, r32.d_model)).astype(
        np.float32)
    frames16 = frames32.astype(ml_dtypes.bfloat16)
    toks32, ref32 = _ref_generate(r32, rp32, prompts, frames32)
    _, ref16 = _ref_generate(r16, rp16, prompts, frames16, forced=toks32)
    ft16 = _torch16(frames16)
    toks, greedy16 = _port_generate(c16, tp16, prompts, ft16)
    _, port16 = _port_generate(c16, tp16, prompts, ft16, forced=toks32)

    batch = dict(lm_batch(2, S, r32.vocab, key=3))
    fr32 = rng.normal(size=(2, r32.enc_seq, r32.d_model)).astype(np.float32)
    fr16 = fr32.astype(ml_dtypes.bfloat16)
    grads = {}
    for name, rcfg, rp, fr in (("fp32", r32, rp32, fr32),
                               ("bf16", r16, rp16, fr16)):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["frames"] = jnp.asarray(fr)
        (loss, _), g = jax.jit(jax.value_and_grad(functools.partial(
            r_get_model(rcfg).loss_fn, attn_impl="chunked",
            q_chunk=Q_CHUNK), has_aux=True))(rp, jb)
        grads[name] = (float(loss), {p: x.float().numpy() for p, x in
                                     from_reference(_np(g)).items()})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tb["frames"] = _torch16(fr16)
    rows_floor = _rows_dist(ref16, ref32)
    grad_floor = _grad_dist(grads["bf16"][1], grads["fp32"][1])
    out = dict(r16=r16, rp16=rp16, c16=c16, tp16=tp16, prompts=prompts,
               frames32=frames32, ft16=ft16, toks32=toks32, ref32=ref32,
               ref16=ref16, toks=toks, greedy16=greedy16, port16=port16,
               floor={"rows": rows_floor, "grads": grad_floor},
               bar={"rows": BAR_FACTOR * rows_floor,
                    "grads": BAR_FACTOR * grad_floor},
               grads=grads, batch=tb)
    yield out
    torch.set_num_threads(before)


@pytest.mark.parametrize("what", ["rows", "grads"])
def test_bf16_bars_are_bf16_sized(case, what):
    """The reference's own bf16 error: bf16-sized, neither 0 (a run that
    never rounded) nor large (a broken bf16 path)."""
    floor = case["floor"][what]
    assert 2.0 ** -10 < floor < 2.0 ** -3, floor


def test_static_generate_rows_match_reference_bf16(case):
    """Forced to the fp32 streams, every row of every sequence: the port's
    bf16 loop within the bar of the reference's."""
    assert case["port16"].shape == case["ref16"].shape == (
        GEN, B, case["c16"].padded_vocab)
    err = _rows_dist(case["port16"], case["ref16"])
    assert 0 < err <= case["bar"]["rows"], (err, case["bar"])


def test_greedy_streams_part_only_at_near_ties(case):
    """The port's free bf16 stream equals the reference's fp32 stream up
    to each sequence's first near tie (the fp32 row's top-2 gap below
    the largest |bf16 - fp32| there); up to there its rows are the
    forced run's."""
    r32, r16 = case["ref32"], case["ref16"]
    for i in range(B):
        k = GEN
        for t in range(GEN):
            top2 = np.sort(r32[t, i])[-2:]
            if top2[1] - top2[0] < np.abs(r16[t, i] - r32[t, i]).max():
                k = t + 1
                break
        assert np.array_equal(case["toks"][i, :k - 1],
                              case["toks32"][i, :k - 1]), (i, k)
        assert np.array_equal(case["greedy16"][:k, i], case["port16"][:k, i])


@pytest.mark.parametrize("route", ["chunked", "padded"])
def test_bf16_loss_and_grads_match_reference_bf16(case, route):
    """One step's loss and every gradient on the CPU's chunked route and
    on the card's padded non-causal route (K5/K6's plain versions in
    bf16, keys masked by ``kv_len``), within the bar of the reference's
    bf16 step."""
    loss, grads = _port_grads(case["c16"], case["tp16"], case["batch"],
                              route)
    rloss, rgrads = case["grads"]["bf16"]
    assert set(grads) == set(rgrads)
    assert abs(loss - rloss) / abs(rloss) <= case["bar"]["grads"]
    err = _grad_dist(grads, rgrads)
    assert 0 < err <= case["bar"]["grads"], (route, err, case["bar"])


@pytest.mark.parametrize("what", ["rows", "grads"])
def test_planted_fault_fails_the_bar(case, what):
    """Layer 0's first 64 cross-cache positions left out of its decode
    steps (rows), or its first encoder key tile left out of every later
    query tile (gradients): well outside the bar."""
    if what == "rows":
        _, bad = _port_generate(case["c16"], case["tp16"], case["prompts"],
                                case["ft16"], forced=case["toks32"],
                                fault=True)
        err = _rows_dist(bad, case["ref16"])
    else:
        _, bad = _port_grads(case["c16"], case["tp16"], case["batch"],
                             fault=True)
        err = _grad_dist(bad, case["grads"]["bf16"][1])
    assert err > 4 * case["bar"][what], (what, err, case["bar"])


def test_caches_bf16_and_rows_float32(case):
    """``init_cache`` and ``prefill`` keep the self and cross caches in
    bf16 (as the reference's ``init_cache``); the loop's rows are float32
    on the host, its tokens int32."""
    c16, tp16 = case["c16"], case["tp16"]
    model = get_model(c16)
    empty = model.init_cache(B, MAX_LEN, device="cpu")
    _, cache = model.prefill(tp16, torch.as_tensor(case["prompts"]),
                             frames=case["ft16"], max_len=MAX_LEN)
    for c in (empty, cache):
        assert {p: x.dtype for p, x in c.items() if p != "step"} == {
            f"subs/sub0/{n}": BF16 for n in ("k", "v", "xk", "xv")}
    assert cache["subs/sub0/xk"].shape[2] == c16.enc_seq
    assert case["greedy16"].dtype == np.float32
    assert case["toks"].dtype == np.int32


@pytest.mark.parametrize("package", ["reference", "port"])
def test_bf16_params_refuse_fp32_frames(case, package):
    """A parity limit, pinned: on bf16 params both packages refuse fp32
    frames, and neither casts them (the launchers draw fp32 frames, so a
    bf16 whisper takes its frames in bf16 from the caller)."""
    frames = case["frames32"][:1]
    prompts = case["prompts"][:1]
    if package == "reference":
        with pytest.raises(TypeError):
            r_engine.static_generate(
                case["r16"], case["rp16"], jnp.asarray(prompts), 2,
                max_len=MAX_LEN, extra={"frames": jnp.asarray(frames)})
    else:
        with pytest.raises(RuntimeError, match="same dtype"):
            static_generate(case["c16"], case["tp16"], prompts, 2,
                            max_len=MAX_LEN, device="cpu",
                            extra={"frames": frames})


def _frames_data(cfg, n=6):
    rng = np.random.default_rng(4)
    data = dict(lm_batch(n, 16, cfg.vocab, key=4))
    data["frames"] = rng.normal(size=(n, cfg.enc_seq, cfg.d_model)).astype(
        ml_dtypes.bfloat16)
    shards = iid_partition(n, 2, key=1)
    return data, shards


def test_loader_draws_bf16_frames_as_the_reference(case):
    """bf16 frames as a tensor in the port's loader: the same rows, bit
    for bit, as the reference's loader over the same frames held by
    numpy as ``ml_dtypes.bfloat16``; the tokens as numpy, as before."""
    data, shards = _frames_data(case["c16"])
    ref = r_partition.FederatedLoader(
        [{k: v[s] for k, v in data.items()} for s in shards], batch_size=1,
        steps_per_round=2, key=0)
    port = FederatedLoader(
        [{k: (_torch16(v[s]) if k == "frames" else v[s])
          for k, v in data.items()} for s in shards], batch_size=1,
        steps_per_round=2, key=0)
    for rnd in (0, 3):
        want, got = ref.round_batches(rnd), port.round_batches(rnd)
        assert got["frames"].dtype == BF16
        assert np.array_equal(got["frames"].view(torch.int16).numpy(),
                              want["frames"].view(np.int16))
        for k in ("tokens", "labels"):
            assert isinstance(got[k], np.ndarray)
            assert np.array_equal(got[k], want[k])


def test_bf16_round_takes_bf16_frames(case):
    """One hub round of reduced whisper in bf16 from ``from_config``, its
    clients' frames bf16 tensors: the loss finite, every param bf16
    after the round, the trained units moved."""
    cfg = case["c16"]
    data, shards = _frames_data(cfg)
    loader = FederatedLoader(
        [{k: (_torch16(v[s]) if k == "frames" else v[s])
          for k, v in data.items()} for s in shards], batch_size=1,
        steps_per_round=1, key=0)
    fed = Federation.from_config(
        cfg, FLConfig(n_clients=2, train_fraction=0.5, lr=2e-3),
        data=loader, device="cpu",
        loss_kwargs=steps.default_loss_kwargs(cfg))
    before = {p: x.clone() for p, x in fed.params.items()}
    rec = fed.fit(1)[0]
    assert np.isfinite(rec.loss)
    assert {x.dtype for x in fed.params.values()} == {BF16}
    assert any(not torch.equal(x, before[p]) for p, x in fed.params.items())


@pytest.mark.parametrize("s,want", [(200, (2, 128)), (1500, (5, 320))],
                         ids=["self", "cross"])
def test_k4_split_plan_at_whisper_caches_in_bf16(s, want):
    """K4's split plan at whisper's decode step in bf16 (8 sequences, 16
    KV heads of 64, ``blk_k`` the cache's length: one page of ``s``
    tokens a sequence) on an H100's 132 SMs: a ring stage of 64 tokens
    at 2 bytes an element (32 at 4), whole stages a split, at least
    ``MIN_TILES`` of them, the splits covering the cache, none past
    ``SPLIT_BYTES`` of K and V."""
    from repro_torch.kernels.flash_decode import ops as fops
    hd, elem = 64, 2
    tile = fops._tile_tokens(hd, elem)
    assert (tile, fops._tile_tokens(hd, 4)) == (64, 32)
    n_splits, span = fops._plan_splits(8, 16, 1, s, 132, tile, hd * elem)
    assert (n_splits, span) == want
    assert span % tile == 0 and span >= fops.MIN_TILES * tile
    assert n_splits * span >= s > (n_splits - 1) * span
    assert 2 * span * hd * elem <= fops.SPLIT_BYTES
