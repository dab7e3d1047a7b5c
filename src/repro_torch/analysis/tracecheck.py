"""Level-1 contract checks at the dispatch level.

The port of ``repro.analysis.tracecheck``.  The reference traces every
compiled path with ``jax.make_jaxpr`` and walks the jaxprs; the port has
no jaxpr, so it runs every registered path once at toy size, on the
device the caller names, under a ``TorchDispatchMode`` recorder
(:class:`Recorder`) that sees every aten op the path dispatches, and
checks the recording.  The recorder keeps, for each op, its name,
whether it read device data (the program's device arguments and every
tensor computed from them, or any CUDA tensor), whether it moved data
from the card to the host, and for a random op the generator it drew
from and a hash of that generator's state before the draw.

Registered paths (``traced_programs(device)``):

* sync packed round step, dense hub round step (the fused aggregate,
  K1 on the card), the qint8 packed round step (K2 on the card);
* buffered-async select, cohort and flush;
* cohort-engine select, acc_init, chunk and finalize;
* serve prefill and decode of reduced qwen3-1.7b (head dim 32, GQA
  group 2: K3 on the card; on CUDA the decode also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, which sees a device wait
  the recorder cannot).

Checkers (each also a pure ``check_*`` function, which is how the bad
fixtures of ``tests/test_torch_analysis.py`` prove every checker fires):

* ``trace-host-sync`` — no ``_local_scalar_dense`` / ``item`` /
  ``is_nonzero``, card-to-host copy or data-dependent-shape op
  (``nonzero``, ``masked_select``, ``unique*``, boolean indexing) on
  device data inside a program, except the program's ``host_allow``;
* ``trace-key-flow`` — every random op carries an explicit generator
  (never the process-wide default one), and no generator state is drawn
  from twice in a program (the torch form of "key reused" and
  "underived seed");
* ``trace-frozen-grad`` — frozen params receive no gradient: on the
  dense path the masked gradient the optimizer consumes is exact zeros
  on every frozen (client, unit); on the packed path no gradient
  reaches the global base at a frozen row at all (the detached base of
  ``core/client.local_update_packed``);
* ``trace-donation`` — every ``donate_argnums`` leaf of a guard is
  updated in place: the output holds the same storage and no op copies
  it whole;
* ``trace-compileguard`` — the live entry points are ``CompileGuard``s
  with the contracted budgets (``GUARD_CONTRACT``);
* ``trace-codec-frozen`` — every registered codec's decode(encode(.))
  of an all-ones payload is exact zeros outside the valid mask.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .compileguard import CompileGuard
from .findings import Finding, register_checker

__all__ = ["traced_programs", "TracedProgram", "Recorder", "record",
           "check_host_sync", "check_key_flow", "check_frozen_grad_dense",
           "check_frozen_grad_packed", "check_donation",
           "check_guard_contract", "check_codec_pad_zeros",
           "GUARD_CONTRACT"]

# ops that wait for the card (a scalar read back, a data-dependent output
# shape); aten.item / is_nonzero decompose to _local_scalar_dense
HOST_SYNC_OPS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
                 "nonzero_static", "masked_select", "unique", "_unique",
                 "_unique2", "unique_consecutive", "unique_dim", "equal",
                 "repeat_interleave"}
RANDOM_OPS = {"rand", "randn", "randint", "randperm", "normal",
              "bernoulli", "multinomial", "uniform", "exponential",
              "random", "cauchy", "log_normal", "geometric", "poisson",
              "rand_like", "randn_like", "randint_like", "native_dropout"}
COPY_OPS = {"clone", "_to_copy", "copy"}

# the live entry points' contract: guard name -> (max_programs,
# donate_argnums).  The port's round step, flush and finalize return new
# params (they donate nothing); the cohort chunk folds into its carry.
GUARD_CONTRACT = {
    "round_step": (1, ()), "async_flush": (1, ()),
    "async_select": (1, ()), "async_cohort": (2, ()),
    "cohort_select": (1, ()), "cohort_acc_init": (1, ()),
    "cohort_chunk": (1, (1,)), "cohort_finalize": (1, ()),
    "serve_prefill": (None, ()), "serve_commit": (None, ()),
    "serve_decode": (1, ()),
}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# ---------------------------------------------------------------------------
# the recorder

@dataclasses.dataclass
class OpEvent:
    name: str                 # aten overload packet, e.g. "nonzero"
    on_device: bool           # read device data
    to_host: bool             # a CUDA input, a CPU output
    generator: Optional[str]  # None: no generator; else a state hash
    bool_index: bool = False  # boolean-mask indexing (data-dependent)
    copies: Tuple[int, ...] = ()   # donated storages copied whole


class Recorder(TorchDispatchMode):
    """Record every aten op dispatched while the mode is on.

    ``device_tensors`` are the program's device arguments: on the CPU
    they stand for what lies on the card, so ops reading them (or
    anything computed from them) count as device work.  Any CUDA tensor
    is device data too.  ``donated`` are tensors whose storages must not
    be copied whole."""

    def __init__(self, device_tensors=(), donated=()):
        super().__init__()
        self.events: List[OpEvent] = []
        self._dev = set()
        self._donated = {_sid(t): t.numel() for t in donated}
        for t in device_tensors:
            self._mark(t)

    def _mark(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        sid = st._cdata
        if sid not in self._dev:
            self._dev.add(sid)
            weakref.finalize(st, self._dev.discard, sid)

    def _is_dev(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" or _sid(t) in self._dev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        on_dev = any(self._is_dev(t) for t in ins)
        gen = next((x for x in tree_leaves((args, kwargs))
                    if isinstance(x, torch.Generator)), None)
        state = None
        if name.rstrip("_") in RANDOM_OPS:
            state = "" if gen is None else hashlib.sha1(
                gen.get_state().numpy().tobytes()).hexdigest()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            if on_dev or t.device.type == "cuda":
                self._mark(t)
        copies = ()
        if name in COPY_OPS and self._donated:
            copies = tuple(_sid(t) for t in ins
                           if _sid(t) in self._donated
                           and any(o.numel() == self._donated[_sid(t)]
                                   and _sid(o) != _sid(t) for o in outs))
        bool_index = name == "index" and any(
            t.dtype in (torch.bool, torch.uint8) for t in ins[1:])
        self.events.append(OpEvent(
            name=name, on_device=on_dev,
            to_host=any(t.device.type == "cuda" for t in ins)
            and any(t.device.type == "cpu" for t in outs),
            generator=state, bool_index=bool_index, copies=copies))
        return out


def record(fn: Callable, *args, device_tensors=(), donated=(), **kwargs):
    """``(out, events)`` of one call of ``fn`` under a :class:`Recorder`."""
    rec = Recorder(device_tensors, donated)
    with rec:
        out = fn(*args, **kwargs)
    return out, rec.events


# ---------------------------------------------------------------------------
# checker cores (pure functions over recordings and callables)

def check_host_sync(name: str, events: Sequence[OpEvent],
                    allow: Sequence[str] = ()) -> List[Finding]:
    out, seen = [], set()
    for e in events:
        if not e.on_device:
            continue
        sym = None
        if e.name in HOST_SYNC_OPS:
            sym = e.name
        elif e.bool_index:
            sym = "index(bool mask)"
        elif e.to_host:
            sym = f"{e.name}(device->host)"
        if sym is None or sym in allow or sym in seen:
            continue
        seen.add(sym)
        out.append(Finding(
            checker="", level="", anchor=name, symbol=sym,
            message=f"host sync {sym!r} on device data inside program "
                    f"{name!r} — the host waits for the card every call "
                    f"(and a CUDA graph cannot capture it); keep the "
                    f"value on the device or allowlist it in host_allow"))
    return out


def check_key_flow(name: str, events: Sequence[OpEvent]) -> List[Finding]:
    out, states = [], set()
    for e in events:
        if e.generator is None:
            continue
        if e.generator == "":
            out.append(Finding(
                checker="", level="", anchor=name,
                symbol=f"default-generator:{e.name}",
                message=f"random op {e.name!r} in {name!r} draws from the "
                        f"process-wide default generator — every draw "
                        f"must come from a seeded torch.Generator passed "
                        f"as generator="))
            continue
        if e.generator in states:
            out.append(Finding(
                checker="", level="", anchor=name, symbol="state-reuse",
                message=f"random op {e.name!r} in {name!r} draws from a "
                        f"generator state already drawn from — the same "
                        f"stream twice; advance or reseed per draw site"))
        states.add(e.generator)
    return out


def _frozen_rows(assign, params, sel_row) -> Dict[str, torch.Tensor]:
    """Per stacked leaf: bool (rows,) of the rows ``sel_row`` freezes."""
    from ..core.masking import leaf_unit_ids
    out = {}
    for p, x in params.items():
        lu = assign.leaf_units[p]
        if lu.kind == "stacked":
            ids = torch.as_tensor(leaf_unit_ids(lu, x.shape))
            out[p] = sel_row[ids] == 0
    return out


def check_frozen_grad_dense(name: str, update_fn: Callable, fixture
                            ) -> List[Finding]:
    """Run ``update_fn`` (``core.client.local_update`` or a copy) for one
    client and read the masked gradients it hands the optimizer through
    its norm hook: every frozen unit's must be exact zeros."""
    from ..core.masking import NormHook, mask_tree
    loss_fn, params, assign, sel_row, batches, kw, _ = fixture
    seen: List[Dict[str, torch.Tensor]] = []

    def probe(grads):
        seen.append({p: g.detach().clone() for p, g in grads.items()})
        return torch.zeros((assign.n_units,), device=next(
            iter(grads.values())).device)

    mask = mask_tree(assign, sel_row, params)
    update_fn(loss_fn, params, mask, batches, lr=0.1,
              loss_kwargs=kw, norm_hook=NormHook(assign.n_units, probe))
    frozen = _frozen_rows(assign, params, sel_row)
    out = []
    for p in params:
        lu = assign.leaf_units[p]
        for grads in seen:
            g = grads.get(p)
            if g is None:
                continue
            leak = g.float().abs()
            if lu.kind == "stacked":
                leak = leak[frozen[p].to(g.device)]
            elif sel_row[lu.base] != 0:
                continue
            if leak.numel() and float(leak.max()) != 0.0:
                out.append(Finding(
                    checker="", level="", anchor=name, symbol=p,
                    message=f"leaf {p!r}: the masked gradient of {name!r} "
                            f"is not zero on frozen units — frozen params "
                            f"would move (is the mask applied to the "
                            f"gradients?)"))
                break
    return out


def check_frozen_grad_packed(name: str, update_fn: Callable, fixture
                             ) -> List[Finding]:
    """Run ``update_fn`` (``core.client.local_update_packed`` or a copy)
    for one client with the global params requiring grad, and inside
    the loss take the gradient of each stacked global leaf: it must be
    None (no path from the loss to the base) or exact zeros on every
    frozen row."""
    from ..core.masking import cohort_slot_plans
    loss_fn, params, assign, sel_row, batches, kw, n_slots = fixture
    gp = {p: x.detach().clone().requires_grad_(True)
          for p, x in params.items()}
    stacked = [p for p in gp if assign.leaf_units[p].kind == "stacked"]
    seen: List[Dict[str, Optional[torch.Tensor]]] = []

    def probe_loss(prm, batch, **lkw):
        loss, aux = loss_fn(prm, batch, **lkw)
        grads = torch.autograd.grad(loss, [gp[p] for p in stacked],
                                    retain_graph=True, allow_unused=True)
        seen.append(dict(zip(stacked, grads)))
        return loss, aux

    rows, valid = cohort_slot_plans(assign, sel_row[None], n_slots, params)
    update_fn(probe_loss, gp, assign, {p: r[0] for p, r in rows.items()},
              {p: v[0] for p, v in valid.items()}, batches, lr=0.1,
              loss_kwargs=kw)
    frozen = _frozen_rows(assign, params, sel_row)
    out = []
    for p in stacked:
        for grads in seen:
            g = grads[p]
            if g is None:
                continue
            leak = g[frozen[p].to(g.device)].abs()
            if leak.numel() and float(leak.max()) != 0.0:
                out.append(Finding(
                    checker="", level="", anchor=name, symbol=p,
                    message=f"stacked leaf {p!r}: gradient reaches the "
                            f"global base at frozen rows in {name!r} — "
                            f"is the base of the slot merge detached?"))
                break
    return out


def check_donation(name: str, donated: Dict[str, torch.Tensor], out,
                   events: Sequence[OpEvent]) -> List[Finding]:
    """``donated`` (path -> the leaf passed in) must come back in ``out``
    in the same storage, and no recorded op may copy one whole."""
    back = {_sid(t) for t in _tensors(out)}
    copied = {s for e in events for s in e.copies}
    res = []
    for p, t in donated.items():
        if _sid(t) not in back or _sid(t) in copied:
            what = "copied whole" if _sid(t) in copied else \
                "not returned in its own storage"
            res.append(Finding(
                checker="", level="", anchor=name, symbol=p,
                message=f"{name!r} declares leaf {p!r} donated but it was "
                        f"{what} — the step allocates a second "
                        f"model-sized buffer instead of writing in place"))
    return res


def check_guard_contract(name: str, guard: Any,
                         max_programs: Optional[int],
                         donate: Tuple[int, ...]) -> List[Finding]:
    if not isinstance(guard, CompileGuard):
        return [Finding(
            checker="", level="", anchor=name, symbol="compileguard",
            message=f"{name!r} is not routed through CompileGuard "
                    f"(got {type(guard).__name__}) — the signature budget "
                    f"is unenforced")]
    out = []
    if guard.max_programs != max_programs:
        out.append(Finding(
            checker="", level="", anchor=name, symbol="max-programs",
            message=f"{name!r} declares max_programs="
                    f"{guard.max_programs}, contract says "
                    f"{max_programs}"))
    if guard.donate_argnums != donate:
        out.append(Finding(
            checker="", level="", anchor=name, symbol="donate-argnums",
            message=f"{name!r} declares donate_argnums="
                    f"{guard.donate_argnums}, contract says {donate}"))
    return out


def check_codec_pad_zeros(name: str, transform, assign, params, fl,
                          n_slots: int) -> List[Finding]:
    """Frozen-slot invariant THROUGH the codec: an all-ones packed
    payload (pad slots and a non-participant client included) through
    decode(encode(.)) must be exact zeros wherever the slot plan says
    nothing shipped."""
    from ..core.masking import cohort_slot_plans
    c = fl.n_clients
    dev = next(iter(params.values())).device
    sel = torch.zeros((c, assign.n_units))
    sel[:, : max(1, assign.n_units // 2)] = 1.0
    sel[-1, :] = 0.0                      # a non-participant client
    rows, valid = cohort_slot_plans(assign, sel, n_slots, params)
    pdeltas = {}
    for p, x in params.items():
        if assign.leaf_units[p].kind == "scalar":
            pdeltas[p] = torch.ones((c,) + tuple(x.shape), device=dev)
        else:
            pdeltas[p] = torch.ones((c, rows[p].shape[1]) +
                                    tuple(x.shape[1:]), device=dev)
    rows = {p: r.to(dev) for p, r in rows.items()}
    valid = {p: v.to(dev) for p, v in valid.items()}
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(i, shape):
        return torch.rand(shape, generator=gen, device=dev)

    decoded, _ = transform(pdeltas, rows, valid, torch.ones(c), uniform)
    out = []
    for p, d in decoded.items():
        v = valid[p].float()
        vm = v.reshape(tuple(v.shape) + (1,) * (d.ndim - v.ndim))
        leak = float((d.float().abs() * (1.0 - vm)).max()) if d.numel() \
            else 0.0
        if leak != 0.0:
            out.append(Finding(
                checker="", level="", anchor=name, symbol=p,
                message=f"codec {name!r}: decoded delta leaks {leak:g} "
                        f"into pad/non-participant slots of leaf {p!r} — "
                        f"decode(encode(.)) must multiply by the valid "
                        f"mask so frozen units stay EXACTLY untouched"))
    return out


# ---------------------------------------------------------------------------
# the program registry

@dataclasses.dataclass
class TracedProgram:
    name: str                            # finding anchor "trace:..."
    events: List[OpEvent]
    host_allow: Tuple[str, ...] = ()
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # donation: path -> donated leaf, and the call's output
    donated: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    out: Any = None


@dataclasses.dataclass
class Registry:
    device: torch.device
    programs: List[TracedProgram]
    # (probe name, kind "dense" | "packed", fixture)
    grad_probes: List[Tuple[str, str, Any]]
    # live guards: (program name, guard)
    guards: List[Tuple[str, Any]]
    # device findings from outside the recorder (CUDA sync debug mode)
    sync_errors: List[Finding]


def _launch_counts() -> Dict[str, int]:
    from ..kernels.codec import ops as qops
    from ..kernels.flash_decode import ops as dops
    from ..kernels.masked_agg import ops as kops
    return {"K1": kops.masked_agg.launches,
            "K2": qops.quantize_pack_group.launches,
            "K3": dops.paged_decode_attention.launches}


def _run(programs: List[TracedProgram], name: str, fn, *args,
         device_tensors=(), donate: Sequence[int] = (), host_allow=(),
         **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a recorder and register it
    as program ``name``; returns the output."""
    donated = {}
    for i in donate:
        donated.update({f"args[{i}][{p!r}]": t
                        for p, t in args[i].items()})
    before = _launch_counts()
    out, events = record(fn, *args, device_tensors=device_tensors,
                         donated=list(donated.values()), **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = _launch_counts()
    programs.append(TracedProgram(
        name, events, tuple(host_allow),
        {k: after[k] - before[k] for k in after}, donated, out))
    return out


def _toy_fixture(fl, dev, seed=0):
    """Toy params, units and (C, 2, 2, ...) batches on ``dev``."""
    from ..models.toy import init_toy_mlp, toy_batches, toy_units
    gen = torch.Generator().manual_seed(seed)
    params = {p: x.to(dev) for p, x in
              init_toy_mlp(gen, n_blocks=4, d=8, hidden=12, out=4).items()}
    assign = toy_units(params)
    batches = {k: v.to(dev) for k, v in toy_batches(
        gen, n_clients=fl.n_clients, steps=2, batch=2, d=8,
        out=4).items()}
    return params, assign, batches, fl.resolve_n_slots(assign.n_units)


def _probe_fixture(dev):
    """(loss_fn, params, assign, sel_row, batches, loss_kwargs, n_slots)
    of one client training half of the toy units."""
    from ..core.federation import FLConfig
    from ..models.toy import toy_loss
    fl = FLConfig(n_clients=1, train_fraction=0.5)
    params, assign, batches, n_slots = _toy_fixture(fl, dev)
    sel = torch.zeros((assign.n_units,))
    sel[1:assign.n_units // 2 + 1] = 1.0      # blocks 0..2; inp frozen
    return (toy_loss, params, assign, sel,
            {k: v[0] for k, v in batches.items()}, {"device": dev}, n_slots)


@functools.lru_cache(maxsize=2)
def traced_programs(device: str = "cuda") -> Registry:
    """Build and run every registered path once on ``device`` (cached per
    device).  ``"cuda"`` needs a card: there is no fallback."""
    from ..common import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    from ..core.async_agg import BufferedAggregator, build_cohort_step
    from ..core.cohort import build_cohort_programs
    from ..core.federation import FLConfig, build_round_step
    from ..core.server import Server
    from ..core.topology import resolve_topology
    from ..models.toy import toy_loss

    programs: List[TracedProgram] = []
    guards: List[Tuple[str, Any]] = []
    kw = {"device": dev}
    weights = torch.ones((3,))

    # -- sync round steps: packed, dense (K1), packed qint8 (K2) -----------
    for tag, extra in (("round_step", {"packed": True, "fused_agg": "off"}),
                       ("round_step_dense", {"fused_agg": "on"}),
                       ("round_step_qint8", {"packed": True,
                                             "fused_agg": "off",
                                             "codec": "qint8"})):
        fl = FLConfig(n_clients=3, train_fraction=0.5, **extra)
        params, assign, batches, _ = _toy_fixture(fl, dev)
        srv = Server(build_round_step(toy_loss, assign, fl, kw, device=dev),
                     assign, fl, params, device=dev)
        step_kw = {"uniform": srv.codec_uniform} if srv.codec.stochastic \
            else {}
        _run(programs, f"trace:sync/{tag}", srv.round_step, srv.params,
             batches, weights, srv.generator,
             device_tensors=_tensors((srv.params, batches)), **step_kw)
        guards.append((f"trace:sync/{tag}", srv.round_step))

    # -- buffered-async select + cohort + flush ----------------------------
    fl_a = FLConfig(n_clients=3, train_fraction=0.5, packed=True,
                    fused_agg="off", async_buffer=2)
    params, assign, batches, _ = _toy_fixture(fl_a, dev)
    select_fn, cohort_fn, _ = build_cohort_step(toy_loss, assign, fl_a, kw)
    gen = torch.Generator().manual_seed(0)
    sel = _run(programs, "trace:async/select", select_fn, gen)
    two = {k: v[:2] for k, v in batches.items()}
    pdeltas, rows, valid, _ = _run(
        programs, "trace:async/cohort", cohort_fn, params, sel[:2], two,
        device_tensors=_tensors((params, two)))
    flush = resolve_topology("hub").build_buffered_flush(assign, fl_a)
    agg = BufferedAggregator(fl_a.async_buffer, fl_a.staleness,
                             fl_a.staleness_alpha, flush)
    _run(programs, "trace:async/flush", agg._flush, params, pdeltas, rows,
         valid, sel[:2], torch.ones((2,)), np.arange(2, dtype=np.int32),
         device_tensors=_tensors((params, pdeltas, rows, valid)))
    guards += [("trace:async/select", select_fn),
               ("trace:async/cohort", cohort_fn),
               ("trace:async/flush", agg._flush)]

    # -- cohort engine: select / acc_init / chunk / finalize ----------------
    fl_c = FLConfig(n_clients=4, n_registered=8, cohort_chunk=2,
                    train_fraction=0.5, packed=True, fused_agg="off")
    params, assign, batches, _ = _toy_fixture(fl_c, dev)
    prog = build_cohort_programs(toy_loss, assign, fl_c, kw)
    sel = _run(programs, "trace:cohort/select", prog.select,
               torch.Generator().manual_seed(1))
    acc = _run(programs, "trace:cohort/acc_init", prog.acc_init, params,
               device_tensors=_tensors(params))
    w = torch.ones((fl_c.n_clients,))
    two = {k: v[:2] for k, v in batches.items()}
    acc, mets = _run(programs, "trace:cohort/chunk", prog.chunk, params,
                     acc, sel[:2], w[:2], np.arange(2), two,
                     device_tensors=_tensors((params, acc, two)),
                     donate=(1,))
    _run(programs, "trace:cohort/finalize", prog.finalize, params, acc,
         sel, w, torch.cat([mets["loss"], mets["loss"]]),
         device_tensors=_tensors((params, acc)))
    guards += [(f"trace:cohort/{n}", getattr(prog, n))
               for n in ("select", "acc_init", "chunk", "finalize")]

    # -- serve prefill + decode (reduced qwen3-1.7b: K3 at head dim 32,
    # GQA group 2), sampled at temperature > 0 so the draws are traced --
    from ..configs.base import get_config
    from ..models import get_model
    from ..serve.engine import DecodeEngine, ServeConfig
    cfg = get_config("qwen3-1.7b").reduced()
    mparams = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    eng = DecodeEngine(cfg, mparams, ServeConfig(
        n_slots=2, max_len=32, page_size=16, temperature=0.7), device=dev)
    prompts = np.arange(16, dtype=np.int32).reshape(2, 8) % cfg.vocab
    for row in prompts:
        eng.submit(row, max_gen=4)
    eng._admit_all()
    toks = torch.as_tensor(prompts, device=dev)
    rids = np.arange(2, dtype=np.int32)
    _run(programs, "trace:serve/prefill", eng._prefill, toks, rids,
         np.zeros((2,), np.int32), device_tensors=[toks])
    tokens, steps, rids, gidx = eng.scheduler.step_arrays()
    tables = eng._device_tables()
    dec_args = (torch.as_tensor(tokens[:, None], device=dev),
                torch.as_tensor(steps, device=dev), tables, rids, gidx)
    dev_t = _tensors((dec_args, eng.paged, eng.params))
    _run(programs, "trace:serve/decode", eng._decode, *dec_args,
         device_tensors=dev_t)
    sync_errors: List[Finding] = []
    if dev.type == "cuda":
        # a device wait the recorder cannot see (a D2H copy inside a
        # kernel wrapper) raises under the sync debug mode
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._decode(*dec_args[:1], dec_args[1] + 1, *dec_args[2:])
        except RuntimeError as e:
            # the innermost frame of this package names the sync's site
            site = [f"{Path(f.filename).name}:{f.lineno} ({f.name})"
                    for f in traceback.extract_tb(e.__traceback__)
                    if "repro_torch" in f.filename][-1:]
            sync_errors.append(Finding(
                checker="", level="", anchor="trace:serve/decode",
                symbol="cuda-sync",
                message=f"the decode program synchronized with the host "
                        f"under torch.cuda.set_sync_debug_mode('error') "
                        f"at {', '.join(site)}: {e}"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    guards += [("trace:serve/prefill", eng._prefill),
               ("trace:serve/commit", eng._commit),
               ("trace:serve/decode", eng._decode)]

    probe = _probe_fixture(dev)
    probes = [("trace:sync/frozen_grad_dense", "dense", probe),
              ("trace:sync/frozen_grad", "packed", probe)]
    return Registry(dev, programs, probes, guards, sync_errors)


def _registry(root: Path) -> Registry:
    return traced_programs(_TRACE_DEVICE["device"])


# the CLI's --device (the trace level runs on the card unless it says cpu)
_TRACE_DEVICE = {"device": "cuda"}


def set_trace_device(device: str) -> None:
    _TRACE_DEVICE["device"] = device


# ---------------------------------------------------------------------------
# registry wiring

@register_checker("trace-host-sync", "trace")
def _host_sync_checker(root: Path) -> List[Finding]:
    reg = _registry(root)
    return [f for p in reg.programs
            for f in check_host_sync(p.name, p.events, p.host_allow)] + \
        list(reg.sync_errors)


@register_checker("trace-key-flow", "trace")
def _key_flow_checker(root: Path) -> List[Finding]:
    reg = _registry(root)
    return [f for p in reg.programs for f in check_key_flow(p.name,
                                                            p.events)]


@register_checker("trace-frozen-grad", "trace")
def _frozen_grad_checker(root: Path) -> List[Finding]:
    from ..core.client import local_update, local_update_packed
    reg = _registry(root)
    out = []
    for name, kind, fixture in reg.grad_probes:
        if kind == "dense":
            out += check_frozen_grad_dense(name, local_update, fixture)
        else:
            out += check_frozen_grad_packed(name, local_update_packed,
                                            fixture)
    return out


@register_checker("trace-donation", "trace")
def _donation_checker(root: Path) -> List[Finding]:
    reg = _registry(root)
    return [f for p in reg.programs if p.donated
            for f in check_donation(p.name, p.donated, p.out, p.events)]


@register_checker("trace-compileguard", "trace")
def _guard_checker(root: Path) -> List[Finding]:
    reg = _registry(root)
    out = []
    for name, guard in reg.guards:
        gname = getattr(guard, "name", None)
        if gname not in GUARD_CONTRACT:
            out += check_guard_contract(name, guard, 1, ())
            continue
        out += check_guard_contract(name, guard, *GUARD_CONTRACT[gname])
    return out


@register_checker("trace-codec-frozen", "trace")
def _codec_frozen_checker(root: Path) -> List[Finding]:
    """Every registered non-identity codec's transform, on the toy
    fixture (``none`` builds no transform — nothing to leak)."""
    from ..core import codecs as _codecs
    from ..core.federation import FLConfig
    dev = _registry(root).device
    out: List[Finding] = []
    for cname in _codecs.available_codecs():
        if cname == "none":
            continue
        fl = FLConfig(n_clients=3, train_fraction=0.5, packed=True,
                      fused_agg="off", codec=cname)
        params, assign, _, n_slots = _toy_fixture(fl, dev)
        transform = _codecs.build_codec_transform(
            _codecs.get_codec(cname), assign, fl)
        out.extend(check_codec_pad_zeros(
            f"trace:codec/{cname}", transform, assign, params, fl,
            n_slots))
    return out
