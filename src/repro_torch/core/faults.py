"""Seeded fault injection — the chaos axis (DESIGN.md §14), PyTorch port.

Everything upstream of this module assumes benign failures: the
``DelayScheduler`` only reorders updates and ``StragglerDropout`` only
drops them cleanly.  Real edge fleets crash mid-round, ship corrupted
deltas, deliver duplicates and torn payloads, and lose the *server*
between checkpoint and flush.  This module makes every one of those an
injectable, deterministic event:

* a fault registry (``@register_fault``), symmetric with the strategy /
  topology / staleness / client-sampler registries, keyed by name with
  the shared unknown-name error contract;
* a :class:`FaultInjector` whose every draw is a pure function of
  ``(seed, tag, coordinates)`` — numpy ``SeedSequence`` draws, the
  reference's own, so a fault schedule is array-equal to the
  reference's and never touches the server's generators;
* :func:`chaos_inject`, the corruption transform applied to packed
  deltas inside the round step (mode 0 selects the original value
  through ``torch.where``, a bitwise identity, so a zero-rate chaos
  config stays bitwise-equal to the plain round);
* :class:`ChaosHook` + :func:`run_with_restarts`, the crash-restart
  harness: a seeded kill between ``on_round_end`` hooks plus an
  auto-resume loop proving kill-at-any-boundary + restore reproduces
  the uninterrupted fit bit-exactly.

Fault seams
-----------
``crash``     client crash mid-cohort-chunk — the update never arrives
              (sync: weight zeroed before the step; cohort: the client
              is resampled with bounded backoff; async: the in-flight
              update is discarded and the client re-dispatched).
``delta``     delta corruption on the wire: ``nan``, ``inf``,
              ``bitflip`` (exponent-bit flip), ``scale`` (magnitude
              blow-up, param = factor).
``delivery``  ``duplicate`` (same update pushed twice into the
              ``BufferedAggregator``) and ``torn`` (NaN tail — a
              partially-received payload).
``server``    ``kill`` — raises :class:`ServerKilled` between
              ``on_round_end`` hooks (after the ``Checkpointer``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, FrozenSet, Iterable, Optional, Sequence, Tuple, \
    Type, Union

import numpy as np
import torch

from .registry import unknown_name_message

# draw-domain tags: every stochastic decision hashes (seed, tag, coords)
# into its own numpy generator, so adding a new fault kind never shifts
# the draws of an existing one (same contract as DelayScheduler)
_TAG_CRASH = 0xFA001      # sync/cohort crash, coords (round, client)
_TAG_DELTA = 0xFA002      # sync/cohort corruption, coords (round, client)
_TAG_ADELTA = 0xFA003     # async corruption, coords (client, seq)
_TAG_DUP = 0xFA004        # duplicate delivery, coords (client, seq)
_TAG_TORN = 0xFA005       # torn delivery, coords (client, seq)
_TAG_KILL = 0xFA006       # server kill, coords (incarnation, round)
_TAG_RESAMPLE = 0xFA007   # crash resampling, coords (round, pos, attempt)
_TAG_ACRASH = 0xFA008     # async crash, coords (client, seq)

# delta corruption modes (the int32 plan fed to chaos_inject)
MODE_NONE, MODE_NAN, MODE_INF, MODE_BITFLIP, MODE_SCALE = 0, 1, 2, 3, 4


class ServerKilled(RuntimeError):
    """Injected server death (the ``kill`` fault).  Raised between
    ``on_round_end`` hooks; :func:`run_with_restarts` catches it and
    resumes from the last checkpoint."""


class ClientCrashed(RuntimeError):
    """A (re)sampled client crashed; retried via ``common/retry.py``."""


class Fault:
    """One registered fault kind.  Instances carry the per-run
    probability (and optional parameter); the class carries identity:
    ``name``, ``seam`` (crash | delta | delivery | server) and, for
    delta faults, the corruption ``mode`` code."""

    name: str = ""
    seam: str = ""
    mode: int = MODE_NONE
    default_param: float = 1.0

    def __init__(self, prob: float = 0.0, param: Optional[float] = None):
        prob = float(prob)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"fault {self.name!r} probability must be in [0, 1], "
                f"got {prob}")
        self.prob = prob
        self.param = float(self.default_param if param is None else param)

    def __repr__(self):
        return f"{type(self).__name__}(prob={self.prob}, param={self.param})"


_FAULTS: Dict[str, Type[Fault]] = {}


class UnknownFaultError(ValueError):
    pass


def register_fault(cls: Type[Fault]):
    """Class decorator: register a fault kind by its ``name``."""
    if not cls.name:
        raise ValueError(f"fault class {cls!r} has no name")
    _FAULTS[cls.name] = cls
    return cls


def unregister_fault(name: str):
    _FAULTS.pop(name, None)


def registered_faults() -> Tuple[str, ...]:
    return tuple(sorted(_FAULTS))


def get_fault(name: str) -> Type[Fault]:
    try:
        return _FAULTS[name]
    except KeyError:
        raise UnknownFaultError(
            unknown_name_message("fault", name, _FAULTS)) from None


@register_fault
class CrashFault(Fault):
    """Client crashes before uploading: its weight drops to zero and
    the cohort engine resamples a replacement (crash seam)."""
    name, seam = "crash", "crash"


@register_fault
class NanFault(Fault):
    """Uploaded delta poisoned with NaNs (delta seam) — the validation
    gate must quarantine it before aggregation."""
    name, seam, mode = "nan", "delta", MODE_NAN


@register_fault
class InfFault(Fault):
    """Uploaded delta poisoned with Infs (delta seam)."""
    name, seam, mode = "inf", "delta", MODE_INF


@register_fault
class BitflipFault(Fault):
    """Exponent-bit corruption of the uploaded delta (delta seam) — a
    finite-but-wrong update the norm gate has to catch."""
    name, seam, mode = "bitflip", "delta", MODE_BITFLIP


@register_fault
class ScaleFault(Fault):
    """Delta scaled by ``param`` (default 1024x, delta seam) — the
    classic exploding-update client."""
    name, seam, mode = "scale", "delta", MODE_SCALE
    default_param = 1024.0


@register_fault
class DuplicateFault(Fault):
    """Upload delivered twice (delivery seam) — the buffer's per-client
    seq watermark must reject the redelivery."""
    name, seam = "duplicate", "delivery"


@register_fault
class TornFault(Fault):
    """Upload lost in transit after leaving the client (delivery seam):
    billed bytes, no aggregate contribution."""
    name, seam = "torn", "delivery"


@register_fault
class KillFault(Fault):
    """Server process killed between rounds (server seam) — the chaos
    harness restarts from the last checkpoint."""
    name, seam = "kill", "server"


def parse_faults(spec: Union[str, Sequence[Fault], None]
                 ) -> Tuple[Fault, ...]:
    """``"crash:0.1,nan:0.05,scale:0.02:1e3"`` -> fault instances.

    Each entry is ``name:prob`` or ``name:prob:param``; already-built
    instances pass through.  A typo'd name fails with the registry's
    uniform unknown-name message."""
    if not spec:
        return ()
    if not isinstance(spec, str):
        out = tuple(spec)
        for f in out:
            if not isinstance(f, Fault):
                raise TypeError(f"expected Fault instances, got {f!r}")
        return out
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad fault spec {entry!r}: expected name:prob or "
                f"name:prob:param")
        cls = get_fault(parts[0].strip())
        try:
            prob = float(parts[1])
            param = float(parts[2]) if len(parts) == 3 else None
        except ValueError:
            raise ValueError(
                f"bad fault spec {entry!r}: prob/param must be numbers"
            ) from None
        out.append(cls(prob, param))
    return tuple(out)


def delta_faults(faults: Iterable[Fault]) -> Tuple[Fault, ...]:
    return tuple(f for f in faults if f.seam == "delta")


def delta_faults_configured(fl) -> bool:
    """True when the config names any delta fault — even at rate 0.
    The injection transform then runs in the round step (a bitwise
    identity at mode 0), so zero-rate and live chaos configs share one
    code path."""
    return bool(delta_faults(parse_faults(getattr(fl, "faults", ""))))


def gate_enabled(fl) -> bool:
    """Whether the packed-delta validation gate runs: any fault that can
    corrupt payload bytes configured (delta faults, or torn delivery —
    both even at zero rate, since the untripped gate is a bitwise
    no-op) or an explicit norm threshold."""
    faults = parse_faults(getattr(fl, "faults", ""))
    return bool(delta_faults(faults)) \
        or any(f.name == "torn" for f in faults) \
        or getattr(fl, "max_delta_norm", 0.0) > 0.0


def _rng(seed: int, tag: int, *coords: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        (int(seed), int(tag)) + tuple(int(c) for c in coords)))


class FaultInjector:
    """All fault draws for one run.  Stateless: every decision is a
    pure function of ``(seed, tag, coordinates)`` (plus ``incarnation``
    for the kill fault, so a restarted server doesn't deterministically
    re-die at the round that killed it)."""

    def __init__(self, faults: Union[str, Sequence[Fault], None],
                 seed: int = 0, incarnation: int = 0):
        self.faults = parse_faults(faults)
        self.seed = int(seed)
        self.incarnation = int(incarnation)
        self._delta = delta_faults(self.faults)

    def _prob(self, name: str) -> float:
        return min(1.0, sum(f.prob for f in self.faults
                            if f.name == name))

    @property
    def crash_prob(self) -> float:
        return self._prob("crash")

    @property
    def kill_prob(self) -> float:
        return self._prob("kill")

    @property
    def duplicate_prob(self) -> float:
        return self._prob("duplicate")

    @property
    def torn_prob(self) -> float:
        return self._prob("torn")

    @property
    def has_delta(self) -> bool:
        """Any delta fault *configured* (zero-rate counts: the plan is
        still threaded so the round step runs the same code)."""
        return bool(self._delta)

    # -- client crash ---------------------------------------------------
    def crashed(self, round_idx: int, client: int) -> bool:
        p = self.crash_prob
        return p > 0.0 and float(
            _rng(self.seed, _TAG_CRASH, round_idx, client).random()) < p

    def crash_mask(self, round_idx: int, clients: Sequence[int]
                   ) -> np.ndarray:
        return np.array([self.crashed(round_idx, int(c)) for c in clients])

    def crashed_async(self, client: int, seq: int) -> bool:
        p = self.crash_prob
        return p > 0.0 and float(
            _rng(self.seed, _TAG_ACRASH, client, seq).random()) < p

    def resample(self, round_idx: int, pos: int, attempt: int,
                 n_registered: int,
                 exclude: FrozenSet[int]) -> Optional[int]:
        """Replacement candidate for a crashed cohort slot, or None when
        the whole registered fleet is already in the cohort."""
        cands = [c for c in range(int(n_registered)) if c not in exclude]
        if not cands:
            return None
        rng = _rng(self.seed, _TAG_RESAMPLE, round_idx, pos, attempt)
        return int(cands[int(rng.integers(len(cands)))])

    # -- delta corruption -----------------------------------------------
    def _draw_modes(self, tag: int, a: int, b: int
                    ) -> Tuple[int, float]:
        rng = _rng(self.seed, tag, a, b)
        # first configured fault that fires wins (spec order); each
        # draws independently so per-fault rates are marginal rates
        for f in self._delta:
            if f.prob > 0.0 and float(rng.random()) < f.prob:
                return f.mode, f.param
        return MODE_NONE, 1.0

    def corrupt_plan(self, round_idx: int, clients: Sequence[int]
                     ) -> Dict[str, np.ndarray]:
        """The round's per-client corruption plan: ``mode`` (C,) int32
        codes (0 = clean) and ``scale`` (C,) f32 factors, fed to
        :func:`chaos_inject` inside the round step."""
        modes, scales = [], []
        for c in clients:
            m, s = self._draw_modes(_TAG_DELTA, round_idx, int(c))
            modes.append(m)
            scales.append(s)
        return {"mode": np.asarray(modes, np.int32),
                "scale": np.asarray(scales, np.float32)}

    def corrupt_async(self, client: int, seq: int) -> Tuple[int, float]:
        return self._draw_modes(_TAG_ADELTA, client, seq)

    # -- delivery -------------------------------------------------------
    def duplicated(self, client: int, seq: int) -> bool:
        p = self.duplicate_prob
        return p > 0.0 and float(
            _rng(self.seed, _TAG_DUP, client, seq).random()) < p

    def torn(self, client: int, seq: int) -> bool:
        p = self.torn_prob
        return p > 0.0 and float(
            _rng(self.seed, _TAG_TORN, client, seq).random()) < p

    def perturb_update(self, upd):
        """Apply async-path delta corruption + torn delivery to a
        ``BufferedUpdate`` (the update already sits outside the round
        step in the buffer).  Clean draws return the update object
        unchanged — a bitwise no-op."""
        mode, scale = self.corrupt_async(upd.client, upd.seq)
        is_torn = self.torn(upd.client, upd.seq)
        if mode == MODE_NONE and not is_torn:
            return upd

        def leaf(x):
            if not x.is_floating_point():
                return x
            a = x.clone()                        # owned copy
            if mode == MODE_NAN:
                a.fill_(float("nan"))
            elif mode == MODE_INF:
                a.fill_(float("inf"))
            elif mode == MODE_BITFLIP:
                if a.dtype == torch.float32:
                    a = (a.view(torch.int32) ^ (1 << 30)).view(torch.float32)
                else:
                    a = a * torch.tensor(2.0 ** 40, dtype=a.dtype,
                                         device=a.device)
            elif mode == MODE_SCALE:
                a = a * torch.tensor(scale, dtype=a.dtype, device=a.device)
            if is_torn and a.ndim >= 1 and a.shape[0] > 1:
                # payload cut off mid-transfer: the tail rows never
                # arrived — NaN marks "no data", the validation gate
                # quarantines the whole entry
                a[a.shape[0] // 2:] = float("nan")
            return a

        return dataclasses.replace(
            upd, pdelta={p: leaf(x) for p, x in upd.pdelta.items()})

    # -- server kill ----------------------------------------------------
    def kill(self, round_idx: int) -> bool:
        p = self.kill_prob
        return p > 0.0 and float(_rng(self.seed, _TAG_KILL,
                                      self.incarnation,
                                      round_idx).random()) < p


def _bitflip_leaf(d: torch.Tensor) -> torch.Tensor:
    """Flip the high exponent bit of every element — a deterministic
    stand-in for radiation/transport bit errors that keeps values
    finite (so only the *norm* gate catches it, unlike nan/inf): bit 30
    of a float32, bit 13 of a 16-bit float."""
    if d.dtype == torch.float32:
        return (d.view(torch.int32) ^ (1 << 30)).view(torch.float32)
    if d.dtype in (torch.float16, torch.bfloat16):
        return (d.view(torch.int16) ^ (1 << 13)).view(d.dtype)
    return d * torch.tensor(2.0 ** 40, dtype=d.dtype, device=d.device)


def chaos_inject(pdeltas, mode, scale):
    """Apply the per-client corruption plan to packed deltas inside the
    round step.  Every leaf has a leading client axis; mode 0 selects
    the original value through ``torch.where``, a bitwise identity — a
    zero-rate chaos run still matches the plain round bit for bit."""
    mode = torch.as_tensor(mode, dtype=torch.int32)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    out = {}
    for p, d in pdeltas.items():
        if not d.is_floating_point():
            out[p] = d
            continue
        shape = tuple(mode.shape) + (1,) * (d.ndim - 1)
        m = mode.to(d.device).reshape(shape)
        s = scale.to(d.device).reshape(shape).to(d.dtype)
        o = torch.where(m == MODE_NAN,
                        torch.tensor(float("nan"), dtype=d.dtype,
                                     device=d.device), d)
        o = torch.where(m == MODE_INF,
                        torch.tensor(float("inf"), dtype=d.dtype,
                                     device=d.device), o)
        o = torch.where(m == MODE_BITFLIP, _bitflip_leaf(d), o)
        out[p] = torch.where(m == MODE_SCALE, d * s, o)
    return out


class ChaosHook:
    """The fault axis's server hook (duck-typed — hooks are any object
    with the three ``ServerHook`` methods).  Appended *after* user
    hooks by the Federation facade so an injected kill fires after the
    ``Checkpointer`` saved: the kill lands *between* ``on_round_end``
    hooks, the hardest restart boundary."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector

    def on_round_start(self, server, round_idx, weights):
        # sync-path crash: the client's update never arrives -> weight
        # 0 before the step.  The cohort and async engines own their
        # richer crash handling (resample / re-dispatch), so this hook
        # stands down there; at rate 0 it must not draw at all
        # (bit-exactness contract, same as StragglerDropout)
        inj = self.injector
        if inj.crash_prob <= 0.0 \
                or getattr(server, "cohort_engine", None) is not None \
                or getattr(server, "async_engine", None) is not None:
            return None
        keep = ~inj.crash_mask(round_idx, range(int(weights.shape[0])))
        return weights * torch.as_tensor(keep, dtype=torch.float32)

    def on_round_end(self, server, record, metrics):
        if self.injector.kill(record.round):
            raise ServerKilled(
                f"injected server kill after round {record.round} "
                f"(incarnation {self.injector.incarnation})")

    def on_fit_end(self, server, history):
        pass


def run_with_restarts(make_federation, rounds: int, ckpt_path: str, *,
                      max_restarts: int = 50):
    """Crash-restart harness: run ``rounds`` rounds to completion,
    rebuilding + resuming from ``ckpt_path`` every time the injected
    kill fires.  ``make_federation(incarnation)`` must return a fresh
    ``Federation``; the incarnation number feeds the kill draw so a
    restarted server doesn't re-die deterministically at the same
    boundary.  Returns the completed federation."""
    from ..ckpt.store import _manifest_path
    inc = 0
    while True:
        fed = make_federation(inc)
        if os.path.exists(_manifest_path(ckpt_path)):
            fed.restore(ckpt_path)
        done = fed.server.history[-1].round + 1 if fed.server.history \
            else 0
        if done >= rounds:
            return fed
        try:
            fed.fit(rounds - done)
            return fed
        except ServerKilled:
            inc += 1
            if inc > max_restarts:
                raise
