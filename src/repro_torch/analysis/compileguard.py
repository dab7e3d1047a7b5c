"""CompileGuard: an input-signature budget on an entry point.

The port of ``repro.analysis.compileguard``.  The reference wraps
``jax.jit`` and holds each compiled path to a declared number of
programs.  The port compiles nothing: a "program" here is an input
signature — the paths, shapes, dtypes and devices of the tensor
arguments and the types of the others — the unit a CUDA graph of the
step would capture.  Each entry point declares up front how many
signatures it may see (``max_programs``: the round paths and the decode
step declare 1), the wrapper records the signature of every call, and a
call that would cross the budget raises :class:`CompileGuardError`
**before** ``fn`` runs, naming the argument whose shape, dtype, device
or structure changed.

``donate_argnums`` declares the arguments the step overwrites in place
(the reference's donated buffers); ``repro_torch.analysis.tracecheck``
checks that those leaves keep their storage through a call and are not
copied whole.

This module imports only ``torch``: ``core/`` and ``serve/`` import it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["CompileGuard", "CompileGuardError"]


class CompileGuardError(RuntimeError):
    """A guarded entry point was called with more input signatures than
    its declared budget."""


def _flatten(x, path: str, out: List[Tuple[str, Any]]) -> None:
    """(path, leaf) pairs of nested dicts, lists, tuples and dataclasses,
    in a fixed order (dict keys sorted)."""
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            _flatten(x[k], f"{path}[{k!r}]", out)
    elif isinstance(x, (list, tuple)):
        fields = getattr(x, "_fields", None)
        for i, v in enumerate(x):
            _flatten(v, f"{path}.{fields[i]}" if fields else f"{path}[{i}]",
                     out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _flatten(getattr(x, f.name), f"{path}.{f.name}", out)
    else:
        out.append((path, x))


def _leaf_spec(x) -> Tuple:
    """Hashable spec of one argument leaf: what a captured graph fixes."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, x.dtype.str)
    return ("py", type(x).__name__)


def _spec_str(spec: Tuple) -> str:
    if spec[0] == "tensor":
        _, shape, dtype, device = spec
        return f"{str(dtype).replace('torch.', '')}{list(shape)}@{device}"
    if spec[0] == "ndarray":
        return f"ndarray{list(spec[1])}{spec[2]}"
    return f"<{spec[1]}>"


class CompileGuard:
    """Wrap ``fn`` and enforce an input-signature budget.

    Parameters
    ----------
    fn:            the function to run (kept on ``guard.fn``).
    name:          label used in error messages and analyzer reports.
    max_programs:  how many distinct input signatures this entry point
                   may see; ``None`` = unbounded (the history is still
                   recorded).  The round paths and the serve decode step
                   declare 1; serve prefill is unbounded (one signature
                   per distinct prompt length).
    donate_argnums: the positional arguments ``fn`` overwrites in place.
    """

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 max_programs: Optional[int] = 1,
                 donate_argnums: Sequence[int] = ()):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "guarded")
        self.max_programs = max_programs
        self.donate_argnums = tuple(donate_argnums)
        # call-order history: signature key -> [(arg path, leaf spec)]
        self._sigs: Dict[Tuple, List[Tuple[str, Tuple]]] = {}

    # -- signature bookkeeping ----------------------------------------------

    def _signature(self, args, kwargs):
        leaves: List[Tuple[str, Any]] = []
        for i, a in enumerate(args):
            _flatten(a, f"args[{i}]", leaves)
        for k in sorted(kwargs):
            _flatten(kwargs[k], k, leaves)
        pretty = [(p, _leaf_spec(x)) for p, x in leaves]
        return tuple(pretty), pretty

    def _diff(self, pretty) -> List[str]:
        """Human diff of the new signature against the last recorded."""
        old = list(self._sigs.values())[-1]
        if len(old) != len(pretty) or \
                [p for p, _ in old] != [p for p, _ in pretty]:
            return [f"argument structure changed: {len(old)} -> "
                    f"{len(pretty)} leaves (e.g. an optional argument "
                    f"appeared or a tree changed its keys)"]
        return [f"arg {p}: {_spec_str(os)} -> {_spec_str(ns)}"
                for (p, os), (_, ns) in zip(old, pretty) if os != ns]

    def _record(self, args, kwargs) -> List[Tuple[str, Tuple]]:
        key, pretty = self._signature(args, kwargs)
        if key in self._sigs:
            return pretty
        if self.max_programs is not None and \
                len(self._sigs) >= self.max_programs:
            diff = "\n  ".join(self._diff(pretty))
            raise CompileGuardError(
                f"CompileGuard[{self.name}]: call would add program "
                f"#{len(self._sigs) + 1} (budget {self.max_programs}). "
                f"Signature-changing argument(s):\n  {diff}")
        self._sigs[key] = pretty
        return pretty

    # -- call surface -------------------------------------------------------

    def __call__(self, *args, **kwargs):
        self._record(args, kwargs)
        return self.fn(*args, **kwargs)

    def lower(self, *args, **kwargs) -> List[Tuple[str, str]]:
        """Record a signature without running ``fn`` (dry-run paths);
        counts against the budget.  Returns the signature."""
        return [(p, _spec_str(s)) for p, s in self._record(args, kwargs)]

    # -- introspection (used by repro_torch.analysis.tracecheck) ------------

    @property
    def cache_size(self) -> int:
        """Number of distinct input signatures seen (calls and lowers)."""
        return len(self._sigs)

    @property
    def programs(self) -> List[List[Tuple[str, str]]]:
        """Recorded signatures, call order: [[(arg path, spec), ...]]."""
        return [[(p, _spec_str(s)) for p, s in sig]
                for sig in self._sigs.values()]

    def assert_programs(self, n: int):
        """Hard assertion for smoke gates: at most ``n`` programs."""
        if self.cache_size > n:
            raise CompileGuardError(
                f"CompileGuard[{self.name}]: {self.cache_size} input "
                f"signatures, expected <= {n}")
