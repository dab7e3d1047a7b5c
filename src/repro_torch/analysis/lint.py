"""Level-2 repo lint: AST checks over ``src/repro_torch``.

The port of ``repro.analysis.lint``.  Four checkers, each registered
with the analyzer registry and each usable on an arbitrary file list so
the bad-fixture tests can feed intentionally broken sources:

* ``lint-registry``        — every ``@register_strategy/topology/
  staleness/client_sampler/fault/codec`` target carries a docstring and
  a resolvable name (a ``name = "..."`` class attribute, a name passed
  to the decorator, or — for function registries — the function name).
* ``lint-seeded-random``   — in ``core/`` and ``serve/``: no torch draw
  (``torch.rand*`` / ``randn`` / ``randint`` / ``randperm`` /
  ``normal`` / ``bernoulli`` / ``multinomial``, or an in-place
  ``.uniform_()`` / ``.normal_()`` / ``.exponential_()`` ...) without an
  explicit ``generator=``, no ``torch.manual_seed`` (it reseeds the
  process-wide default generator), no unseeded ``np.random.*`` and no
  wall-clock ``time.time()``; the blessed idioms are a
  ``torch.Generator`` passed as ``generator=``,
  ``np.random.default_rng(np.random.SeedSequence((seed, tag, ...)))``
  and ``time.perf_counter()`` for durations.
* ``lint-unguarded-entry`` — the reference's ``lint-bare-jit``: each
  entry point of the guarded modules (the round, async, cohort, serve
  and dry-run paths, ``ENTRY_POINTS``) is built as a ``CompileGuard``
  under its contracted name, and no ``torch.compile`` or ``torch.jit``
  appears there (a compiled path would escape the signature budget).
* ``lint-flconfig``        — every numeric ``FLConfig`` field is covered
  by a validator/consumer inside the class (``__post_init__`` or a
  ``resolve_*``/``uses_*`` method), and every field is read somewhere
  in ``src/repro_torch`` outside its definition (no dead knobs).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Set

from .findings import Finding, register_checker

# registries whose targets the discipline check covers; register_codec
# is the ROADMAP's next plugin axis — listed now so the gate covers it
# the day it lands (its absence today is simply zero decorated targets)
REGISTER_DECORATORS = {
    "register_strategy", "register_topology", "register_staleness",
    "register_client_sampler", "register_fault", "register_codec",
}

# np.random attributes that are legitimate *seeded* constructors; any
# other np.random.<attr> use in core/serve is an unseeded draw
SEEDED_NP_ATTRS = {
    "default_rng", "SeedSequence", "Generator", "BitGenerator",
    "PCG64", "Philox", "SFC64", "MT19937",
}

# the guarded modules and the CompileGuard names each must build
ENTRY_POINTS = {
    "src/repro_torch/core/server.py": ("round_step",),
    "src/repro_torch/core/async_agg.py": ("async_flush", "async_select",
                                          "async_cohort"),
    "src/repro_torch/core/cohort.py": ("cohort_select", "cohort_acc_init",
                                       "cohort_chunk", "cohort_finalize"),
    "src/repro_torch/serve/engine.py": ("serve_prefill", "serve_commit",
                                        "serve_decode", "static_prefill",
                                        "static_decode"),
    "src/repro_torch/launch/dryrun.py": ("dryrun_train", "dryrun_prefill",
                                         "dryrun_decode", "dryrun_fl_round",
                                         "dryrun_async_flush"),
}

SEEDED_SCOPE = ("src/repro_torch/core/", "src/repro_torch/serve/")

# torch draws that take ``generator=``; without it they consume the
# process-wide default generator
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
               "bernoulli", "multinomial", "rand_like", "randn_like",
               "randint_like", "poisson"}
INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                 "bernoulli_", "cauchy_", "log_normal_", "geometric_"}


def _rel(root: Path, path: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


def _parse(path: Path):
    return ast.parse(path.read_text(), filename=str(path))


def repo_py_files(root: Path) -> List[Path]:
    return sorted((root / "src" / "repro_torch").rglob("*.py"))


def _decorator_name(dec: ast.expr) -> Optional[str]:
    """Name of a decorator, seeing through call forms and attributes."""
    node = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _class_name_attr(node: ast.ClassDef) -> Optional[str]:
    """A literal ``name = "..."`` / ``name: str = "..."`` class attr."""
    for stmt in node.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            target = stmt.targets[0].id
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            target = stmt.target.id
            value = stmt.value
        if target == "name" and isinstance(value, ast.Constant) \
                and isinstance(value.value, str) and value.value:
            return value.value
        # tuple form: ``name, seam = "crash", "crash"``
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Tuple) \
                and isinstance(stmt.value, ast.Tuple) \
                and len(stmt.targets[0].elts) == len(stmt.value.elts):
            for tgt, val in zip(stmt.targets[0].elts, stmt.value.elts):
                if isinstance(tgt, ast.Name) and tgt.id == "name" \
                        and isinstance(val, ast.Constant) \
                        and isinstance(val.value, str) and val.value:
                    return val.value
    return None


def _decorator_name_kwarg(dec: ast.expr) -> Optional[str]:
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        for a in dec.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return a.value
    return None


# -- checker 1: registry discipline -----------------------------------------

def lint_registry(root: Path,
                  files: Optional[Iterable[Path]] = None) -> List[Finding]:
    out: List[Finding] = []
    for path in (files or repo_py_files(root)):
        rel = _rel(root, path)
        tree = _parse(path)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.ClassDef, ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            regs = [d for d in node.decorator_list
                    if _decorator_name(d) in REGISTER_DECORATORS]
            if not regs:
                continue
            reg = _decorator_name(regs[0])
            if not ast.get_docstring(node):
                out.append(Finding(
                    checker="", level="", anchor=rel, symbol=node.name,
                    line=node.lineno,
                    message=f"@{reg} target {node.name!r} has no "
                            f"docstring — registered plugins are the "
                            f"public surface; document the contract"))
            name = _decorator_name_kwarg(regs[0])
            if isinstance(node, ast.ClassDef):
                name = name or _class_name_attr(node)
            else:
                name = name or node.name     # function registries
            if not name:
                out.append(Finding(
                    checker="", level="", anchor=rel, symbol=node.name,
                    line=node.lineno,
                    message=f"@{reg} target {node.name!r} has no "
                            f"resolvable registry name (add a literal "
                            f"``name = \"...\"`` attribute or pass "
                            f"``name=`` to the decorator)"))
    return out


# -- checker 2: seeded randomness / wall clock -------------------------------

def lint_seeded_random(root: Path,
                       files: Optional[Iterable[Path]] = None
                       ) -> List[Finding]:
    out: List[Finding] = []
    for path in (files or repo_py_files(root)):
        rel = _rel(root, path)
        if files is None and not rel.startswith(SEEDED_SCOPE):
            continue
        tree = _parse(path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            # np.random.<attr> / numpy.random.<attr>
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "random" \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id in ("np", "numpy") \
                    and node.attr not in SEEDED_NP_ATTRS:
                out.append(Finding(
                    checker="", level="", anchor=rel,
                    symbol=f"np.random.{node.attr}", line=node.lineno,
                    message=f"unseeded np.random.{node.attr} in a "
                            f"determinism-critical tree — draw from "
                            f"np.random.default_rng(np.random."
                            f"SeedSequence((seed, tag, ...))) instead"))
            # time.time() — wall clock leaks into round math; durations
            # use time.perf_counter()
            if node.attr == "time" and isinstance(v, ast.Name) \
                    and v.id == "time":
                out.append(Finding(
                    checker="", level="", anchor=rel, symbol="time.time",
                    line=node.lineno,
                    message="time.time() in a determinism-critical "
                            "tree — use time.perf_counter() for "
                            "durations or a seeded simulated clock"))
            # torch.manual_seed / torch.cuda.manual_seed[_all]: reseeds
            # the process-wide default generator
            if node.attr in ("manual_seed", "manual_seed_all") and (
                    _dotted(v) in ("torch", "torch.cuda")):
                out.append(Finding(
                    checker="", level="", anchor=rel,
                    symbol=f"{_dotted(v)}.{node.attr}", line=node.lineno,
                    message=f"{_dotted(v)}.{node.attr} reseeds the "
                            f"process-wide default generator — seed a "
                            f"torch.Generator and pass it as generator="))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            if any(kw.arg == "generator" for kw in node.keywords):
                continue
            f = node.func
            if f.attr in TORCH_DRAWS and _dotted(f.value) == "torch":
                sym = f"torch.{f.attr}"
            elif f.attr in INPLACE_DRAWS:
                sym = f".{f.attr}"
            else:
                continue
            out.append(Finding(
                checker="", level="", anchor=rel, symbol=sym,
                line=node.lineno,
                message=f"{sym}() without generator= draws from the "
                        f"process-wide default generator in a "
                        f"determinism-critical tree — pass a seeded "
                        f"torch.Generator"))
    return out


def _dotted(node: ast.expr) -> str:
    """``a.b.c`` of a Name/Attribute chain, else ""."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    return ".".join([node.id] + parts[::-1])


# -- checker 3: entry points routed through CompileGuard --------------------

def _guard_names(tree: ast.Module) -> Set[str]:
    """``name=`` literals of every ``CompileGuard(...)`` call."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                _dotted(node.func).split(".")[-1] == "CompileGuard":
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    out.add(kw.value.value)
    return out


def lint_unguarded_entry(root: Path,
                         files: Optional[Iterable[Path]] = None,
                         entry_points: Optional[dict] = None
                         ) -> List[Finding]:
    """``entry_points`` maps a module (relative to ``root``) to the guard
    names it must build; ``files`` are further sources that must hold no
    ``torch.compile`` / ``torch.jit``."""
    out: List[Finding] = []
    table = ENTRY_POINTS if entry_points is None else entry_points
    paths = [root / m for m in table] + list(files or [])
    for path in paths:
        rel = _rel(root, path)
        if not path.exists():
            out.append(Finding(
                checker="", level="", anchor=rel, symbol="missing",
                message=f"guarded module {rel} does not exist"))
            continue
        tree = _parse(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    _dotted(node) in ("torch.compile", "torch.jit"):
                sym = _dotted(node)
                out.append(Finding(
                    checker="", level="", anchor=rel, symbol=sym,
                    line=node.lineno,
                    message=f"{sym} in a guarded entry-point module — "
                            f"a compiled path escapes the CompileGuard "
                            f"signature budget; route the entry point "
                            f"through repro_torch.analysis.compileguard"))
        have = _guard_names(tree)
        for name in table.get(rel, ()):
            if name not in have:
                out.append(Finding(
                    checker="", level="", anchor=rel, symbol=name,
                    message=f"entry point {name!r} of {rel} is not built "
                            f"as CompileGuard(..., name={name!r}) — its "
                            f"signature budget is unenforced"))
    return out


# -- checker 4: FLConfig field/validator coverage ----------------------------

def _flconfig_class(tree: ast.Module) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "FLConfig":
            return node
    return None


def _is_numeric_ann(ann: ast.expr) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in ("int", "float")
    if isinstance(ann, ast.Subscript):       # Optional[int] etc.
        return any(_is_numeric_ann(n) for n in ast.walk(ann)
                   if isinstance(n, ast.Name))
    return False


def lint_flconfig(root: Path,
                  config_file: Optional[Path] = None,
                  files: Optional[Iterable[Path]] = None) -> List[Finding]:
    cfg_path = config_file or (root / "src/repro_torch/core/federation.py")
    if not cfg_path.exists():
        return []
    rel = _rel(root, cfg_path)
    tree = _parse(cfg_path)
    cls = _flconfig_class(tree)
    if cls is None:
        return []
    fields = {}           # name -> (lineno, numeric)
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            fields[stmt.target.id] = (stmt.lineno,
                                      _is_numeric_ann(stmt.annotation))
    # self.<field> references inside FLConfig methods = validator or
    # consumer coverage
    method_refs: Set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(stmt):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self":
                    method_refs.add(node.attr)
    # .<field> attribute reads anywhere else in the tree = knob is live
    external_refs: Set[str] = set()
    for path in (files or repo_py_files(root)):
        if path.resolve() == cfg_path.resolve():
            continue
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Attribute):
                external_refs.add(node.attr)

    out: List[Finding] = []
    for name, (lineno, numeric) in fields.items():
        if numeric and name not in method_refs:
            out.append(Finding(
                checker="", level="", anchor=rel, symbol=name, line=lineno,
                message=f"numeric FLConfig field {name!r} has no "
                        f"validator/consumer inside FLConfig — add a "
                        f"__post_init__ range check (misconfig should "
                        f"fail at build time, not rounds later)"))
        if name not in external_refs and name not in method_refs:
            # a field consumed only through an FLConfig resolver method
            # (e.g. resolve_n_edges) is live — method_refs covers it
            out.append(Finding(
                checker="", level="", anchor=rel, symbol=name, line=lineno,
                message=f"FLConfig field {name!r} is never read outside "
                        f"its definition — dead knob (wire it up or "
                        f"delete it)"))
    return out


# -- registry wiring ---------------------------------------------------------

@register_checker("lint-registry", "lint")
def _registry_checker(root: Path) -> List[Finding]:
    return lint_registry(root)


@register_checker("lint-seeded-random", "lint")
def _seeded_checker(root: Path) -> List[Finding]:
    return lint_seeded_random(root)


@register_checker("lint-unguarded-entry", "lint")
def _unguarded_entry_checker(root: Path) -> List[Finding]:
    return lint_unguarded_entry(root)


@register_checker("lint-flconfig", "lint")
def _flconfig_checker(root: Path) -> List[Finding]:
    return lint_flconfig(root)
