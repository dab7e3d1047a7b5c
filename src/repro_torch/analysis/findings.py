"""Finding/report/suppression plumbing shared by both analyzer levels.

The port's copy of ``repro.analysis.findings``.  A checker is a
function registered under a name and a level (``lint`` for AST checks,
``trace`` for the dispatch-level checks of ``tracecheck``) that returns
a list of
:class:`Finding`.  The CLI runs every registered checker, applies the
baseline suppressions file, writes the JSON report and exits non-zero
on any unsuppressed finding — the gate.

Suppression format (``src/repro_torch/analysis/baseline.json``)::

    {"suppressions": [
        {"checker": "lint-unguarded-entry",
         "match": "src/repro_torch/launch/dryrun.py::*",
         "reason": "documented exception ..."}]}

``match`` is an ``fnmatch`` glob over the finding's stable fingerprint
``<anchor>::<symbol>`` (anchor = file path or traced-path name, no line
numbers, so suppressions survive unrelated edits).  Every suppression
must keep matching something: a stale entry is itself reported as a
finding, so the baseline can only shrink.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Finding", "register_checker", "registered_checkers",
           "run_checkers", "load_suppressions", "apply_suppressions",
           "report_dict"]


@dataclasses.dataclass
class Finding:
    checker: str            # registered checker name
    level: str              # "lint" | "trace"
    anchor: str             # file path or traced-path name (stable)
    message: str
    symbol: str = ""        # class/function/program within the anchor
    line: int = 0           # display only — not part of the fingerprint
    suppressed: bool = False
    suppress_reason: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.anchor}::{self.symbol}"

    @property
    def location(self) -> str:
        return f"{self.anchor}:{self.line}" if self.line else self.anchor

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        d["location"] = self.location
        return d


# -- checker registry --------------------------------------------------------

_CHECKERS: Dict[str, Tuple[str, Callable]] = {}


def register_checker(name: str, level: str):
    """Decorator: register ``fn(root: Path) -> List[Finding]``."""
    if level not in ("lint", "trace"):
        raise ValueError(f"level must be lint|trace, got {level!r}")

    def deco(fn):
        _CHECKERS[name] = (level, fn)
        return fn
    return deco


def registered_checkers(level: Optional[str] = None) -> List[str]:
    return sorted(n for n, (lv, _) in _CHECKERS.items()
                  if level in (None, lv))


def run_checkers(root: Path, level: Optional[str] = None) -> List[Finding]:
    out: List[Finding] = []
    for name in registered_checkers(level):
        lv, fn = _CHECKERS[name]
        for f in fn(root):
            f.checker, f.level = name, lv
            out.append(f)
    return out


# -- suppressions ------------------------------------------------------------

def load_suppressions(path: Path) -> List[Dict]:
    if not Path(path).exists():
        return []
    data = json.loads(Path(path).read_text())
    sups = data.get("suppressions", [])
    for s in sups:
        for k in ("checker", "match", "reason"):
            if not s.get(k):
                raise ValueError(
                    f"suppression entry {s!r} missing required key {k!r}")
    return sups


def apply_suppressions(findings: List[Finding],
                       sups: List[Dict]) -> List[Finding]:
    """Mark suppressed findings in place; append a finding per stale
    suppression (one that matched nothing)."""
    used = [False] * len(sups)
    for f in findings:
        for i, s in enumerate(sups):
            if s["checker"] == f.checker and \
                    fnmatch.fnmatch(f.fingerprint, s["match"]):
                f.suppressed = True
                f.suppress_reason = s["reason"]
                used[i] = True
                break
    for s, u in zip(sups, used):
        if not u:
            findings.append(Finding(
                checker="suppressions", level="lint",
                anchor="src/repro_torch/analysis/baseline.json",
                symbol=f"{s['checker']}::{s['match']}",
                message=f"stale suppression (matched no finding): "
                        f"checker={s['checker']} match={s['match']!r} — "
                        f"delete it"))
    return findings


# -- report ------------------------------------------------------------------

def report_dict(findings: List[Finding], checkers: List[str]) -> Dict:
    unsup = [f for f in findings if not f.suppressed]
    return {
        "version": 1,
        "tool": "repro_torch.analysis",
        "checkers_run": checkers,
        "summary": {
            "total": len(findings),
            "suppressed": len(findings) - len(unsup),
            "unsuppressed": len(unsup),
            "by_checker": {
                c: sum(1 for f in findings if f.checker == c)
                for c in sorted({f.checker for f in findings})},
        },
        "findings": [f.to_json() for f in findings],
    }
