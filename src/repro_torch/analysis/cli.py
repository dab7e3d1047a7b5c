"""Analyzer entry point — the port's gate.

Usage::

    python -m repro_torch.analysis.cli --report results/analysis_torch.json \\
        [--level lint|trace] [--device cuda|cpu]

Runs every registered checker (``--level lint`` / ``--level trace``
restricts to one level), applies the baseline suppressions, writes the
JSON report and exits non-zero iff any non-suppressed finding remains.
The trace level runs its programs on ``--device``: the card by default,
and with no card it fails unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import lint as _lint              # noqa: F401 — registers checkers
from . import tracecheck as _trace
from .findings import (apply_suppressions, load_suppressions,
                       registered_checkers, report_dict, run_checkers)

REPO_ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="the port's static-analysis gate: AST lint + "
                    "dispatch-level contract checks")
    ap.add_argument("--report", default="results/analysis_torch.json",
                    help="JSON report path (default %(default)s)")
    ap.add_argument("--suppressions",
                    default=str(REPO_ROOT /
                                "src/repro_torch/analysis/baseline.json"),
                    help="baseline suppressions file")
    ap.add_argument("--level", choices=("all", "lint", "trace"),
                    default="all",
                    help="run only one checker level (default all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the trace level runs its programs on "
                         "(default %(default)s; no fallback)")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root for the AST lint (default: this "
                         "checkout)")
    args = ap.parse_args(argv)

    level = None if args.level == "all" else args.level
    _trace.set_trace_device(args.device)
    checkers = registered_checkers(level)
    findings = run_checkers(Path(args.root), level)
    findings = apply_suppressions(
        findings, load_suppressions(Path(args.suppressions)))

    report = report_dict(findings, checkers)
    report["device"] = args.device
    if level != "lint":
        reg = _trace.traced_programs(args.device)
        report["programs"] = {p.name: p.launches for p in reg.programs}
    out = Path(args.report)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")

    unsup = [f for f in findings if not f.suppressed]
    s = report["summary"]
    print(f"repro_torch.analysis: {len(checkers)} checkers on "
          f"{args.device}, {s['total']} finding(s) ({s['suppressed']} "
          f"suppressed) -> {out}")
    for f in unsup:
        print(f"  {f.checker}: {f.location} [{f.symbol}] {f.message}")
    return 1 if unsup else 0


if __name__ == "__main__":
    sys.exit(main())
