"""The port's static-analysis subsystem (``repro_torch.analysis``), twin
of ``tests/test_analysis.py``: every checker is proven by an
intentionally bad fixture it must flag, the port itself must pass clean
(on the CPU here; ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
run the trace level on the card), and CompileGuard enforces the
signature budget of every guarded entry point."""
import inspect
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import cli
from repro_torch.analysis import lint as L
from repro_torch.analysis import tracecheck as T
from repro_torch.analysis.compileguard import CompileGuard, CompileGuardError
from repro_torch.analysis.findings import (Finding, apply_suppressions,
                                           load_suppressions,
                                           registered_checkers, report_dict,
                                           run_checkers)

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def registry():
    T.set_trace_device("cpu")
    return T.traced_programs("cpu")


# ---------------------------------------------------------------------------
# CompileGuard

def test_compileguard_budget_names_signature_argument():
    guard = CompileGuard(lambda x, y: x + y, name="adder", max_programs=1)
    guard(torch.zeros(4), torch.zeros(4))
    guard(torch.ones(4), torch.ones(4))            # same signature: fine
    assert guard.cache_size == 1
    with pytest.raises(CompileGuardError) as ei:
        guard(torch.zeros(8), torch.zeros(8))
    msg = str(ei.value)
    assert "adder" in msg and "budget 1" in msg
    # the diff names the argument and the shape transition
    assert "args[0]" in msg and "float32[4]" in msg and "float32[8]" in msg


def test_compileguard_structure_change_diff():
    guard = CompileGuard(lambda t: sum(v.sum() for v in t.values()),
                         max_programs=1)
    guard({"a": torch.zeros(2)})
    with pytest.raises(CompileGuardError) as ei:
        guard({"a": torch.zeros(2), "b": torch.zeros(2)})
    assert "structure changed" in str(ei.value)


def test_compileguard_unbounded_records_history():
    guard = CompileGuard(lambda x: x * 2, max_programs=None)
    guard(torch.zeros(2))
    guard(torch.zeros(3))
    guard(torch.zeros(3, dtype=torch.float64))     # dtype is signature
    assert guard.cache_size == 3 and len(guard.programs) == 3
    with pytest.raises(CompileGuardError):
        guard.assert_programs(1)


def test_compileguard_lower_counts_against_budget_and_runs_nothing():
    calls = []
    guard = CompileGuard(lambda x: calls.append(x), max_programs=1)
    sig = guard.lower(torch.empty(4, device="meta"))
    assert calls == [] and sig == [("args[0]", "float32[4]@meta")]
    with pytest.raises(CompileGuardError):
        guard.lower(torch.empty(8, device="meta"))


def test_compileguard_declares_donation_and_types_of_other_leaves():
    guard = CompileGuard(lambda acc, n: acc.add_(n), max_programs=1,
                         donate_argnums=(0,))
    assert guard.donate_argnums == (0,)
    x = torch.zeros(16)
    assert guard(x, 1) is x                       # written in place
    with pytest.raises(CompileGuardError, match=r"<int> -> <float>"):
        guard(x, 1.5)                             # a python type changes


def test_engine_decode_is_guarded_and_reads_its_cache_size(registry):
    from repro_torch.serve.engine import DecodeEngine
    guards = dict(registry.guards)
    dec = guards["trace:serve/decode"]
    assert isinstance(dec, CompileGuard) and dec.name == "serve_decode"
    assert dec.cache_size == 1
    src = inspect.getsource(DecodeEngine.decode_cache_size.fget)
    assert "self._decode.cache_size" in src


# ---------------------------------------------------------------------------
# level-2 lint: bad fixtures

def test_lint_registry_flags_missing_docstring_and_name(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("@register_strategy\nclass Nameless:\n    pass\n")
    out = L.lint_registry(tmp_path, files=[bad])
    assert {f.message.split(" ")[0] for f in out} == {"@register_strategy"}
    assert len(out) == 2          # no docstring + no resolvable name
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent('''
        @register_fault
        class CrashFault:
            """doc"""
            name, seam = "crash", "crash"

        @register_staleness
        def polynomial(s, a):
            """doc"""
            return s
        '''))
    assert L.lint_registry(tmp_path, files=[good]) == []


def test_lint_seeded_random_flags_unseeded_draws(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np, time, torch
        x = np.random.rand(3)
        t = time.time()
        u = torch.rand((3,))
        v = torch.randperm(5, device="cpu")
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        w = torch.empty(3).uniform_()
        """))
    out = L.lint_seeded_random(tmp_path, files=[bad])
    assert {f.symbol for f in out} == {
        "np.random.rand", "time.time", "torch.rand", "torch.randperm",
        "torch.manual_seed", "torch.cuda.manual_seed_all", ".uniform_"}
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        import numpy as np, time, torch
        rng = np.random.default_rng(np.random.SeedSequence((0, 1)))
        t = time.perf_counter()
        gen = torch.Generator().manual_seed(3)
        u = torch.rand((3,), generator=gen)
        w = torch.empty(3).uniform_(generator=gen)
        """))
    assert L.lint_seeded_random(tmp_path, files=[good]) == []


def test_lint_unguarded_entry_flags_compile_and_missing_guard(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(textwrap.dedent("""
        import torch
        step = torch.compile(lambda x: x)
        other = torch.jit.script(lambda x: x)
        """))
    out = L.lint_unguarded_entry(tmp_path, entry_points={
        "mod.py": ("round_step",)})
    assert sorted(f.symbol for f in out) == ["round_step", "torch.compile",
                                            "torch.jit"]
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        from repro_torch.analysis.compileguard import CompileGuard
        step = CompileGuard(lambda x: x, name="round_step")
        """))
    assert L.lint_unguarded_entry(tmp_path, entry_points={
        "good.py": ("round_step",)}) == []


def test_lint_flconfig_flags_unvalidated_and_dead_fields(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(textwrap.dedent("""
        import dataclasses
        @dataclasses.dataclass
        class FLConfig:
            dead_knob: int = 3
            live: float = 0.1
            def __post_init__(self):
                if self.live < 0:
                    raise ValueError()
        """))
    user = tmp_path / "user.py"
    user.write_text("def f(fl):\n    return fl.live\n")
    out = L.lint_flconfig(tmp_path, config_file=cfg, files=[cfg, user])
    # dead_knob: numeric without validator AND never read anywhere
    assert sorted(f.symbol for f in out) == ["dead_knob", "dead_knob"]


# ---------------------------------------------------------------------------
# trace checkers: bad fixtures

def _without(fn, old: str, new: str):
    """A copy of ``fn`` compiled from its source with ``old`` replaced —
    the regression each frozen-grad checker exists to catch."""
    src = textwrap.dedent(inspect.getsource(fn))
    assert old in src
    scope = dict(fn.__globals__)
    exec(compile(src.replace(old, new), inspect.getsourcefile(fn), "exec"),
         scope)
    return scope[fn.__name__]


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_frozen_grad_passes_on_the_real_update(kind):
    from repro_torch.core.client import local_update, local_update_packed
    fixture = T._probe_fixture(CPU)
    check, fn = ((T.check_frozen_grad_packed, local_update_packed)
                 if kind == "packed" else
                 (T.check_frozen_grad_dense, local_update))
    assert check("fix", fn, fixture) == []


def test_frozen_grad_flags_missing_detach():
    from repro_torch.core.client import local_update_packed
    bad = _without(local_update_packed,
                   "global_params[p].detach().index_copy(",
                   "global_params[p].index_copy(")
    fixture = T._probe_fixture(CPU)
    out = T.check_frozen_grad_packed("fix", bad, fixture)
    stacked = [p for p in fixture[1]
               if fixture[2].leaf_units[p].kind == "stacked"]
    # every stacked leaf's frozen row gets gradient without the detach
    assert sorted(f.symbol for f in out) == sorted(stacked)
    assert "detached" in out[0].message


def test_frozen_grad_flags_missing_gradient_mask():
    from repro_torch.core.client import local_update
    bad = _without(local_update, "grads = apply_mask(dmask, grads)", "pass")
    out = T.check_frozen_grad_dense("fix", bad, T._probe_fixture(CPU))
    assert {f.symbol for f in out} == {"blocks/b1", "blocks/w1",
                                       "blocks/w2"}


def test_key_flow_flags_reused_generator_state():
    def reuse(x):
        g = torch.Generator().manual_seed(5)
        state = g.get_state()
        a = torch.rand(3, generator=g)
        g.set_state(state)                     # the same stream again
        return x + a + torch.rand(3, generator=g)
    _, events = T.record(reuse, torch.zeros(3))
    assert [f.symbol for f in T.check_key_flow("fix", events)] == \
        ["state-reuse"]
    # two generators seeded alike draw one stream too
    _, events = T.record(lambda: torch.rand(
        2, generator=torch.Generator().manual_seed(1)) + torch.rand(
        2, generator=torch.Generator().manual_seed(1)))
    assert [f.symbol for f in T.check_key_flow("fix", events)] == \
        ["state-reuse"]


def test_key_flow_flags_default_generator():
    _, events = T.record(lambda x: torch.randn(2) + x.bernoulli_(0.5),
                         torch.zeros(2))
    assert sorted(f.symbol for f in T.check_key_flow("fix", events)) == \
        ["default-generator:bernoulli_", "default-generator:randn"]


def test_key_flow_accepts_per_row_generators():
    """The serve idiom — a generator per (request, token index) — draws
    distinct states, never the default generator."""
    from repro_torch.serve.engine import gumbel_rows
    _, events = T.record(gumbel_rows, 7, np.arange(3), np.full(3, 2), 11)
    assert sum(e.generator is not None for e in events) == 3
    assert T.check_key_flow("fix", events) == []


@pytest.mark.parametrize("body,symbol", [
    (lambda x: x.sum().item(), "_local_scalar_dense"),
    (lambda x: bool(x.max() > 0), "_local_scalar_dense"),
    (lambda x: torch.nonzero(x), "nonzero"),
    (lambda x: x[x > 0], "index(bool mask)"),
    (lambda x: torch.unique(x), "_unique2")])
def test_host_sync_flags_device_reads_and_respects_allowlist(body, symbol):
    x = torch.arange(4.0)
    _, events = T.record(body, x, device_tensors=[x])
    out = T.check_host_sync("fix", events)
    assert symbol in [f.symbol for f in out]
    assert T.check_host_sync("fix", events,
                             allow=[f.symbol for f in out]) == []
    # the same op on a host tensor is no sync
    _, events = T.record(body, torch.arange(4.0))
    assert T.check_host_sync("fix", events) == []


def test_donation_flags_silent_copy():
    acc = {"a": torch.zeros(4), "b": torch.zeros(2, 3)}

    def copies(acc):
        return {p: v.clone().add_(1) for p, v in acc.items()}

    def in_place(acc):
        for v in acc.values():
            v.add_(1)
        return acc

    donated = {f"args[0][{p!r}]": t for p, t in acc.items()}
    out, events = T.record(copies, acc, donated=list(acc.values()))
    bad = T.check_donation("fix", donated, out, events)
    assert len(bad) == 2 and "copied whole" in bad[0].message
    out, events = T.record(in_place, acc, donated=list(acc.values()))
    assert T.check_donation("fix", donated, out, events) == []


def test_codec_pad_zeros_passes_real_and_flags_leaky():
    """The real codec transforms keep pads/non-participants at exact
    zero; a transform that skips the valid-mask multiply must fire."""
    from repro_torch.core import codecs as C
    from repro_torch.core.federation import FLConfig
    fl = FLConfig(n_clients=3, train_fraction=0.5, packed=True,
                  fused_agg="off", codec="qint8")
    params, assign, _, n_slots = T._toy_fixture(fl, CPU)
    good = C.build_codec_transform(C.get_codec("qint8"), assign, fl)
    assert T.check_codec_pad_zeros("fix", good, assign, params, fl,
                                   n_slots) == []

    def leaky(pdeltas, rows, valid, weights, uniform=None, state=None,
              decay=None):
        return pdeltas, None     # ships the raw payload, mask forgotten

    out = T.check_codec_pad_zeros("fix", leaky, assign, params, fl,
                                  n_slots)
    assert out and "valid mask" in out[0].message


def test_guard_contract_flags_bare_function_and_wrong_budget():
    out = T.check_guard_contract("fix", lambda x: x, 1, ())
    assert len(out) == 1 and "not routed through CompileGuard" \
        in out[0].message
    guard = CompileGuard(lambda x: x, max_programs=None)
    out = T.check_guard_contract("fix", guard, 1, (0,))
    assert sorted(f.symbol for f in out) == ["donate-argnums",
                                             "max-programs"]


# ---------------------------------------------------------------------------
# suppressions / report plumbing

def test_suppressions_match_and_stale_entries_flagged(tmp_path):
    f = Finding(checker="lint-unguarded-entry", level="lint",
                anchor="a.py", symbol="torch.compile", message="m")
    sups = [{"checker": "lint-unguarded-entry", "match": "a.py::*",
             "reason": "documented"},
            {"checker": "lint-unguarded-entry", "match": "gone.py::*",
             "reason": "stale"}]
    out = apply_suppressions([f], sups)
    assert out[0].suppressed and out[0].suppress_reason == "documented"
    stale = [x for x in out if x.checker == "suppressions"]
    assert len(stale) == 1 and "gone.py" in stale[0].symbol
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"suppressions": [{"checker": "c"}]}))
    with pytest.raises(ValueError, match="missing required key"):
        load_suppressions(p)


def test_report_dict_summary_counts():
    fs = [Finding(checker="a", level="lint", anchor="x", message="m"),
          Finding(checker="b", level="trace", anchor="y", message="m",
                  suppressed=True)]
    rep = report_dict(fs, ["a", "b"])
    assert rep["summary"] == {"total": 2, "suppressed": 1,
                              "unsuppressed": 1,
                              "by_checker": {"a": 1, "b": 1}}
    assert rep["findings"][0]["fingerprint"] == "x::"


# ---------------------------------------------------------------------------
# the repo gate itself

def test_repo_lint_level_is_clean():
    assert run_checkers(REPO_ROOT, "lint") == []


def test_repo_trace_level_is_clean_and_covers_all_paths(registry):
    """The acceptance gate on the CPU: host-sync, key-flow, frozen-grad,
    donation, guard and codec contracts pass on the real paths — sync,
    async, cohort and serve."""
    names = [p.name for p in registry.programs]
    assert names == [
        "trace:sync/round_step", "trace:sync/round_step_dense",
        "trace:sync/round_step_qint8", "trace:async/select",
        "trace:async/cohort", "trace:async/flush", "trace:cohort/select",
        "trace:cohort/acc_init", "trace:cohort/chunk",
        "trace:cohort/finalize", "trace:serve/prefill",
        "trace:serve/decode"]
    assert {n for n, _, _ in registry.grad_probes} == {
        "trace:sync/frozen_grad", "trace:sync/frozen_grad_dense"}
    progs = {p.name: p for p in registry.programs}
    # the checks are not vacuous: the decode samples through generators,
    # the rounds select through the server's, the chunk donates its carry
    for name in ("trace:serve/decode", "trace:sync/round_step_qint8"):
        assert any(e.generator for e in progs[name].events)
    assert progs["trace:cohort/chunk"].donated
    assert any(e.on_device for e in progs["trace:serve/decode"].events)
    assert run_checkers(REPO_ROOT, "trace") == []


def test_checker_registry_names():
    assert registered_checkers("lint") == [
        "lint-flconfig", "lint-registry", "lint-seeded-random",
        "lint-unguarded-entry"]
    assert registered_checkers("trace") == [
        "trace-codec-frozen", "trace-compileguard", "trace-donation",
        "trace-frozen-grad", "trace-host-sync", "trace-key-flow"]


def test_cli_exit_codes(tmp_path, capsys):
    report = tmp_path / "r.json"
    assert cli.main(["--level", "lint", "--report", str(report)]) == 0
    assert json.loads(report.read_text())["summary"]["total"] == 0
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({"suppressions": [{
        "checker": "lint-registry", "match": "nothing::*",
        "reason": "matches no finding"}]}))
    assert cli.main(["--level", "lint", "--report", str(report),
                     "--suppressions", str(stale)]) == 1
    assert "stale suppression" in capsys.readouterr().out


def test_cli_trace_level_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--level", "trace", "--report",
                  str(tmp_path / "r.json")])
    T.set_trace_device("cpu")
