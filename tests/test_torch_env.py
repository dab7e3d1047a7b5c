"""The port's production launch profile (``launch/env.py``) and the
launcher's ``--prod-env`` / ``--client-shards``.

The reference's ``tests/test_env.py`` cases on ``production_env``, with
``PYTORCH_CUDA_ALLOC_CONF`` (merged key by key, a user's key wins) in
place of the XLA flags: the profile applied to an empty environment,
user settings not clobbered, unrelated variables kept, tcmalloc
preloaded only when its ``.so`` exists, the re-exec guard a no-op, the
re-exec's module and argv.  ``train.main(["--prod-env", ...])`` re-execs
``repro_torch.launch.train`` with its own argv (``os.execve`` recorded).
Then the launcher for real under ``torchrun --standalone`` (its
rendezvous on a port the OS picks) with 2 gloo ranks on the CPU,
``--prod-env --client-shards 2 --reduced --device cpu``: each rank
re-execs once under the profile, joins the group from torchrun's
environment and trains its block of clients; only rank 0 prints, and the
round losses and the comm summary equal the single-process run's.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import env as prod
from repro_torch.launch import train

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARGV = ["--reduced", "--device", "cpu", "--clients", "2", "--rounds", "2",
        "--batch-size", "2", "--steps-per-round", "1", "--seq", "32"]


def test_profile_applied_to_empty_env():
    e = prod.production_env(base={}, tcmalloc=False)
    assert e["PYTORCH_CUDA_ALLOC_CONF"].split(",") == \
        list(prod.PROD_ALLOC_CONF)
    assert e[prod.GUARD_VAR] == "1"
    assert "LD_PRELOAD" not in e


def test_user_settings_not_clobbered():
    """An explicit operator value for a profile key survives; profile
    keys the user did not set are appended."""
    user = "expandable_segments:False,max_split_size_mb:128"
    e = prod.production_env(base={"PYTORCH_CUDA_ALLOC_CONF": user},
                            tcmalloc=False)
    conf = e["PYTORCH_CUDA_ALLOC_CONF"].split(",")
    assert "expandable_segments:False" in conf
    assert "expandable_segments:True" not in conf
    assert "max_split_size_mb:128" in conf
    e = prod.production_env(
        base={"PYTORCH_CUDA_ALLOC_CONF": "max_split_size_mb:128"},
        tcmalloc=False)
    assert e["PYTORCH_CUDA_ALLOC_CONF"] == \
        "max_split_size_mb:128,expandable_segments:True"


def test_unrelated_env_preserved():
    e = prod.production_env(base={"PATH": "/bin", "HOME": "/home/user"},
                            tcmalloc=False)
    assert e["PATH"] == "/bin" and e["HOME"] == "/home/user"


def test_tcmalloc_preload_only_when_so_exists(tmp_path, monkeypatch):
    so = tmp_path / "libtcmalloc_minimal.so.4"
    # absent: no preload, no threshold
    monkeypatch.setattr(prod, "TCMALLOC_PATHS", (str(so),))
    e = prod.production_env(base={})
    assert "LD_PRELOAD" not in e
    assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in e
    # present: appended to an existing preload list, threshold set
    so.write_bytes(b"")
    e = prod.production_env(base={"LD_PRELOAD": "/lib/other.so"})
    assert e["LD_PRELOAD"] == f"/lib/other.so:{so}"
    assert e["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    # idempotent: already preloaded -> not duplicated
    e2 = prod.production_env(base={"LD_PRELOAD": e["LD_PRELOAD"]})
    assert e2["LD_PRELOAD"].count(str(so)) == 1


def test_reexec_guard_is_a_noop(monkeypatch):
    called = []
    monkeypatch.setattr(os, "execve", lambda *a, **k: called.append(a))
    monkeypatch.setenv(prod.GUARD_VAR, "1")
    prod.reexec_under_prod_env("repro_torch.launch.train", ["--rounds", "1"])
    assert called == []


def test_reexec_builds_module_argv(monkeypatch):
    called = []
    monkeypatch.setattr(os, "execve",
                        lambda path, argv, e: called.append((path, argv, e)))
    monkeypatch.delenv(prod.GUARD_VAR, raising=False)
    prod.reexec_under_prod_env("repro_torch.launch.train", ["--rounds", "1"],
                               tcmalloc=False)
    (path, argv, e), = called
    assert path == sys.executable
    assert argv == [sys.executable, "-m", "repro_torch.launch.train",
                    "--rounds", "1"]
    assert e[prod.GUARD_VAR] == "1"
    assert e["PYTORCH_CUDA_ALLOC_CONF"].startswith(
        os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""))


def test_launcher_prod_env_reexecs(monkeypatch, capsys):
    called = []
    monkeypatch.setattr(os, "execve",
                        lambda path, argv, e: called.append((argv, e)))
    monkeypatch.delenv(prod.GUARD_VAR, raising=False)
    train.main(["--prod-env", *ARGV])
    (argv, e), = called
    assert argv[1:] == ["-m", "repro_torch.launch.train", "--prod-env",
                        *ARGV]
    assert e[prod.GUARD_VAR] == "1"
    assert "expandable_segments" in e["PYTORCH_CUDA_ALLOC_CONF"]
    assert "comm summary" in capsys.readouterr().out


def _rounds(out):
    """The round lines without their seconds, and the summary."""
    lines = out.splitlines()
    rounds = [ln.rsplit(" ", 1)[0] for ln in lines
              if ln.startswith("  round ")]
    start = next(i for i, ln in enumerate(lines) if ln.startswith("total "))
    return rounds, json.loads("\n".join(lines[start + 1:]))


def test_torchrun_prod_env_client_shards(capsys):
    train.main(list(ARGV))
    want = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop(prod.GUARD_VAR, None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--prod-env", "--client-shards", "2", *ARGV],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    header = r.stdout.splitlines()[0]
    assert header == want.splitlines()[0] + " client_shards=2"
    assert r.stdout.count("comm summary") == 1          # rank 0 only
    assert _rounds(r.stdout) == _rounds(want)


def test_client_shards_without_torchrun_names_it(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--client-shards", "2", *ARGV])
