"""The port's training launcher and step builders against the
reference's ``launch/train.py`` and ``launch/steps.py``.

The launcher takes the reference's flags with their defaults, plus
``--device``; its ``--arch`` choices lack exactly the configs of the
families the port has not ported (none since the ``vlm`` family).  ``python -m repro_torch.launch.train
--reduced --device cpu`` prints the reference's header fields, with the
same values, and the same comm-summary keys.  The switches of unported
features raise ``NotPortedError``.  ``default_loss_kwargs`` and
``make_fl_round_step``'s unit assignment and ``FLConfig`` equal the
reference's.  ``make_prefill_step`` and ``make_decode_step`` give the
reference's logits (1e-4 abs, as ``test_torch_transformer.py``) on the
same reduced params and tokens, and ``launch/shapes.py`` annotates the
port's (arch, shape) pairs as the reference does.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.core.masking import LeafUnit as RLeafUnit
from repro.launch import shapes as r_shapes
from repro.launch import steps as r_steps
from repro.launch import train as r_train
from repro.models import get_model as r_get_model
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import from_reference
from repro_torch.core import NotPortedError
from repro_torch.launch import shapes, steps, train
from repro_torch.models import _FAMILY, get_model, transformer

ARGV = ["--reduced", "--clients", "2", "--rounds", "2", "--batch-size", "2",
        "--steps-per-round", "1", "--seq", "32"]


class _Parsed(Exception):
    pass


@pytest.fixture(scope="module")
def ref_parser():
    """The reference builds its parser inside ``main``: stop it there."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        with pytest.raises(_Parsed) as e:
            r_train.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return e.value.args[0]


def _options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_flags_match_reference(ref_parser):
    ref, port = _options(ref_parser), _options(train.build_parser())
    assert set(port) == set(ref) | {"device"}
    assert port["device"].default == "cuda"
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert type(b) is type(a), dest
        assert b.type == a.type, dest
        if dest != "arch":
            assert b.choices == a.choices, dest


def test_arch_choices_lack_exactly_the_unported_families(ref_parser):
    ref = set(_options(ref_parser)["arch"].choices)
    port = set(_options(train.build_parser())["arch"].choices)
    assert port == set(list_configs()) and port <= ref
    assert ref - port == {n for n in ref
                          if r_get_config(n).family not in _FAMILY}
    for name in ref - port:        # the port registers no config it can't run
        assert r_get_config(name).family not in _FAMILY


def _header(out):
    line = next(x for x in out.splitlines() if x.startswith("arch="))
    return dict(tok.split("=", 1) for tok in line.split())


def _summary(out):
    return json.loads(out[out.index("comm summary:\n") + 14:
                          out.rindex("}") + 1])


def test_cpu_run_prints_reference_fields(capsys, monkeypatch):
    env = dict(os.environ, PYTHONPATH="src")
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *ARGV], capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert got.returncode == 0, got.stderr[-2000:]
    monkeypatch.setattr(sys, "argv", ["train", *ARGV])
    r_train.main()
    want = capsys.readouterr().out
    assert _header(got.stdout) == _header(want)
    assert "total " in got.stdout
    assert got.stdout.count("  round ") == 2
    g, w = _summary(got.stdout), _summary(want)
    assert set(g) == set(w)
    assert g["avg_uplink_bytes"] > 0 and 0 < g["reduction_vs_full"] < 1


@pytest.mark.parametrize("extra,match", [
    (["--client-shards", "2"], "client_shards"),
    (["--prod-env"], "launch/env.py"),
    (["--arch", "internvl2-26b"], None)])
def test_unported_switches_raise(extra, match):
    if match is None:                 # a ported family's arch is accepted
        args = train.build_parser().parse_args(["--device", "cpu", *ARGV,
                                                *extra])
        assert args.arch == "internvl2-26b"
        api = get_model(get_config(args.arch))
        assert api.forward.__code__ is get_model(
            get_config("qwen3-1.7b")).forward.__code__
        assert _FAMILY["vlm"] is transformer
        return
    with pytest.raises(NotPortedError, match=match):
        train.main(["--device", "cpu", *ARGV, *extra])


@pytest.mark.parametrize("arch", sorted(list_configs()))
@pytest.mark.parametrize("remat,unroll", [(True, False), (False, True)])
def test_default_loss_kwargs_match_reference(arch, remat, unroll):
    assert steps.default_loss_kwargs(get_config(arch), remat=remat,
                                     unroll=unroll) == \
        r_steps.default_loss_kwargs(r_get_config(arch), remat=remat,
                                    unroll=unroll)


@pytest.mark.parametrize("arch,topology", [("qwen3-1.7b", "hub"),
                                           ("gemma3-12b", "hierarchical")])
def test_fl_round_step_assign_and_config_match_reference(arch, topology):
    """At full width: the port reads its leaf shapes off ``meta``
    params, the reference off ``jax.eval_shape``."""
    kw = dict(n_clients=4, train_fraction=0.25, strategy="uniform",
              lr=1e-3, topology=topology)
    _, rassign, rfl = r_steps.make_fl_round_step(r_get_config(arch), **kw)
    step, assign, fl = steps.make_fl_round_step(get_config(arch),
                                                device="cpu", **kw)
    assert callable(step)
    assert (assign.n_units, assign.unit_names) == \
        (rassign.n_units, rassign.unit_names)
    r_units = jax.tree_util.tree_leaves(
        rassign.leaf_units, is_leaf=lambda x: isinstance(x, RLeafUnit))
    assert [tuple(u) for u in assign.leaf_units.values()] == \
        [tuple(u) for u in r_units]
    want = dataclasses.asdict(rfl)
    got = dataclasses.asdict(fl)
    assert set(got) == set(want)
    assert got == want
    assert np.isclose(fl.resolve_n_train(assign.n_units),
                      rfl.resolve_n_train(rassign.n_units))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "hymba-1.5b"])
def test_prefill_and_decode_steps_match_reference(arch):
    """Reduced params drawn by the reference, the same tokens: the
    prefill step's last-token logits and two decode steps' logits."""
    rcfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    rp = r_get_model(rcfg).init_params(jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, rp))
    r_shape = dataclasses.replace(r_shapes.SHAPES["prefill_32k"], seq_len=32)
    shape = dataclasses.replace(shapes.SHAPES["prefill_32k"], seq_len=32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 20), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab, (2, 2), dtype=np.int32)
    rlog, rc = r_steps.make_prefill_step(
        rcfg, r_shape, r_steps.default_loss_kwargs(rcfg))(
            rp, {"tokens": jnp.asarray(toks)})
    tlog, tc = steps.make_prefill_step(
        cfg, shape, steps.default_loss_kwargs(cfg))(
            tp, {"tokens": torch.as_tensor(toks)})
    assert tuple(tlog.shape) == tuple(rlog.shape)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), atol=1e-4,
                               rtol=0, err_msg="prefill logits")
    r_dec, t_dec = r_steps.make_decode_step(rcfg), steps.make_decode_step(cfg)
    for i, t in enumerate(feed.T):
        rlog, rc = r_dec(rp, rc, jnp.asarray(t[:, None]))
        tlog, tc = t_dec(tp, tc, torch.as_tensor(t[:, None]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), atol=1e-4,
                                   rtol=0, err_msg=f"decode step {i}")


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_shapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_OK == r_shapes.LONG_CONTEXT_OK
    ported = set(list_configs())
    want = [x for x in r_shapes.list_pairs() if x[0] in ported]
    assert sorted(shapes.list_pairs()) == sorted(want)
    for arch in ported:
        for name, shape in shapes.SHAPES.items():
            assert shapes.shape_applicable(arch, get_config(arch), shape) == \
                r_shapes.shape_applicable(arch, r_get_config(arch),
                                          r_shapes.SHAPES[name])
