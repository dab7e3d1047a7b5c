"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device against the reference's: parameter counts, depth variants, shape
skips, matmul FLOPs of a step, the record's keys; and the port's own
counts (argument bytes, attention's allowed pairs, placements) held to
direct computations on real tensors."""
import ast
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.launch import specs as ref_specs
from repro.launch import steps as ref_steps
from repro.launch.shapes import InputShape as RefShape
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch import dryrun, roofline, specs, steps
from repro_torch.launch.shapes import SHAPES, InputShape


def _import_ref_dryrun():
    """The reference's dry-run module sets XLA_FLAGS (512 host devices)
    when imported; keep that out of this process's environment."""
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref_dryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return ref_dryrun


REF = _import_ref_dryrun()
ARCHS = list_configs()


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's ``param_counts`` of every registered config."""
    return {a: REF.param_counts(ref_config(a),
                                ref_specs.params_sds(ref_config(a)))
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch, ref_counts):
    cfg = get_config(arch)
    assert dryrun.param_counts(cfg, specs.params_sds(cfg)) == \
        ref_counts[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variants_equal_reference(arch):
    got = dryrun.depth_variants(get_config(arch))
    want = REF.depth_variants(ref_config(arch))
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert (g.n_layers, g.n_enc_layers) == (w.n_layers, w.n_enc_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_skips_equal_reference(arch):
    from repro.launch.shapes import shape_applicable as ref_applicable
    for name, shape in SHAPES.items():
        ok, _ = ref_applicable(arch, ref_config(arch), shape)
        rec = dryrun.run_dryrun(arch, name, lower_only=True)
        if ok:
            assert rec["skipped"] is False
        else:          # the reference returns before it builds a mesh
            assert rec == REF.run_dryrun(arch, name)


def _dot_flops(jaxpr) -> int:
    """2 x MACs of every dot_general, through nested jaxprs, a scan body
    times its trip count."""
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (_, rc), (_, rb) = e.params["dimension_numbers"]
            ls, rs = e.invars[0].aval.shape, e.invars[1].aval.shape
            rfree = [d for i, d in enumerate(rs) if i not in rc + rb]
            total += 2 * int(np.prod(ls, dtype=np.int64)) * \
                int(np.prod(rfree, dtype=np.int64))
        mult = e.params.get("length", 1) if e.primitive.name == "scan" else 1
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += mult * _dot_flops(inner)
    return total


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b",
                                  "stablelm-3b", "granite-moe-1b-a400m"])
def test_prefill_matmul_flops_equal_reference_jaxpr(arch):
    """Both sides materialize the full score matrix (attn_impl reference),
    so FlopCounterMode's count is the reference's dot_general FLOPs."""
    kw = {"attn_impl": "reference"}
    rcfg = ref_config(arch).reduced()
    rshape = RefShape("p", 64, 2, "prefill")
    fn = ref_steps.make_prefill_step(rcfg, rshape, loss_kwargs=kw)
    closed = jax.make_jaxpr(fn)(
        ref_specs.params_sds(rcfg, jnp.float32),
        ref_specs.batch_specs(rcfg, rshape, jnp.float32))
    cfg = get_config(arch).reduced()
    shape = InputShape("p", 64, 2, "prefill")
    step = steps.make_prefill_step(cfg, shape, loss_kwargs=kw)
    _, counts = dryrun.count_step(step, (
        specs.params_sds(cfg, torch.float32),
        dryrun._meta(specs.batch_specs(cfg, shape, torch.float32))))
    assert counts.attention_flops == 0
    assert counts.flops == _dot_flops(closed.jaxpr)


def _ref_record_keys():
    """Top-level and cost_analysis keys the reference's run_dryrun
    writes on a full run, read off its source: the ``record`` literal,
    ``record[...] =`` stores and ``record.update({...})`` calls."""
    tree = ast.parse(inspect.getsource(REF.run_dryrun))
    dicts = []
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and \
                getattr(node.target, "id", "") == "record":
            dicts.append(node.value)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and \
                getattr(node.func.value, "id", "") == "record":
            dicts += [a for a in node.args if isinstance(a, ast.Dict)]
    top = {node.slice.value for node in ast.walk(tree)
           if isinstance(node, ast.Subscript) and
           getattr(node.value, "id", "") == "record" and
           isinstance(node.ctx, ast.Store)}
    cost = set()
    for d in dicts:
        keys = [k.value for k in d.keys]
        top.update(keys)
        if "cost_analysis" in keys:
            cost.update(k.value for k in
                        d.values[keys.index("cost_analysis")].keys)
    return top, cost


def test_record_keys_equal_reference_up_to_renames():
    top, cost = _ref_record_keys()
    rec = dryrun.run_dryrun(get_config("qwen3-1.7b").reduced(), "train_4k",
                            batch=1, verbose=False)
    want = {dryrun.RENAMED_KEYS.get(k, k) for k in top} - {None} | \
        set(dryrun.ADDED_KEYS)
    assert set(rec) == want
    want_cost = {dryrun.RENAMED_COST_KEYS.get(k, k) for k in cost} - {None}
    assert set(rec["cost_analysis"]) == want_cost
    assert set(rec["collective_bytes"]) == set(REF.roofline.collective_bytes(
        ""))


def test_train_argument_bytes_equal_real_tensors():
    from repro_torch.data import lm_batch
    from repro_torch.models import get_model
    from repro_torch.optim.masked import adam_init
    cfg = get_config("qwen3-1.7b").reduced()
    rec = dryrun.run_dryrun(cfg, InputShape("t", 64, 2, "train"),
                            skip_accounting=True, verbose=False)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0))
    opt = adam_init(params)
    batch = {k: torch.as_tensor(v) for k, v in
             lm_batch(2, 64, cfg.vocab).items()}
    real = sum(x.nbytes for tree in (params, opt.mu, opt.nu, batch)
               for x in tree.values())
    assert rec["memory_analysis"]["argument_size_in_bytes"] == real
    assert rec["fits_hbm_80gb"]


def test_meta_attention_takes_the_kernel_route_and_counts_pairs():
    """Past 512 tokens attention runs where K5/K6 would: the count adds
    each layer's forward twice (remat recomputes it) and backward once."""
    cfg = get_config("qwen3-1.7b").reduced()
    s = 1024
    rec = dryrun.run_dryrun(cfg, InputShape("t", s, 1, "train"),
                            verbose=False)
    w = roofline.attention_work(1, s, s, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, True, 0)
    want = cfg.n_layers * (2 * w["fwd"][0] + w["bwd"][0])
    assert rec["cost_analysis"]["attention"]["flops"] == want
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["model_flops_global"] == roofline.model_flops(
        cfg, rec["n_params"], rec["n_params_active"], s, train=True)


@pytest.mark.parametrize("arch,shape,kw", [
    ("qwen3-1.7b", "prefill_32k", {}),
    ("gemma3-12b", "decode_32k", {}),
    ("rwkv6-3b", "decode_32k", {}),
    ("qwen3-1.7b", "train_4k", {"step_kind": "fl_round"}),
    ("qwen3-1.7b", "train_4k", {"step_kind": "fl_round",
                                "fl_topology": "hierarchical"}),
    ("qwen3-1.7b", "train_4k", {"step_kind": "fl_round",
                                "fl_topology": "gossip"}),
    ("qwen3-1.7b", "train_4k", {"step_kind": "fl_round",
                                "fl_strategy": "score_weighted"}),
    ("qwen3-1.7b", "train_4k", {"step_kind": "fl_round",
                                "fl_async_buffer": 2})])
def test_every_step_kind_runs_on_meta(arch, shape, kw):
    cfg = get_config(arch).reduced()
    sh = dataclasses.replace(SHAPES[shape], seq_len=64, global_batch=4)
    rec = dryrun.run_dryrun(cfg, sh, verbose=False, **kw)
    ca = rec["cost_analysis"]
    # the flush is index copies and adds: bytes, no matmul
    assert ca["bytes_per_device"] > 0 and (
        ca["flops_per_device"] > 0) != bool(kw.get("fl_async_buffer"))
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["chips"] == 1 and rec["collective_bytes"]["total"] == 0
    if kw.get("step_kind") == "fl_round":
        assert rec["fl"]["n_clients"] == cfg.fl_clients_single_pod


def test_single_mesh_counts_from_placements():
    from repro_torch.sharding import params_specs
    cfg = get_config("qwen3-1.7b").reduced()
    sh = InputShape("t", 64, 32, "train")
    one = dryrun.run_dryrun(cfg, sh, verbose=False)
    rec = dryrun.run_dryrun(cfg, sh, mesh="single", verbose=False)
    assert rec["chips"] == 256 and rec["per_device"] == "placements"
    sizes = dryrun.MESHES["single"]
    pspecs = params_specs(specs.params_sds(cfg), rec["layout"],
                          dryrun._Mesh(sizes))
    per_leaf = sum(x.numel() * 4 / dryrun._shards(pspecs[p], sizes)
                   for p, x in specs.params_sds(cfg).items())
    batch = 2 * 32 * 64 * 4 / 16                  # tokens + labels / data
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        3 * per_leaf + batch
    split = dryrun._compute_split(rec["layout"], sizes)
    assert rec["cost_analysis"]["flops_per_device"] == \
        one["cost_analysis"]["flops_per_device"] / split
    assert rec["collective_bytes"]["total"] > 0
    assert rec["collective_bytes"]["total"] == sum(
        v for k, v in rec["collective_bytes"].items() if k != "total")


def test_cli_writes_a_record_equal_to_reference_counts(tmp_path,
                                                        ref_counts):
    rec = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                       "--batch", "1", "--out", str(tmp_path)])
    path = tmp_path / "qwen3-1.7b_train_4k_one.json"
    on_disk = json.loads(path.read_text())
    assert on_disk["n_params"] == ref_counts["qwen3-1.7b"]["total"]
    assert on_disk["n_params_active"] == ref_counts["qwen3-1.7b"]["active"]
    c = ref_counts["qwen3-1.7b"]
    assert on_disk["model_flops_global"] == REF.roofline.model_flops(
        None, c["total"], c["active"], 4096, train=True)
    assert on_disk["roofline"] == rec["roofline"]
    assert rec["mesh"] == "1" and rec["chips"] == 1
