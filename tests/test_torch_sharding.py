"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro.sharding``: every registered config, every param path
and every layout, on the single-pod, 2-pod and FL mesh shapes, equal to
``tuple(reference spec_for(...))``; the reference gets a shape-only
mesh stand-in (its rules read ``mesh.shape`` only) and its own
``params_sds`` shapes, the port its ``meta``-device params, whose
shapes must equal them.  ``validate_specs`` is empty on the production
mesh for every config, the big archs are more than 90% sharded, and the
reference's rule-engine cases hold.  ``placements`` is checked on a
``fake`` process group of 256 and 512 ranks (a subprocess: no group in
this process): a DTensor's local shape is each dim over the product of
its mesh axes, and its offset walks those axes major to minor in the
spec's order.  Exact throughout.
"""
import types

import numpy as np
import pytest

from repro.configs.base import get_config as r_get_config
from repro.launch import specs as rspecs
from repro.sharding import rules as rrules
from repro_torch.common import flatten
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch import specs
from repro_torch.sharding import (layout_for, params_specs, placements,
                                  spec_for, validate_specs)
from repro_torch.sharding import rules

import torch_ranks

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "fl": {"client": 16, "data": 1, "model": 16},
}
BIG = ("qwen2.5-14b", "gemma3-12b", "internvl2-26b",
       "llama4-maverick-400b-a17b")


def _stand_in(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


@pytest.fixture(scope="module")
def shapes():
    """Per config: the reference's params_sds shapes by path, and the
    port's meta params."""
    out = {}
    for name in list_configs():
        ref = {p: tuple(x.shape) for p, x in flatten(
            rspecs.params_sds(r_get_config(name))).items()}
        out[name] = (ref, specs.params_sds(get_config(name)))
    return out


def test_tables_are_the_references():
    assert rules._RULES == rrules._RULES
    assert rules._LOGICAL_TO_MESH == rrules._LOGICAL_TO_MESH


@pytest.mark.parametrize("name", sorted(list_configs()))
def test_specs_equal_reference(shapes, name):
    ref, meta = shapes[name]
    assert {p: tuple(x.shape) for p, x in meta.items()} == ref
    n = 0
    for mesh_name in MESHES:
        mesh = _stand_in(mesh_name)
        lead_cases = [()]
        if mesh_name == "fl":
            lead_cases.append(("client",))
        for layout in rules._LOGICAL_TO_MESH:
            for lead in lead_cases:
                for path, shape in ref.items():
                    shape = (16,) * len(lead) + shape
                    want = tuple(rrules.spec_for(path, shape, layout, mesh,
                                                 lead))
                    got = spec_for(path, shape, layout, mesh, lead)
                    assert got == want, (mesh_name, layout, lead, path)
                    n += 1
    assert n == len(ref) * 6 * 4


@pytest.mark.parametrize("name", sorted(list_configs()))
def test_validate_specs_empty(shapes, name):
    _, meta = shapes[name]
    for mesh_name in ("single", "multi"):
        mesh = _stand_in(mesh_name)
        sp = params_specs(meta, layout_for(get_config(name)), mesh)
        assert validate_specs(meta, sp, mesh) == []


@pytest.mark.parametrize("name", BIG)
def test_big_archs_mostly_sharded(shapes, name):
    """>90% of the params of every >=10B arch shard on the production
    mesh, as the reference's test counts them."""
    _, meta = shapes[name]
    mesh = _stand_in("single")
    sp = params_specs(meta, layout_for(get_config(name)), mesh)
    total = sharded = 0
    for p, x in meta.items():
        n = x.numel()
        total += n
        axes = []
        for a in sp[p]:
            axes += list(a) if isinstance(a, tuple) else [a]
        if "model" in axes or "data" in axes:
            sharded += n
    assert sharded / total > 0.90, f"{name}: {sharded / total:.2%}"


def test_rule_engine_basics():
    """The reference's own cases, on a 4 x 4 stand-in."""
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 4})
    assert spec_for("blocks/sub0/attn/wq", (8, 512, 16, 64), "tp", mesh) \
        == (None, None, "model", None)
    # heads not divisible -> falls back to head_dim
    assert spec_for("blocks/sub0/attn/wq", (8, 512, 10, 64), "tp", mesh) \
        == (None, None, None, "model")
    # fsdp_tp shards d_model over data
    assert spec_for("blocks/sub0/mlp/w_up", (8, 512, 2048), "fsdp_tp",
                    mesh) == (None, "data", "model")
    # experts over model
    assert spec_for("blocks/sub1/moe/w_up", (8, 32, 512, 128), "tp",
                    mesh) == (None, "model", None, None)
    # unknown path -> replicated
    assert spec_for("something/else", (4, 4), "tp", mesh) == ()


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stand_in("multi")
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements((("data", "pod"),), mesh)


def _want(shape, spec, coord, sizes):
    """The reference's placement: dim d split over its axes major to
    minor in the spec's order."""
    local, offset = [], []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        axes = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
        k, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            k *= sizes[a]
        local.append(n // k)
        offset.append(idx * (n // k))
    return tuple(local), tuple(offset)


@pytest.fixture(scope="module")
def fake_shards(shapes):
    """Local shapes under fake groups of 256 and 512 ranks (one process
    each, side by side): qwen2.5-14b in ``fsdp_tp`` and ``fsdp_only`` (a
    dim over ("data", "model")) and llama4's experts."""
    out = {}
    calls = []
    for world, rank in ((256, 37), (512, 300)):
        mesh = _stand_in("multi" if world == 512 else "single")
        cases = []
        for name, layout in (("qwen2.5-14b", "fsdp_tp"),
                             ("qwen2.5-14b", "fsdp_only"),
                             ("llama4-maverick-400b-a17b", "fsdp_tp")):
            _, meta = shapes[name]
            for p, x in meta.items():
                cases.append((list(x.shape),
                              spec_for(p, x.shape, layout, mesh)))
        out[world] = cases
        calls.append(("fake_local_shapes", world, rank, {"cases": cases}))
    for (_, world, _, _), got in zip(calls,
                                     torch_ranks.fake_runs(calls)):
        out[world] = (out[world], got)
    return out


@pytest.mark.parametrize("world", [256, 512])
def test_local_shards_on_a_fake_mesh(fake_shards, world):
    """Under a fake group of 256 (512) ranks, placements on the production
    mesh give each rank the block the spec names."""
    cases, got = fake_shards[world]
    assert any(isinstance(a, tuple) for _, s in cases for a in s)
    for (shape, spec), res in zip(cases, got["cases"]):
        assert res == _want(shape, spec, got["coord"], got["sizes"]), spec
    assert np.prod(list(got["sizes"].values())) == world
