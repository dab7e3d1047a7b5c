"""The port's ``launch/mesh.py`` and the client-axis byte formulas.

Mesh builders on a ``fake`` process group (a subprocess of 512 ranks:
no group in this process): the shapes and axis names of the reference's
``tests/test_sharding.py`` and ``make_hier_fl_mesh``'s view, and every
error text of ``tests/test_mesh_errors.py`` with the world size as the
visible count (the indivisible-cohort message as the reference's
``launch/mesh.py`` words it).  ``shard_over_clients`` over 2 gloo ranks
on the CPU is bitwise the plain call, also with an empty block.
``collective_round_bytes`` / ``expected_uplink_fraction`` equal the
reference's exactly on random selections.
"""
import numpy as np
import pytest
import torch

from repro.core import comm as rcomm
from repro_torch.core import comm
from repro_torch.launch import mesh

import torch_ranks

WORLD = 512


@pytest.fixture(scope="module")
def report():
    return torch_ranks.fake_run("fake_meshes", WORLD, rank=300)


def test_nearest_valid_brackets_the_request():
    assert mesh._nearest_valid(16, 5) == "4 or 8"
    assert mesh._nearest_valid(16, 3) == "2 or 4"
    assert mesh._nearest_valid(16, 1) == "2"
    assert mesh._nearest_valid(16, 16) == "8"
    assert mesh._nearest_valid(1, 1) == "none"


@pytest.mark.parametrize("call,names,shape", [
    ("production", ("data", "model"), (16, 16)),
    ("production multi_pod", ("pod", "data", "model"), (2, 16, 16)),
    ("fl 16", ("client", "data", "model"), (16, 1, 16)),
    ("fl 16 multi_pod", ("client", "data", "model"), (16, 2, 16)),
    ("hier 4 16", ("edge", "client", "data", "model"), (4, 4, 1, 16)),
    ("client 4", ("client",), (4,)),
])
def test_mesh_shapes(report, call, names, shape):
    got = report[call]
    assert got[:2] == (names, shape)
    # rank 300 lies past the first 256 ranks of a one-pod view
    size = int(np.prod(shape))
    assert (got[2] is None) == (300 >= size)


def test_no_process_group_names_init():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.world_size()


@pytest.mark.parametrize("call,parts", [
    ("fl 5", ("client axis 5", "16-way", f"{WORLD} devices visible",
              "nearest valid cohort sizes: 4 or 8")),
    ("fl 3 multi_pod", ("must fill the 2 pods evenly", "requested 3 clients",
                        "2 or 4")),
    ("hier 3 4", ("edge axis 3 must divide the 4 clients",
                  "nearest valid edge counts", "2 or 4")),
    ("hier 0 4", ("edge axis 0",)),
    ("hier 1 3", ("client axis 3", "nearest valid cohort sizes: 2 or 4")),
    ("client 0", ("client_shards=0", f"between 1 and {WORLD}",
                  f"({WORLD} visible)")),
    ("client -1", ("client_shards=-1", f"between 1 and {WORLD}")),
    ("client world+1", (f"client_shards={WORLD + 1}",
                        f"between 1 and {WORLD}")),
    ("shard 3 of 4", ("client_shards=3 must divide the cohort of 4 clients",
                      "valid shard counts here: [1, 2, 4]")),
])
def test_mesh_errors(report, call, parts):
    msg = report[call]
    assert isinstance(msg, str), msg
    for part in parts:
        assert part in msg, (part, msg)


def test_client_block():
    assert [mesh.client_block(r, 2, 8) for r in range(2)] == [(0, 4), (4, 8)]
    assert [mesh.client_block(r, 2, 1) for r in range(2)] == [(0, 1), (1, 1)]
    assert [mesh.client_block(r, 3, 7) for r in range(3)] == [
        (0, 3), (3, 5), (5, 7)]


def test_shard_over_clients_bitwise(tmp_path):
    for got, want, one, want_one in torch_ranks.spawn(
            "shard_over_clients_case", 2, tmp_path):
        for g, w in ((got, want), (one, want_one)):
            assert torch.equal(g["a"], w["a"])
            assert all(torch.equal(x, y) for x, y in zip(g["b"], w["b"]))


@pytest.mark.parametrize("c,u,sync", [(4, 14, False), (8, 30, True),
                                      (10, 6, False)])
def test_collective_bytes_equal_reference(c, u, sync):
    rng = np.random.default_rng(c * u)
    ub = rng.integers(1, 10_000, u).astype(np.float64) * 4
    for _ in range(5):
        sel = (rng.random((c, u)) < 0.4).astype(np.float32)
        if sync:
            sel[:] = sel[0]
        assert comm.collective_round_bytes(sel, ub) == \
            rcomm.collective_round_bytes(sel, ub)
    for n_train in range(1, u + 1):
        assert comm.expected_uplink_fraction(u, n_train) == \
            rcomm.expected_uplink_fraction(u, n_train)
