"""The port's numpy data pipeline is a verbatim copy: array-equal to the
reference for the same seeds."""
import numpy as np
import pytest

from repro.data import partition as rpart
from repro.data import synthetic as rsyn
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("n,key", [(16, 0), (33, 7)])
def test_cifar_like_equal(n, key):
    for a, b in zip(rsyn.cifar_like(n, key=key), tsyn.cifar_like(n, key=key)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_imdb_like_equal():
    for a, b in zip(rsyn.imdb_like(12, key=3, vocab=500),
                    tsyn.imdb_like(12, key=3, vocab=500)):
        np.testing.assert_array_equal(a, b)


def test_casa_like_equal():
    ra = rsyn.casa_like(3, key=2, min_samples=4, max_samples=9)
    ta = tsyn.casa_like(3, key=2, min_samples=4, max_samples=9)
    assert len(ra) == len(ta)
    for (rx, ry), (tx, ty) in zip(ra, ta):
        np.testing.assert_array_equal(rx, tx)
        np.testing.assert_array_equal(ry, ty)


@pytest.mark.parametrize("n,clients,key", [(48, 3, 1), (100, 8, 5)])
def test_iid_partition_equal(n, clients, key):
    for a, b in zip(rpart.iid_partition(n, clients, key=key),
                    tpart.iid_partition(n, clients, key=key)):
        np.testing.assert_array_equal(a, b)


def _loaders(batch_size, steps):
    x, y = rsyn.cifar_like(40, key=0)
    shards = rpart.iid_partition(40, 3, key=1)
    data = [{"x": x[s], "y": y[s]} for s in shards]
    data[2] = {k: v[:5] for k, v in data[2].items()}   # a short shard
    return (rpart.FederatedLoader(data, batch_size=batch_size,
                                  steps_per_round=steps, key=4),
            tpart.FederatedLoader(data, batch_size=batch_size,
                                  steps_per_round=steps, key=4))


@pytest.mark.parametrize("rnd", [0, 1, 5])
def test_round_batches_equal(rnd):
    ref, port = _loaders(batch_size=4, steps=2)
    rb, tb = ref.round_batches(rnd), port.round_batches(rnd)
    assert rb.keys() == tb.keys()
    for k in rb:
        np.testing.assert_array_equal(rb[k], tb[k])
    np.testing.assert_array_equal(ref.weights(), port.weights())


def test_client_batches_subset_equal():
    ref, port = _loaders(batch_size=3, steps=1)
    for k, v in ref.client_batches(2, [2, 0]).items():
        np.testing.assert_array_equal(v, port.client_batches(2, [2, 0])[k])
