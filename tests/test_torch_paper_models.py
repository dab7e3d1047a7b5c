"""The port's VGG16 against repro.models.paper_models on the same params
(through convert.from_reference) and the same numpy batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree_paths
from repro.data import cifar_like
from repro.models import paper_models as rpm
from repro_torch.common import param_count, tree_paths as t_tree_paths
from repro_torch.convert import from_reference, to_reference
from repro_torch.models import paper_models as pm

WIDTH = 0.125


@pytest.fixture(scope="module")
def setup():
    rp = rpm.init_vgg16(jax.random.PRNGKey(0), width_mult=WIDTH)
    np_params = jax.tree_util.tree_map(np.array, rp)
    x, y = cifar_like(4, key=3)
    return rp, np_params, x, y


def test_logits_match(setup):
    rp, np_params, x, _ = setup
    ref = np.asarray(rpm.vgg16_apply(rp, jnp.asarray(x)))
    got = pm.vgg16_apply(from_reference(np_params), x, device="cpu")
    # fp32 conv sums in another order, through 13 batch-stat BN layers
    # (measured ~1.5e-5 on logits of scale ~2)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4,
                               rtol=1e-4)


def test_grads_match(setup):
    rp, np_params, x, y = setup

    def rloss(p):
        return rpm.xent_loss(rpm.vgg16_apply(p, jnp.asarray(x)),
                             jnp.asarray(y))

    rloss_v, rgrads = jax.value_and_grad(rloss)(rp)
    ref = from_reference(jax.tree_util.tree_map(np.asarray, rgrads))
    tp = {k: v.requires_grad_(True) for k, v in
          from_reference(np_params).items()}
    loss = pm.xent_loss(pm.vgg16_apply(tp, x, device="cpu"),
                        torch.as_tensor(y))
    grads = torch.autograd.grad(loss, list(tp.values()), allow_unused=True)
    assert abs(loss.item() - float(rloss_v)) < 1e-5
    for (path, leaf), g in zip(tp.items(), grads):
        g = torch.zeros_like(leaf) if g is None else g
        # the same reordered fp32 sums, in gradients of scale up to ~6
        # (measured <= 5e-5); conv-bias grads are 0 up to that noise
        np.testing.assert_allclose(g.numpy(), ref[path].numpy(), atol=2e-4,
                                   rtol=1e-4, err_msg=path)


def test_param_count_full_width():
    p = pm.init_vgg16(torch.Generator().manual_seed(0), width_mult=1.0)
    assert param_count(p) == 14_736_714
    ref_shapes = jax.eval_shape(
        lambda k: rpm.init_vgg16(k, width_mult=1.0), jax.random.PRNGKey(0))
    ref = from_reference(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), ref_shapes))
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("width", [0.125, 0.5])
def test_leaf_and_unit_order(width):
    rp = jax.eval_shape(lambda k: rpm.init_vgg16(k, width_mult=width),
                        jax.random.PRNGKey(0))
    tp = pm.init_vgg16(torch.Generator().manual_seed(0), width_mult=width)
    # JAX's sorted-key order (conv10 before conv2) reaches every output
    assert t_tree_paths(tp) == tree_paths(rp)
    assert list(tp) == list(tree_paths(rp))
    assert pm.vgg16_units(tp) == rpm.vgg16_units(rp)


def test_convert_roundtrip(setup):
    _, np_params, _, _ = setup
    back = to_reference(from_reference(np_params))
    flat_a = dict(zip(tree_paths(np_params),
                      jax.tree_util.tree_leaves(np_params)))
    flat_b = dict(zip(tree_paths(back), jax.tree_util.tree_leaves(back)))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def test_xent_and_accuracy_match():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    np.testing.assert_allclose(
        float(pm.xent_loss(torch.as_tensor(logits), torch.as_tensor(labels))),
        float(rpm.xent_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert float(pm.accuracy(torch.as_tensor(logits),
                             torch.as_tensor(labels))) == \
        float(rpm.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_apply_needs_gpu_by_default(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, np_params, x, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.vgg16_apply(from_reference(np_params), x)
