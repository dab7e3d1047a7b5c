"""The paper's hub round on VGG16: the port's main path, defined once.

VGG16 at full width (14,736,714 params), 8 clients each training 7 of
its 14 units per round with the ``uniform`` strategy, hub topology,
``cifar_like`` data split by ``iid_partition``, batch 32, 2 local steps.
``chip_smoke.py`` drives this federation and ``profile_round.py``
profiles it.  With ``n_registered`` set (the cohort engine) the loader
holds that many registered clients, each with one round's worth of
images (batch x local steps), and a round trains a cohort of 8 of them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .common import Device, resolve_device
from .core import FLConfig, Federation, ModelSpec
from .data import FederatedLoader, cifar_like, iid_partition
from .models import paper_models as pm

WIDTH = 1.0              # VGG16 at the paper's full width
N_CLIENTS = 8
N_TRAIN = 7              # of VGG16's 14 units: the paper's 50% setting
BATCH = 32
LOCAL_STEPS = 2


@functools.lru_cache(maxsize=2)
def _dataset(n_clients: int, eval_images: int):
    """``cifar_like`` images for ``n_clients`` shards of one round's worth
    each (plus ``eval_images`` held out) and the shards; cached, since a
    1,000-client fleet's 64,000 images take seconds to draw."""
    n = n_clients * BATCH * LOCAL_STEPS
    x_all, y_all = cifar_like(n + eval_images, key=0)
    return x_all, y_all, iid_partition(n, n_clients, key=1)


def build(device: Device = "cuda", *, eval_images: int = 0, strategy=None,
          hooks=(), incarnation: int = 0, **fl_overrides) -> Federation:
    """The main path's federation on ``device``.  With ``eval_images``
    it also holds out that many ``cifar_like`` images and evaluates
    accuracy on them after every round.  ``strategy`` overrides the
    selection with a registered name or an instance (``"score_weighted"``,
    a ``Replay``), and ``fl_overrides`` replace fields of its
    ``FLConfig`` (``packed=True, codec="qint8"`` runs the packed round
    with the int8 uplink codec; ``async_buffer``, ``n_registered`` /
    ``cohort_chunk``, ``faults`` switch the round engines on).
    ``hooks`` and ``incarnation`` go to the ``Federation`` (a
    ``Checkpointer``; the kill draw's restart count)."""
    dev = resolve_device(device)
    n_data = max(N_CLIENTS, fl_overrides.get("n_registered", 0))
    x_all, y_all, shards = _dataset(n_data, eval_images)
    n = n_data * BATCH * LOCAL_STEPS
    x, y = x_all[:n], y_all[:n]
    loader = FederatedLoader([{"x": x[s], "y": y[s]} for s in shards],
                             batch_size=BATCH, steps_per_round=LOCAL_STEPS,
                             key=0)
    eval_fn = None
    if eval_images:
        xt = torch.as_tensor(x_all[n:], device=dev)
        yt = torch.as_tensor(y_all[n:], device=dev)

        def eval_fn(p):
            return pm.accuracy(pm.vgg16_apply(p, xt, device=dev), yt)

    spec = ModelSpec("vgg16",
                     functools.partial(pm.init_vgg16, width_mult=WIDTH),
                     functools.partial(pm.vgg16_loss, device=dev),
                     pm.vgg16_units)
    fl = dataclasses.replace(
        FLConfig(n_clients=N_CLIENTS, n_train_units=N_TRAIN,
                 strategy="uniform", topology="hub"), **fl_overrides)
    return Federation.from_config(spec, fl, data=loader, device=dev,
                                  eval_fn=eval_fn, strategy=strategy,
                                  hooks=hooks, incarnation=incarnation)
