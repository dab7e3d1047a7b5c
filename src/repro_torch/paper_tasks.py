"""The paper's other two tasks, CASA and IMDB (its Fig. 3), defined once.

    PYTHONPATH=src python -m repro_torch.paper_tasks --task casa|imdb
        [--train N] [--rounds R] [--topology hub] [--device cpu]

prints the held-out accuracy after every round: the port's Fig. 3.
The federations are those of ``benchmarks/fig3_casa_imdb.py`` at its
full settings, 10 clients each, batch 16, 2 local steps, Adam at lr
3e-3, ``uniform`` selection:

* ``casa`` — the CASA HAR LSTM (68,962 params, 6 units) over 10 homes
  of ``casa_like(10, key=0, min_samples=60, max_samples=240)``, one home
  per client (non-IID by home); accuracy on the first 20 samples of
  every home.
* ``imdb`` — the IMDB CNN-LSTM (2,638,966 params, 4 units) on
  ``imdb_like(4000, key=0)`` split by ``iid_partition(4000, 10,
  key=1)``; accuracy on ``imdb_like(256, key=9)``.

``chip_smoke.py`` drives both on the card (``[paper-tasks]``) and
``profile_round.py --model casa|imdb`` profiles their rounds.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from .common import Device, resolve_device
from .core import FLConfig, Federation, ModelSpec
from .data import FederatedLoader, casa_like, iid_partition, imdb_like
from .models import paper_models as pm

TASKS = ("casa", "imdb")
N_CLIENTS = 10
BATCH = 16
LOCAL_STEPS = 2
LR = 3e-3
IMDB_DATA = 4000
# units trained per round by default: half of each model's (6 and 4)
N_TRAIN = {"casa": 3, "imdb": 2}
# spatial rank of the conv kernels (IMDB's conv1d; CASA has none)
CONV_SPATIAL = {"casa": 2, "imdb": 1}

_MODEL = {"casa": (pm.init_casa, pm.casa_apply, pm.casa_loss, pm.casa_units),
          "imdb": (pm.init_imdb, pm.imdb_apply, pm.imdb_loss, pm.imdb_units)}


def _data(task):
    """Per-client training shards and the held-out set (numpy)."""
    if task == "casa":
        homes = casa_like(N_CLIENTS, key=0, min_samples=60, max_samples=240)
        shards = [{"x": x, "y": y} for x, y in homes]
        held = (np.concatenate([x[:20] for x, _ in homes]),
                np.concatenate([y[:20] for _, y in homes]))
        return shards, held
    x, y = imdb_like(IMDB_DATA, key=0)
    shards = [{"x": x[s], "y": y[s]}
              for s in iid_partition(IMDB_DATA, N_CLIENTS, key=1)]
    return shards, imdb_like(256, key=9)


def build(task: str, device: Device = "cuda", *, n_train: int = 0,
          evaluate: bool = True, dtype=torch.float32, strategy=None,
          **fl_overrides) -> Federation:
    """The ``task`` federation on ``device``, training ``n_train`` units
    a round (``N_TRAIN[task]`` when 0).  With ``evaluate`` it reports
    held-out accuracy after every round.  ``dtype`` is the model's (the
    card-vs-CPU parity check runs it in float64), ``strategy`` overrides
    the selection (a ``Replay``), and ``fl_overrides`` replace fields of
    its ``FLConfig`` (``topology="hierarchical"``, ``n_edges=2``)."""
    if task not in _MODEL:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    dev = resolve_device(device)
    init, apply, loss, units = _MODEL[task]
    shards, (xt, yt) = _data(task)
    loader = FederatedLoader(shards, batch_size=BATCH,
                             steps_per_round=LOCAL_STEPS)
    eval_fn = None
    if evaluate:
        yt = torch.as_tensor(yt, device=dev)

        def eval_fn(p):
            return pm.accuracy(apply(p, xt, device=dev), yt)

    spec = ModelSpec(task, functools.partial(init, dtype=dtype),
                     functools.partial(loss, device=dev), units,
                     conv_spatial=CONV_SPATIAL[task])
    fl = dataclasses.replace(
        FLConfig(n_clients=N_CLIENTS, n_train_units=n_train or N_TRAIN[task],
                 lr=LR), **fl_overrides)
    return Federation.from_config(spec, fl, data=loader, device=dev,
                                  eval_fn=eval_fn,
                                  **({} if strategy is None
                                     else {"strategy": strategy}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", choices=TASKS, required=True)
    ap.add_argument("--train", type=int, default=0,
                    help="units trained per round (default: half)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--topology", default="hub")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    fed = build(a.task, a.device, n_train=a.train, topology=a.topology)
    print(f"# {a.task}: {fed.fl.n_train_units} of {fed.assign.n_units} "
          f"units a round, {a.topology}, {N_CLIENTS} clients")
    fed.fit(a.rounds, log_every=1)
    print("accuracy per round: " + "|".join(
        f"{r.eval_metric:.3f}" for r in fed.history))


if __name__ == "__main__":
    main()
