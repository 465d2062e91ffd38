"""A workflow module for the two-process command-line test:
``python -m znicz_tpu_torch tests/torch_dist_workflow.py -b cpu
--listen|--master HOST:PORT --nodes 2 --process-id I``.

The reference tests' blobs MLP with a snapshotter into
``root.dist.snapshots``; with ``--root dist.model_parallel=True`` its
hidden layer is a column-parallel and row-parallel pair (tensor
parallelism over ``--n-model``'s axis, whole layers on one process).
After training, each process pickles what the test compares (its
parameters, its snapshotter's destination, whether it wrote a snapshot
itself) into ``root.dist.out``/``rank<I>.pkl``.  It imports only numpy
and the port.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.parallel.distributed import process_info
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("dist", {"max_epochs": 2, "snapshots": ".", "out": "."})


def blobs(n_per_class=40, n_classes=3, dim=12, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, size=(n_classes, dim))
    data = np.concatenate([
        centers[c] + 0.35 * rng.normal(size=(n_per_class, dim))
        for c in range(n_classes)]).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), n_per_class).astype(np.int32)
    order = rng.permutation(len(data))
    return data[order], labels[order]


def build() -> StandardWorkflow:
    data, labels = blobs()
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9}
    hidden = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
               "<-": gd}]
    if root.dist.get("model_parallel", False):
        hidden = [{"type": "all2all_tanh",
                   "->": {"output_sample_shape": 16,
                          "model_parallel": "column"}, "<-": gd},
                  {"type": "all2all_tanh",
                   "->": {"output_sample_shape": 16,
                          "model_parallel": "row"}, "<-": gd}]
    wf = StandardWorkflow(
        name="dist",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=24),
        layers=hidden + [{"type": "softmax",
                          "->": {"output_sample_shape": 3}, "<-": gd}],
        decision_config={"max_epochs": int(root.dist.max_epochs)},
        snapshotter_config={"prefix": "dist",
                            "directory": str(root.dist.snapshots),
                            "keep_last": 0})
    wf._max_fires = 100_000
    return wf


def run(load, main):
    wf, _ = load(build)
    main()
    rank, count = process_info()
    params = [fwd.full_tensor(name, getattr(fwd, name)).detach().cpu()
              .numpy()
              for fwd in wf.forwards for name in fwd.EXPORT_PARAMS]
    wrote = metrics.snapshot_seconds("save").count
    with open(os.path.join(str(root.dist.out), f"rank{rank}.pkl"),
              "wb") as f:
        pickle.dump({"params": params, "count": count,
                     "destination": wf.snapshotter.destination,
                     "wrote": wrote,
                     "epoch": wf.loader.epoch_number,
                     "device": repr(wf.device)}, f)
