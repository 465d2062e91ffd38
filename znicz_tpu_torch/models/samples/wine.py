"""Wine, the "hello world" MLP (port of
``znicz_tpu/models/samples/wine.py``).

13 → 8 (tanh) → 3 (softmax), trained by plain SGD (lr 0.3) on
minibatches of 10: the first 150 samples train, the other 28 validate.
The data is the UCI Wine set that scikit-learn bundles
(:func:`~znicz_tpu_torch.datasets.load_wine`, standardized), or its
synthetic stand-in where scikit-learn is not installed.  ``root.wine``
holds the defaults; ``wine_config.py`` beside it is the reference's
config module (``python -m znicz_tpu_torch wine wine_config``).  A
``snapshotter_config``, ``lr_adjuster_config`` or ``evaluator_config``
leaf is passed to the workflow::

    python -m znicz_tpu_torch wine -b cpu
    python -m znicz_tpu_torch wine --root 'wine.lr_adjuster_config={"lr_policy": ("exp", {"gamma": 0.99})}'
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("wine", {
    "minibatch_size": 10,
    "learning_rate": 0.3,
    "layers": [8],
    "max_epochs": 50,
})

def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.wine`` updated by
    ``overrides``."""
    cfg = dict(root.wine.as_dict())
    cfg.update(overrides)
    wf_kwargs = {k: cfg.pop(k) for k in ("snapshotter_config",
                                         "lr_adjuster_config",
                                         "evaluator_config")
                 if k in cfg}
    data, labels = datasets.load_wine()
    n_train = 150
    layers = [
        {"type": "all2all_tanh",
         "->": {"output_sample_shape": n},
         "<-": {"learning_rate": cfg["learning_rate"]}}
        for n in cfg["layers"]
    ] + [{"type": "softmax", "->": {"output_sample_shape": 3},
          "<-": {"learning_rate": cfg["learning_rate"]}}]
    wf = StandardWorkflow(
        name="wine",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:n_train], train_labels=labels[:n_train],
            valid_data=data[n_train:], valid_labels=labels[n_train:],
            minibatch_size=cfg["minibatch_size"]),
        layers=layers,
        decision_config={"max_epochs": cfg["max_epochs"]},
        **wf_kwargs)
    wf._max_fires = 10_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``):
    the launcher passes ``load`` (construct or resume) and ``main``
    (initialize and train)."""
    load(build)
    main()
