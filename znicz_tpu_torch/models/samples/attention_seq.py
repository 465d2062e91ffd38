"""Sequence-classification sample for the attention family (port of
``znicz_tpu/models/samples/attention_seq.py``).

Task: each sample is a (T, D) sequence of noise with a marker added at
one position; the class is which third of the sequence holds the
marker.  Solving it needs mixing across positions, so a falling
validation error shows the attention unit training end to end.

At the default widths the head dim is 16 / 4 = 4, not a multiple of 8,
so the attention unit takes the plain attention core, as the reference
routes it, on the card and on the CPU alike::

    from znicz_tpu_torch.models.samples import attention_seq
    wf = attention_seq.build()
    wf.initialize()              # the card; device="cpu" on the host
    wf.run()
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

#: the reference sample's defaults, registered as ``root.attention_seq``
DEFAULTS = {
    "minibatch_size": 32,
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "n_heads": 4,
    "seq_len": 12,
    "features": 16,
    "n_classes": 3,
    "n_train": 384,
    "n_valid": 96,
    "max_epochs": 30,
    "seed": 9,
}
register_defaults("attention_seq", DEFAULTS)


def make_data(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(x (n, T, D) f32, labels (n,) int32)`` from ``cfg["seed"]`` (the
    reference's generator, so both packages see the same samples)."""
    rng = np.random.default_rng(cfg["seed"])
    n = cfg["n_train"] + cfg["n_valid"]
    t, d, n_classes = cfg["seq_len"], cfg["features"], cfg["n_classes"]
    span = t // n_classes
    x = rng.normal(0, 0.3, size=(n, t, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    for i in range(n):
        pos = y[i] * span + rng.integers(0, span)
        x[i, pos] += 2.0
    return x, y


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.attention_seq`` (``DEFAULTS``
    unless a config or ``--root`` set a leaf) updated by ``overrides``; a
    ``snapshotter_config`` override attaches a snapshotter."""
    cfg = {**root.attention_seq.as_dict(), **overrides}
    x, y = make_data(cfg)
    n_train = cfg["n_train"]
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"]}
    return StandardWorkflow(
        name="attention_seq",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[:n_train], train_labels=y[:n_train],
            valid_data=x[n_train:], valid_labels=y[n_train:],
            minibatch_size=cfg["minibatch_size"]),
        layers=[
            {"type": "attention", "->": {"n_heads": cfg["n_heads"]},
             "<-": gd_cfg},
            {"type": "softmax",
             "->": {"output_sample_shape": cfg["n_classes"]},
             "<-": gd_cfg},
        ],
        decision_config={"max_epochs": cfg["max_epochs"]},
        snapshotter_config=cfg.get("snapshotter_config"))


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``):
    the launcher passes ``load`` (construct or resume) and ``main``
    (initialize and train)."""
    load(build)
    main()
