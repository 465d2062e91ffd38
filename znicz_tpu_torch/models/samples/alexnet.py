"""ImageNet AlexNet, the reference's flagship training workload (port of
``znicz_tpu/models/samples/alexnet.py``).

The canonical one-tower geometry on 227×227×3 input, unchanged:

.. code-block:: text

    conv 96 11×11 /4  + ReLU → LRN → maxpool 3×3 /2        (55→27)
    conv 256 5×5 p2   + ReLU → LRN → maxpool 3×3 /2        (27→13)
    conv 384 3×3 p1   + ReLU
    conv 384 3×3 p1   + ReLU
    conv 256 3×3 p1   + ReLU → maxpool 3×3 /2              (13→6)
    fc 4096 + ReLU → dropout 0.5
    fc 4096 + ReLU → dropout 0.5
    softmax 1000

trained by momentum SGD (lr 0.01, moment 0.9, weight decay 5e-4).  The
loader keeps uint8 synthetic frames of the exact geometry resident on
the device and normalizes each gathered batch to [−1, 1] in f32::

    from znicz_tpu_torch.models.samples import alexnet
    wf = alexnet.build()
    wf.initialize()          # the card
    for _ in range(10):
        wf.step()

``build(streaming_dir=...)`` trains from a class-per-subdirectory image
tree instead, through the streaming
:class:`~znicz_tpu_torch.loader.image.FileImageLoader` (the native
decode pool: resize 256, random 227 crops and flips on train; on the
card the pool must build, or the loader raises).  The :mod:`.imagenet`
sample is that path with its own defaults.
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

#: the reference sample's defaults, registered as ``root.alexnet``
DEFAULTS = {
    "minibatch_size": 128,
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "dropout": 0.5,
    "n_classes": 1000,
    "max_epochs": 90,
    "image_size": 227,
    "n_train_samples": 1024,   # synthetic-mode dataset size
    "n_valid_samples": 128,
}
register_defaults("alexnet", DEFAULTS)


def layers(cfg: dict) -> list[dict]:
    """The layer list of ``cfg`` (``DEFAULTS`` keys)."""
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"],
              "weights_decay": cfg["weights_decay"]}
    lrn = {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    pool = {"kx": 3, "ky": 3, "sliding": (2, 2)}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11, "sliding": (4, 4),
                "weights_stddev": 0.01}, "<-": gd_cfg},
        {"type": "norm", "->": dict(lrn)},
        {"type": "max_pooling", "->": dict(pool)},
        {"type": "conv_str",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5, "padding": 2,
                "weights_stddev": 0.01}, "<-": gd_cfg},
        {"type": "norm", "->": dict(lrn)},
        {"type": "max_pooling", "->": dict(pool)},
        {"type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": gd_cfg},
        {"type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": gd_cfg},
        {"type": "conv_str",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3, "padding": 1,
                "weights_stddev": 0.01}, "<-": gd_cfg},
        {"type": "max_pooling", "->": dict(pool)},
        {"type": "all2all_str",
         "->": {"output_sample_shape": 4096, "weights_stddev": 0.005},
         "<-": gd_cfg},
        {"type": "dropout", "->": {"dropout_ratio": cfg["dropout"]}},
        {"type": "all2all_str",
         "->": {"output_sample_shape": 4096, "weights_stddev": 0.005},
         "<-": gd_cfg},
        {"type": "dropout", "->": {"dropout_ratio": cfg["dropout"]}},
        {"type": "softmax",
         "->": {"output_sample_shape": cfg["n_classes"],
                "weights_stddev": 0.01}, "<-": gd_cfg},
    ]


def build(streaming_dir: str | None = None,
          **overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.alexnet`` (``DEFAULTS`` unless a
    config or ``--root`` set a leaf) updated by ``overrides``, fed from
    :func:`~znicz_tpu_torch.datasets.synthetic_imagenet`, or from the
    image tree ``streaming_dir`` (the validation share carved off by
    ``n_valid_samples / (n_train_samples + n_valid_samples)``)."""
    cfg = {**root.alexnet.as_dict(), **overrides}
    n_train, n_valid = cfg["n_train_samples"], cfg["n_valid_samples"]
    size = cfg["image_size"]
    if streaming_dir is not None:
        from znicz_tpu_torch.loader.image import FileImageLoader
        loader_factory = lambda w: FileImageLoader(  # noqa: E731
            w, train_dir=streaming_dir,
            validation_fraction=n_valid / max(1, n_train + n_valid),
            out_hw=(size, size), resize_hw=(256, 256),
            minibatch_size=cfg["minibatch_size"])
    else:
        x, y = datasets.synthetic_imagenet(n_train + n_valid, size=size,
                                           n_classes=cfg["n_classes"])
        loader_factory = lambda w: ArrayLoader(  # noqa: E731
            w, train_data=x[:n_train], train_labels=y[:n_train],
            valid_data=x[n_train:], valid_labels=y[n_train:],
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0)
    return StandardWorkflow(
        name="alexnet",
        loader_factory=loader_factory,
        layers=layers(cfg),
        decision_config={"max_epochs": cfg["max_epochs"]},
        snapshotter_config=cfg.get("snapshotter_config"))


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``):
    the launcher passes ``load`` (construct or resume) and ``main``
    (initialize and train)."""
    load(build)
    main()
