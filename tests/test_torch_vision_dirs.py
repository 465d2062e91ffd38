"""The samples over real image directories on the port, against the
reference, on the CPU.

- ``hands``, ``yale_faces`` and ``channels`` with their directory under
  ``root.common.dirs.datasets`` (a class-per-subdirectory PNG tree
  written here) read it through ``FullBatchImageLoader``, as the
  reference does: the same decoded set, and the first steps (through
  the validation minibatches into train steps) within 1e-5 of each
  parameter's largest value, the vision samples' tolerance;
- ``imagenet`` on a tiny tree (35 px crops of 40 px resizes, 3 classes,
  the AlexNet layers cut as the AlexNet slice test cuts them, dropout
  at 0) through ``FileImageLoader`` and the native pool: one train step
  within the AlexNet slice test's f32 tolerance (1e-5), and
  ``python -m znicz_tpu_torch imagenet`` trains on the tree;
- ``alexnet.build(streaming_dir=...)`` trains from a tree.
"""

import importlib
import os

import numpy as np
import pytest
from PIL import Image as PILImage

from znicz_tpu.backends import XLADevice
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.image import (FileImageLoader,
                                          FullBatchImageLoader)
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

SEED = 14
TOL = 1e-5
STEPS = {"hands": 4, "yale_faces": 4, "channels": 3}
#: each sample's directory name, its classes and images a class
DIRS = {"hands": ("hands", 2, 14), "yale_faces": ("yalefaces", 4, 6),
        "channels": ("channels", 3, 10)}


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def write_tree(base, n_classes, n_per_class, hw, seed=5):
    """PNGs whose class is the mean intensity, one subdirectory a
    class."""
    rng = np.random.default_rng(seed)
    for cls in range(n_classes):
        d = os.path.join(base, f"c{cls}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            arr = np.clip(rng.normal(40 + 160 * cls / max(1, n_classes - 1),
                                     20, size=(*hw, 3)), 0, 255)
            PILImage.fromarray(arr.astype(np.uint8)).save(
                os.path.join(d, f"{i}.png"))
    return base


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


def _ref_params(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.array(vec.mem, np.float32)
    return out


def _port_params(wf) -> dict:
    return {f"{u.name}.{name}": t.detach().float().numpy().copy()
            for u in [*wf.forwards, *wf.gds]
            for name, t in [*u.named_parameters(recurse=False),
                            *u.named_buffers(recurse=False)]}


def _assert_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[key] - w).max()) <= TOL * scale, key


@pytest.mark.parametrize("name", sorted(DIRS))
def test_sample_reads_its_directory_as_the_reference(name, tmp_path):
    directory, n_classes, per_class = DIRS[name]
    datasets_dir = tmp_path / "datasets"
    ref_mod = importlib.import_module(f"znicz_tpu.models.samples.{name}")
    port_mod = importlib.import_module(
        f"znicz_tpu_torch.models.samples.{name}")
    size = dict(getattr(root, name).as_dict())["image_size"]
    write_tree(str(datasets_dir / directory), n_classes, per_class,
               (size + 3, size + 5))
    root.common.dirs.datasets = str(datasets_dir)
    ref_root.common.dirs.datasets = str(datasets_dir)
    ref_prng.seed_all(SEED)
    ref = ref_mod.build()
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = port_mod.build()
    port.initialize(device="cpu")
    assert isinstance(port.loader, FullBatchImageLoader)
    assert port.loader.decoder == "native"
    assert list(port.loader.class_lengths) == list(ref.loader.class_lengths)
    ref.loader.original_data.map_read()
    np.testing.assert_array_equal(port.loader.original_data.numpy(),
                                  ref.loader.original_data.mem)
    classes = []
    for _ in range(STEPS[name]):
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        _assert_close(_port_params(port), _ref_params(ref))
    assert classes[0] == VALID and TRAIN in classes


SIZE, RESIZE, CLASSES = 35, 40, 3


def _imagenet_layers(cfg):
    """``alexnet.layers`` cut as the AlexNet slice test cuts it (every
    layer kind in order, narrow, dropout at 0), ``cfg``'s classes."""
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9,
          "weights_decay": 5e-4}
    lrn = {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    pool = {"kx": 3, "ky": 3, "sliding": (2, 2)}

    def conv(k, kx, **geom):
        return {"type": "conv_str",
                "->": {"n_kernels": k, "kx": kx, "ky": kx,
                       "weights_stddev": 0.1, **geom}, "<-": gd}

    def fc(n, kind="all2all_str"):
        return {"type": kind, "->": {"output_sample_shape": n,
                                     "weights_stddev": 0.1}, "<-": gd}

    return [conv(8, 5, sliding=(2, 2)),
            {"type": "norm", "->": dict(lrn)},
            {"type": "max_pooling", "->": dict(pool)},
            conv(12, 3, padding=1),
            {"type": "norm", "->": dict(lrn)},
            {"type": "max_pooling", "->": dict(pool)},
            conv(16, 3, padding=1),
            conv(16, 3, padding=1),
            conv(12, 3, padding=1),
            {"type": "max_pooling", "->": dict(pool)},
            fc(32),
            {"type": "dropout", "->": {"dropout_ratio": 0.0}},
            fc(32),
            {"type": "dropout", "->": {"dropout_ratio": 0.0}},
            fc(cfg["n_classes"], "softmax")]


IMAGENET = {"image_size": SIZE, "resize_size": RESIZE,
            "n_classes": CLASSES, "minibatch_size": 6,
            "decode_threads": 2}


def test_imagenet_step_matches_the_reference(tmp_path, monkeypatch):
    tree = write_tree(str(tmp_path / "tree"), CLASSES, 8, (44, 48))
    ref_mod = importlib.import_module("znicz_tpu.models.samples.imagenet")
    port_mod = importlib.import_module(
        "znicz_tpu_torch.models.samples.imagenet")
    assert dict(root.imagenet.as_dict()) == dict(ref_root.imagenet.as_dict())
    for mod in (ref_mod, port_mod):
        monkeypatch.setattr(mod, "layers", _imagenet_layers)
    ref_prng.seed_all(SEED)
    ref = ref_mod.build(train_dir=tree, **IMAGENET)
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = port_mod.build(train_dir=tree, **IMAGENET)
    port.initialize(device="cpu")
    try:
        assert isinstance(port.loader, FileImageLoader)
        assert port.loader.decoder == "native"
        assert port.layers_config == ref.layers_config
        _assert_close(_port_params(port), _ref_params(ref))
        _ref_step(ref)
        port.step()
        assert port.loader.minibatch_class == TRAIN
        ref.loader.minibatch_raw.map_read()
        np.testing.assert_array_equal(
            port.loader.minibatch_raw.devmem.numpy(),
            ref.loader.minibatch_raw.mem)
        _assert_close(_port_params(port), _ref_params(ref))
    finally:
        ref.stop()
        port.stop()


def test_imagenet_trains_from_the_command_line(tmp_path, monkeypatch):
    tree = write_tree(str(tmp_path / "tree"), CLASSES, 8, (44, 48))
    port_mod = importlib.import_module(
        "znicz_tpu_torch.models.samples.imagenet")
    monkeypatch.setattr(port_mod, "layers", _imagenet_layers)
    main = Main()
    args = ["imagenet", "-b", "cpu", "--root", f"imagenet.train_dir={tree}",
            "--root", "imagenet.max_epochs=2",
            "--root", "imagenet.validation_fraction=0.25"]
    for key, value in IMAGENET.items():
        args += ["--root", f"imagenet.{key}={value}"]
    assert main.run(args) == 0
    wf = main.launcher.workflow
    assert wf.decision.complete and wf.loader.decoder == "native"
    assert wf.decision.min_validation_n_err_pt is not None
    with pytest.raises(ValueError, match="train_dir"):
        port_mod.build(train_dir=None)


def test_alexnet_trains_from_a_streaming_dir(tmp_path, monkeypatch):
    tree = write_tree(str(tmp_path / "tree"), CLASSES, 6, (44, 48))
    from znicz_tpu_torch.models.samples import alexnet
    monkeypatch.setattr(alexnet, "layers", _imagenet_layers)
    prng.seed_all(SEED)
    wf = alexnet.build(streaming_dir=tree, image_size=SIZE,
                       n_classes=CLASSES, minibatch_size=4,
                       n_train_samples=12, n_valid_samples=6, max_epochs=1)
    wf.initialize(device="cpu")
    try:
        assert isinstance(wf.loader, FileImageLoader)
        assert wf.loader.class_lengths == [0, 6, 12]
        assert wf.loader.resize_hw == (256, 256)
        wf.run()
        assert wf.decision.complete
    finally:
        wf.stop()
