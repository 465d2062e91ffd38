"""The small vision samples (``hands``, ``yale_faces``, ``channels``) and
the five samples of the slice on the port's command line, on the CPU
(the port of ``tests/test_vision_samples.py``).

- Each sample's defaults and synthetic stand-in are the reference's
  (the same bytes, the same normalization, the same split).
- ``hands`` and ``yale_faces`` step side by side with the reference
  from one seed through their validation minibatches into train steps,
  every parameter and momentum within 1e-5 of its largest |value| (f32:
  the same products in other summation orders); ``channels`` the same
  with its conv widths narrowed by four (its head kept).
- Each converges on the CPU to the reference test's bar in 8 epochs.
- With the sample's image directory under ``root.common.dirs.datasets``
  the sample reads it through ``FullBatchImageLoader`` (A10).
- ``python -m znicz_tpu_torch <sample> -b cpu`` trains each of the five
  samples of the slice (the autoencoders cut by ``--root``).
"""

import importlib

import numpy as np
import pytest

from znicz_tpu.backends import XLADevice
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.image import FullBatchImageLoader
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

SEED = 14
TOL = 1e-5
#: the reference test's bars: best validation error (%) in 8 epochs
MAX_ERR_PT = {"hands": 15.0, "yale_faces": 25.0, "channels": 30.0}
#: steps through the validation minibatches into train steps
STEPS = {"hands": 5, "yale_faces": 5, "channels": 4}


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _modules(name):
    return (importlib.import_module(f"znicz_tpu.models.samples.{name}"),
            importlib.import_module(f"znicz_tpu_torch.models.samples.{name}"))


def _narrow(layers, by):
    """The layer list with its conv and hidden widths divided by ``by``
    (the head kept)."""
    out = []
    for i, spec in enumerate(layers):
        fwd = dict(spec.get("->", {}))
        for key in ("n_kernels", "output_sample_shape"):
            if key in fwd and i < len(layers) - 1:
                fwd[key] = max(2, fwd[key] // by)
        out.append({**spec, "->": fwd})
    return out


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
    return {f"{u.name}.{name}": t.detach().numpy().copy()
            for u in [*wf.forwards, *wf.gds]
            for name, t in [*u.named_parameters(recurse=False),
                            *u.named_buffers(recurse=False)]}


@pytest.mark.parametrize("name", ["hands", "yale_faces", "channels"])
def test_sample_steps_match_the_reference(name, monkeypatch):
    ref_mod, port_mod = _modules(name)
    assert dict(getattr(root, name).as_dict()) == dict(
        getattr(ref_root, name).as_dict())
    if name == "channels":
        assert port_mod.layers(dict(root.channels.as_dict())) == \
            ref_mod.layers(dict(ref_root.channels.as_dict()))
        for mod in (ref_mod, port_mod):
            monkeypatch.setattr(mod, "layers",
                                lambda cfg, f=mod.layers: _narrow(f(cfg), 4))
    ref_prng.seed_all(SEED)
    ref = ref_mod.build()
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = port_mod.build()
    port.initialize(device="cpu")
    assert port.layers_config == ref.layers_config
    assert list(port.loader.class_lengths) == list(ref.loader.class_lengths)
    ref.loader.original_data.map_read()
    np.testing.assert_array_equal(port.loader.original_data.numpy(),
                                  ref.loader.original_data.mem)
    classes = []
    for _ in range(STEPS[name]):
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        want, got = _ref_params(ref), _port_params(port)
        assert set(got) == set(want)
        for key, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[key] - w).max()) <= TOL * scale, key
    assert classes[0] == VALID and classes[-1] == TRAIN


@pytest.mark.parametrize("name", ["hands", "yale_faces", "channels"])
def test_sample_converges(name):
    _, port_mod = _modules(name)
    prng.seed_all(SEED)
    wf = port_mod.build(max_epochs=8)
    wf.initialize(device="cpu")
    wf.run()
    best = wf.decision.min_validation_n_err_pt
    assert best <= MAX_ERR_PT[name], f"{name}: {best} %"


@pytest.mark.parametrize("name,directory", [("hands", "hands"),
                                            ("yale_faces", "yalefaces"),
                                            ("channels", "channels")])
def test_image_directory_waits_for_a10(name, directory, tmp_path):
    """A10 is ported: with the sample's image directory the sample reads
    it through ``FullBatchImageLoader``, as the reference does
    (``tests/test_torch_vision_dirs.py`` steps it beside the
    reference)."""
    (tmp_path / "datasets" / directory / "class0").mkdir(parents=True)
    root.common.dirs.datasets = str(tmp_path / "datasets")
    _, port_mod = _modules(name)
    wf = port_mod.build()
    assert isinstance(wf.loader, FullBatchImageLoader)
    assert wf.loader.train_dir == str(tmp_path / "datasets" / directory)
    assert wf.loader.grayscale == (name != "channels")


CLI = {
    "hands": ["--root", "hands.max_epochs=2"],
    "yale_faces": ["--root", "yale_faces.max_epochs=2"],
    "channels": ["--root", "channels.max_epochs=1"],
    "mnist_ae": ["--root", "mnist_ae.n_train_samples=300",
                 "--root", "mnist_ae.max_epochs=2",
                 "--root", "mnist_ae.minibatch_size=30"],
    "imagenet_ae": ["--root", "imagenet_ae.image_size=40",
                    "--root", "imagenet_ae.kx=4", "--root", "imagenet_ae.ky=4",
                    "--root", "imagenet_ae.sliding=(2, 2)",
                    "--root", "imagenet_ae.n_kernels=4",
                    "--root", "imagenet_ae.n_train_samples=32",
                    "--root", "imagenet_ae.n_valid_samples=8",
                    "--root", "imagenet_ae.minibatch_size=8",
                    "--root", "imagenet_ae.max_epochs=2"],
}


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_trains_each_sample_on_the_cpu(name):
    main = Main()
    assert main.run([name, "-b", "cpu", *CLI[name]]) == 0
    wf = main.launcher.workflow
    assert wf.device.type == "cpu" and wf.decision.complete
    if wf.loss == "mse":
        assert wf.decision.min_validation_mse is not None
        assert tuple(wf.forwards[-1].output.shape[1:]) == \
            tuple(wf.loader.sample_shape)
    else:
        assert wf.decision.min_validation_n_err_pt < 100.0
