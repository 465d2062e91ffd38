"""The port's numpy oracle (``NumpyDevice``, ``-b numpy``) against the
reference's, on the CPU.

- The device: ``Device.create("numpy")``, host-only, f32 whatever
  ``precision_type`` says; a ``Vector`` on it is its host array.
- Each ported unit's ``numpy_run`` against the reference unit's under
  the reference's ``NumpyDevice``: a small chain built around the unit
  in both packages from one seed (inputs from one numpy generator,
  parameters from the shared fill order), stepped through validation
  and train minibatches; every forward's output, every backward's
  ``err_input``, every parameter and momentum tensor and the
  evaluator's error and sums equal to the bit.  The port's numpy code
  is the reference's, copied, on the same inputs, so nothing may
  differ; the dropout mask and stochastic pooling's draws come from the
  default generator's numpy stream in both packages, which one seed
  makes equal.
- Each ported sample for a few steps on both oracles (Wine, MNIST, the
  MNIST-784 autoencoder, CIFAR and AlexNet at narrowed widths,
  ``attention_seq``, the token LM, the LSTM chain): the parameters and
  momentum equal to the bit, and the port's oracle held to the port's
  CPU device within the f32 tolerance the sample tests use (1e-5 of
  each tensor's largest |value|: torch's kernels sum in other orders).
  Dropout makes the CPU device's run differ from the oracle's by design
  (the kernel's Philox bits, not the host stream), so AlexNet is held
  to it with its dropout off.
- The oracle stays numpy: a step with ``torch.matmul``, ``F.conv2d`` and
  ``F.linear`` (and ``torch.einsum``, ``torch.bmm``) patched to raise
  still passes.
- The command line: ``wine -b numpy`` trains, and its snapshot resumes
  on the CPU device (and the CPU device's on the oracle).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.samples import attention_seq as ref_attention_seq
from znicz_tpu.models.samples import mnist as ref_mnist
from znicz_tpu.models.samples import mnist784 as ref_mnist784
from znicz_tpu.models.samples import wine as ref_wine
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.backends import CpuDevice, Device, NumpyDevice
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models.samples import (alexnet, attention_seq, cifar,
                                            mnist, mnist784, wine)
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

SEED = 23
#: the port's oracle against its CPU device, of each tensor's largest
#: |value| (tests/test_torch_mlp.py's f32 bar)
TOL_CPU = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


# -- the device ---------------------------------------------------------------
def test_numpy_device_and_its_vectors():
    root.common.precision_type = "bfloat16"
    dev = Device.create("numpy")
    assert isinstance(dev, NumpyDevice) and dev.is_host_only
    assert dev.backend == "numpy" and dev.type == "cpu"
    assert dev.compute_dtype == torch.float32  # f32 whatever the mode
    assert not CpuDevice(torch.device("cpu")).is_host_only
    assert Device.create(dev) is dev
    host = np.arange(6, dtype=np.float32)
    vec = Vector(host, name="v")
    vec.initialize(dev)
    assert vec._devmem is None  # nothing uploaded
    assert vec.devmem is vec.mem  # the array is the buffer
    vec.unmap()
    vec.devmem = np.ones(6, np.float32)  # in place
    assert vec.mem is vec._mem and vec.mem.sum() == 6
    assert vec.state_name == "HOST"


# -- unit by unit ----------------------------------------------------------------
GD = {"learning_rate": 0.05, "gradient_moment": 0.9, "weights_decay": 1e-3}


def _head(n=3):
    return {"type": "softmax", "->": {"output_sample_shape": n}, "<-": GD}


def _dense(kind, **kw):
    return {"type": kind, "->": {"output_sample_shape": 8, **kw}, "<-": GD}


def _conv(kind="conv_tanh", n=4, **kw):
    return {"type": kind, "->": {"n_kernels": n, "kx": 3, "ky": 3,
                                 "padding": 1, **kw}, "<-": GD}


def _pool(kind, **kw):
    return {"type": kind, "->": {"kx": 3, "ky": 3, "sliding": (2, 2), **kw}}


V, T = 11, 6
#: case → (input kind, layers, loss); each case centres on one unit kind
CASES = {
    "all2all": ("flat", [_dense("all2all"), _head()], "softmax"),
    "all2all_tanh": ("flat", [_dense("all2all_tanh"), _head()], "softmax"),
    "all2all_relu": ("flat", [_dense("all2all_relu"), _head()], "softmax"),
    "all2all_str": ("flat", [_dense("all2all_str"), _head()], "softmax"),
    "all2all_sigmoid": ("flat", [_dense("all2all_sigmoid"), _head()],
                        "softmax"),
    "all2all_clip_l1": ("flat", [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
         "<-": {**GD, "gradient_clip": 0.05, "l1_vs_l2": 0.3}},
        _head()], "softmax"),
    "mse": ("flat", [_dense("all2all_tanh"),
                     {"type": "all2all", "->": {"output_sample_shape": 6},
                      "<-": GD}], "mse"),
    "mse_over_softmax": ("flat", [_dense("all2all_tanh"), _head(6)], "mse"),
    **{f"activation_{a}": ("flat", [_dense("all2all"),
                                    {"type": f"activation_{a}", "->": (
                                        {"factor": 1.5} if a == "mul"
                                        else {})}, _head()], "softmax")
       for a in ("tanh", "relu", "str", "sigmoid", "log", "mul")},
    **{kind: ("image", [_conv(kind), _head()], "softmax")
       for kind in ("conv", "conv_tanh", "conv_relu", "conv_str",
                    "conv_sigmoid")},
    "conv_strided_uneven": ("image", [
        _conv("conv_str", sliding=(2, 2), padding=(1, 0, 2, 1)),
        _head()], "softmax"),
    **{kind: ("image", [_conv(), _pool(kind), _head()], "softmax")
       for kind in ("max_pooling", "maxabs_pooling", "avg_pooling",
                    "stochastic_pooling")},
    "norm": ("image", [_conv(n=8), {"type": "norm", "->": {"n": 5}},
                       _head()], "softmax"),
    "norm_even_window": ("image", [_conv(n=8),
                                   {"type": "norm", "->": {"n": 4}},
                                   _head()], "softmax"),
    "dropout": ("flat", [_dense("all2all_str"),
                         {"type": "dropout", "->": {"dropout_ratio": 0.4}},
                         _head()], "softmax"),
    "attention": ("seq", [{"type": "attention", "->": {"n_heads": 2},
                           "<-": GD}, {"type": "last_token", "->": {}},
                          _head()], "softmax"),
    "attention_causal": ("seq", [{"type": "attention",
                                  "->": {"n_heads": 2, "causal": True},
                                  "<-": GD},
                                 {"type": "last_token", "->": {}},
                                 _head()], "softmax"),
    "layer_norm": ("seq", [{"type": "layer_norm", "->": {}, "<-": GD},
                           {"type": "last_token", "->": {}}, _head()],
                   "softmax"),
    "embedding_pos_encoding": ("tokens", [
        {"type": "embedding", "->": {"vocab_size": V, "dim": 8}, "<-": GD},
        {"type": "pos_encoding", "->": {}},
        {"type": "last_token", "->": {}}, _head(V)], "softmax"),
    "to_sequence": ("image", [_conv(), {"type": "to_sequence", "->": {}},
                              {"type": "last_token", "->": {}}, _head()],
                    "softmax"),
    "lstm": ("seq", [{"type": "lstm", "->": {"units": 6}, "<-": GD},
                     _head()], "softmax"),
    "lstm_sequence": ("seq", [{"type": "lstm", "->": {
        "units": 6, "return_sequence": True}, "<-": GD},
        {"type": "last_token", "->": {}}, _head()], "softmax"),
}
SHAPES = {"flat": (6,), "image": (7, 7, 2), "seq": (T, 8), "tokens": (T,)}


def _data(kind, n=30):
    rng = np.random.default_rng(SEED)
    if kind == "tokens":
        x = rng.integers(0, V, size=(n, T)).astype(np.float32)
        return x, rng.integers(0, V, size=n).astype(np.int32)
    x = rng.normal(size=(n,) + SHAPES[kind]).astype(np.float32)
    return x, rng.integers(0, 3, size=n).astype(np.int32)


def _factory(cls, x, y, batch=8, n_valid=10, labels=True):
    return lambda w: cls(
        w, train_data=x[n_valid:], valid_data=x[:n_valid],
        train_labels=y[n_valid:] if labels else None,
        valid_labels=y[:n_valid] if labels else None,
        minibatch_size=batch)


def _ref_workflow(layers, factory, loss="softmax", **kwargs):
    ref_prng.seed_all(SEED)
    wf = RefWorkflow(name="oracle", loader_factory=factory(RefLoader),
                     layers=layers, loss=loss,
                     decision_config={"max_epochs": 100}, **kwargs)
    wf.initialize(device=RefNumpyDevice())
    return wf


def _port_workflow(layers, factory, loss="softmax", device="numpy",
                   **kwargs):
    prng.seed_all(SEED)
    wf = StandardWorkflow(name="oracle", loader_factory=factory(ArrayLoader),
                          layers=layers, loss=loss,
                          decision_config={"max_epochs": 100}, **kwargs)
    wf.initialize(device=device)
    return wf


def _ref_step(wf):
    """One step of the reference's oracle: its units one by one, as its
    graph fires them (no region on the numpy device)."""
    for unit in [wf.loader, *wf.forwards, wf.evaluator, *reversed(wf.gds)]:
        if not unit.gate_skip:
            unit._fire()
    wf.decision._fire()


def _ref_array(vec):
    vec.map_read()
    return np.asarray(vec.mem)


def _port_array(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().numpy()
    return np.asarray(value)


_PARAMS = ("weights", "bias", "weights_out", "bias_out")
_MOMENTA = ("accumulated_gradient_weights", "accumulated_gradient_bias",
            "accumulated_gradient_weights_out",
            "accumulated_gradient_bias_out")


def _ref_state(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _PARAMS + _MOMENTA:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                out[f"{unit.name}.{attr}"] = _ref_array(vec)
    return out


def _port_state(wf) -> dict:
    return {f"{unit.name}.{name}": _port_array(t)
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]
            if name in _PARAMS + _MOMENTA}


def _assert_equal_step(port, ref, train: bool):
    """Every value the step wrote, to the bit."""
    for up, ur in zip(port.forwards, ref.forwards):
        np.testing.assert_array_equal(_port_array(up.output),
                                      _ref_array(ur.output), err_msg=up.name)
    if train:
        for up, ur in zip(port.gds, ref.gds):
            if up.err_input is not None:
                np.testing.assert_array_equal(
                    _port_array(up.err_input), _ref_array(ur.err_input),
                    err_msg=up.name)
    np.testing.assert_array_equal(_port_array(port.evaluator.err_output),
                                  _ref_array(ref.evaluator.err_output))
    for name in ("epoch_n_err", "epoch_loss", "epoch_sse", "metrics"):
        vec = ref.evaluator.__dict__.get(name)
        if vec is not None and vec:
            np.testing.assert_array_equal(
                _port_array(getattr(port.evaluator, name)), _ref_array(vec),
                err_msg=name)
    want, got = _ref_state(ref), _port_state(port)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unit_numpy_run_matches_the_references(case):
    kind, layers, loss = CASES[case]
    x, y = _data(kind)
    if loss == "mse":
        # the autoencoder's target is the input itself
        factory = lambda cls: _factory(cls, x, y, labels=False)  # noqa
    else:
        factory = lambda cls: _factory(cls, x, y)  # noqa
    ref = _ref_workflow(layers, factory, loss)
    port = _port_workflow(layers, factory, loss)
    assert port.region is None and port._region_unit is None
    assert [u.name for u in port.forwards] == [u.name for u in ref.forwards]
    for _ in range(6):  # 2 validation, 3 train, then the next epoch's
        _ref_step(ref)
        port.step()
        assert port.loader.minibatch_class == ref.loader.minibatch_class
        _assert_equal_step(port, ref,
                           port.loader.minibatch_class == TRAIN)


def test_confusion_counts_on_the_oracle():
    x, y = _data("flat")
    factory = lambda cls: _factory(cls, x, y)  # noqa
    layers = [_dense("all2all_tanh"), _head()]
    config = {"evaluator_config": {"compute_confusion": True}}
    ref = _ref_workflow(layers, factory, **config)
    port = _port_workflow(layers, factory, **config)
    for _ in range(4):  # 2 validation and 2 train minibatches
        _ref_step(ref)
        port.step()
    np.testing.assert_array_equal(
        port.evaluator.confusion_matrix.numpy(),
        _ref_array(ref.evaluator.confusion_matrix))
    assert port.evaluator.confusion_matrix.sum() == 26  # 10 + 16 rows


# -- sample by sample ---------------------------------------------------------------
def _narrow(layers, by: int, keep_last=True):
    """A sample's layer list with its widths divided by ``by`` (the head
    kept)."""
    out = []
    for i, spec in enumerate(layers):
        fwd = dict(spec.get("->", {}))
        last = i == len(layers) - 1
        for key in ("n_kernels", "output_sample_shape"):
            if key in fwd and not (last and keep_last):
                fwd[key] = max(2, fwd[key] // by)
        out.append({**spec, "->": fwd})
    return out


def _images(n, size, classes, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, size, size, 3)).astype(np.uint8)
    return x, rng.integers(0, classes, size=n).astype(np.int32)


def _image_factory(x, y, n_valid, batch):
    return lambda cls: (lambda w: cls(
        w, train_data=x[n_valid:], train_labels=y[n_valid:],
        valid_data=x[:n_valid], valid_labels=y[:n_valid],
        minibatch_size=batch, normalization_scale=2.0 / 255.0,
        normalization_bias=-1.0))


def _lm_factory():
    rng = np.random.default_rng(31)
    start = rng.integers(0, 12, size=48)
    data = ((start[:, None] + np.arange(8)[None, :]) % 12).astype(np.float32)
    labels = ((start + 8) % 12).astype(np.int32)
    return lambda cls: (lambda w: cls(
        w, train_data=data[16:], train_labels=labels[16:],
        valid_data=data[:16], valid_labels=labels[:16], minibatch_size=8))


LM_GD = {"learning_rate": 0.1, "gradient_moment": 0.9}
LM = [{"type": "embedding", "->": {"vocab_size": 12, "dim": 16}, "<-": LM_GD},
      {"type": "pos_encoding", "->": {}},
      {"type": "attention", "->": {"n_heads": 2, "causal": True},
       "<-": LM_GD},
      {"type": "last_token", "->": {}},
      {"type": "softmax", "->": {"output_sample_shape": 12}, "<-": LM_GD}]
LSTM_LM = [LM[0], {"type": "lstm", "->": {"units": 16}, "<-": LM_GD},
           LM[-1]]


def _cifar_layers():
    return _narrow(cifar.layers(dict(root.cifar.as_dict())), 8)


def _alexnet_layers(dropout=0.5):
    cfg = {**alexnet.DEFAULTS, "n_classes": 5, "dropout": dropout}
    return _narrow(alexnet.layers(cfg), 16)


def _sample(name, device, dropout=0.5):
    """``(reference on its oracle, port on device)`` of a sample (AlexNet
    with ``dropout``)."""
    if name in ("wine", "mnist", "mnist784", "attention_seq"):
        mods = {"wine": (ref_wine, wine, {}),
                "mnist": (ref_mnist, mnist, {}),
                "mnist784": (ref_mnist784, mnist784,
                             {"n_train_samples": 300}),
                "attention_seq": (ref_attention_seq, attention_seq, {})}
        ref_mod, port_mod, kwargs = mods[name]
        ref_prng.seed_all(SEED)
        ref = ref_mod.build(**kwargs)
        ref.initialize(device=RefNumpyDevice())
        prng.seed_all(SEED)
        port = port_mod.build(**kwargs)
        port.initialize(device=device)
        return ref, port
    if name == "cifar":
        layers, factory = _cifar_layers(), _image_factory(
            *_images(40, 32, 10), n_valid=16, batch=8)
    elif name == "alexnet":
        layers = _alexnet_layers(dropout)
        factory = _image_factory(*_images(12, 67, 5), n_valid=4, batch=4)
    else:
        layers, factory = {"token_lm": LM, "lstm_lm": LSTM_LM}[name], \
            _lm_factory()
    return (_ref_workflow(layers, factory),
            _port_workflow(layers, factory, device=device))


SAMPLES = ("wine", "mnist", "mnist784", "cifar", "alexnet", "attention_seq",
           "token_lm", "lstm_lm")
#: steps: through the validation minibatches into two train steps
STEPS = {"wine": 4, "mnist": 18, "mnist784": 4, "cifar": 4, "alexnet": 3,
         "attention_seq": 5, "token_lm": 4, "lstm_lm": 4}


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_on_both_oracles(name):
    ref, port = _sample(name, "numpy")
    classes = []
    for _ in range(STEPS[name]):
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
    assert classes[-1] == TRAIN and VALID in classes
    want, got = _ref_state(ref), _port_state(port)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    # and the port's oracle against the port on its CPU device (AlexNet
    # with its dropout off: the CPU device's masks are the kernel's
    # Philox bits, not the host stream)
    if name == "alexnet":
        _, port = _sample(name, "numpy", dropout=0.0)
        for _ in range(STEPS[name]):
            port.step()
        got = _port_state(port)
    _, cpu = _sample(name, "cpu", dropout=0.0)
    for _ in range(STEPS[name]):
        cpu.step()
    on_cpu = _port_state(cpu)
    for key, w in got.items():
        np.testing.assert_allclose(
            on_cpu[key], w, rtol=0,
            atol=TOL_CPU * max(float(np.abs(w).max()), 1e-30), err_msg=key)


# -- no torch on the oracle's path -----------------------------------------------------
def test_the_oracle_stays_numpy(monkeypatch):
    """A conv stack and the sequence stack step on the oracle with
    torch's products patched to raise."""
    layers = CASES["maxabs_pooling"][1][:2] + [
        {"type": "norm", "->": {"n": 5}},
        {"type": "dropout", "->": {"dropout_ratio": 0.3}}, _head()]
    x, y = _data("image")
    image = _port_workflow(layers, lambda cls: _factory(cls, x, y))
    seq = _port_workflow(LM, _lm_factory())

    def refuse(*args, **kwargs):
        raise AssertionError("a torch product on the numpy oracle")

    for mod, name in ((torch, "matmul"), (F, "conv2d"), (F, "linear"),
                      (torch, "einsum"), (torch, "bmm"), (torch, "mm")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    for wf in (image, seq):
        for _ in range(4):
            wf.step()
        assert wf.loader.minibatch_class == TRAIN


# -- the command line ------------------------------------------------------------------
def test_cli_wine_on_the_oracle_resumes_on_the_cpu(tmp_path):
    """``wine -b numpy`` trains and snapshots; its last snapshot resumes
    on the CPU device, and a CPU snapshot on the oracle, each ending
    within the f32 tolerance of a straight run on the same device."""
    args = ["wine", "--root", "wine.max_epochs=6", "--root",
            f"wine.snapshotter_config={{'prefix': 'wine', 'directory': "
            f"'{tmp_path}'}}"]
    runs = {}
    for backend in ("numpy", "cpu"):
        main = Main()
        assert main.run(args + ["-b", backend]) == 0
        wf = main.launcher.workflow
        assert wf.loader.epoch_number + 1 == 6 and wf.decision.complete
        assert (wf.region is None) == (backend == "numpy")
        runs[backend] = wf
    assert isinstance(runs["numpy"].device, NumpyDevice)
    for src, dst in (("numpy", "cpu"), ("cpu", "numpy")):
        snapshot = runs[src].snapshotter.destination
        state = Snapshotter.load(snapshot)
        assert state["__units__"][runs[src].loader.name]["epoch_number"] < 5
        resumed = Main()
        assert resumed.run(args + ["-b", dst, "-s", snapshot]) == 0
        wf = resumed.launcher.workflow
        assert wf.loader.epoch_number + 1 == 6
        want = _port_state(runs[dst])
        for key, got in _port_state(wf).items():
            np.testing.assert_allclose(
                got, want[key], rtol=0,
                atol=TOL_CPU * max(float(np.abs(want[key]).max()), 1e-30),
                err_msg=f"{src}→{dst} {key}")


def test_run_accumulated_needs_a_region():
    x, y = _data("flat")
    wf = _port_workflow([_dense("all2all"), _head()],
                        lambda cls: _factory(cls, x, y))
    with pytest.raises(RuntimeError, match="no region"):
        wf.run_accumulated(2)
