"""The port's sequence-training slice against the reference, on the CPU.

The stack of ``benchmarks/seq_bench.py`` (attention → layer_norm →
softmax, momentum SGD on every layer) cut to T=16, D=32, 2 heads, with
the update rule's other terms switched on here and there (L2 and L1
decay, separate bias rates and moments, a gradient clip that binds on
the head's weights), goes
through the reference's ``StandardWorkflow`` with its flash-attention
and layer-norm Pallas kernels engaged in interpret mode, and through
the port's ``StandardWorkflow(device="cpu")``, which runs the kernels'
plain versions.  Both start from the same state (the reference's,
carried over by ``load_reference_state``) and step through the same
minibatches: a validation minibatch, three train minibatches, the epoch
boundary, and on into the next epoch.

Tolerances, relative to the largest |reference| of each tensor:

- float32: 1e-5 (summation order only; measured 1e-6);
- bf16: 1e-2 for weights and 2e-2 for momentum (measured 4.4e-3 and
  8.6e-3).  Both packages round at the same points (activations,
  q/k/v, p, ds, the bf16 cotangents of each cast, δ before each
  explicit product), but another summation order can move an f32 value
  across a bf16 rounding boundary, one step of 2⁻⁸ relative in that
  element, and a flipped δ or ds moves every gradient it feeds.  The
  momentum is stored in bf16 and shows such a step directly; the
  biases, which start at zero, are the weights where it shows most.

The per-class error counts must agree exactly, and the epoch losses to
1e-5 (float32) and 1e-2 (bf16) relative.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.export import ExportedModel
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

T, D, HEADS, CLASSES = 16, 32, 2, 8
N_TRAIN, N_VALID, BATCH = 32, 8, 12
GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
TOL = {"float32": {"weights": 1e-5, "momentum": 1e-5, "loss": 1e-5},
       "bfloat16": {"weights": 1e-2, "momentum": 2e-2, "loss": 1e-2}}


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _data(seed=5, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.5, (N_TRAIN + N_VALID, T, d)).astype(np.float32)
    return x, rng.integers(0, CLASSES, N_TRAIN + N_VALID).astype(np.int32)


def _layers(causal, heads=HEADS):
    return [{"type": "attention",
             "->": {"n_heads": heads, "causal": causal},
             "<-": {**GD, "weights_decay": 1e-3, "l1_vs_l2": 0.3}},
            {"type": "layer_norm", "->": {},
             "<-": {**GD, "learning_rate_bias": 0.02,
                    "gradient_moment_bias": 0.5}},
            # the head's weight gradient has a norm of ~6 here
            {"type": "softmax", "->": {"output_sample_shape": CLASSES},
             "<-": {**GD, "gradient_clip": 4.0,
                    "weights_decay_bias": 1e-3}}]


def _loader(cls, x, y):
    return lambda w: cls(w, train_data=x[:N_TRAIN], train_labels=y[:N_TRAIN],
                         valid_data=x[N_TRAIN:], valid_labels=y[N_TRAIN:],
                         minibatch_size=BATCH)


def _reference(dtype, causal, seed=77, anomaly_guard=False, d=D,
               heads=HEADS):
    """The reference workflow, both kernels in interpret mode.  The
    port has no anomaly guard; a finite step is the same with or
    without the reference's."""
    ref_root.common.engine.pallas_interpret = True
    ref_root.common.engine.flash_attention = True
    ref_root.common.engine.pallas_layer_norm = True
    ref_root.common.precision_type = dtype
    ref_prng.seed_all(seed)
    wf = RefWorkflow(name="torch_training",
                     loader_factory=_loader(RefLoader, *_data(d=d)),
                     layers=_layers(causal, heads),
                     decision_config={"max_epochs": 100},
                     anomaly_guard=anomaly_guard)
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    assert wf.forwards[0]._flash_pallas and wf.forwards[1]._pallas_ln
    return wf


def _port(dtype, causal, seed=77, d=D, heads=HEADS):
    root.common.precision_type = dtype
    prng.seed_all(seed)
    wf = StandardWorkflow(name="torch_training",
                          loader_factory=_loader(ArrayLoader, *_data(d=d)),
                          layers=_layers(causal, heads),
                          decision_config={"max_epochs": 100})
    wf.initialize(device="cpu")
    return wf


def _ref_step(wf):
    wf.loader._fire()
    if wf.anomaly_guard is not None:
        wf.anomaly_guard._fire()
    wf._region_unit._fire()
    wf.decision._fire()


_STATE_ATTRS = ("weights", "bias", "weights_out", "bias_out",
                "accumulated_gradient_weights", "accumulated_gradient_bias",
                "accumulated_gradient_weights_out",
                "accumulated_gradient_bias_out")


def _ref_tensors(wf):
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _STATE_ATTRS:
            vec = getattr(unit, attr, None) if attr in unit.__dict__ \
                else None
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.asarray(vec.mem).astype(
                    np.float32)
    return out


def _port_tensors(wf):
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]}


def _assert_close(got, want, dtype):
    assert set(got) == set(want)
    for key, w in want.items():
        kind = "momentum" if "accumulated" in key else "weights"
        atol = TOL[dtype][kind] * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_seed_gives_the_reference_initial_state(dtype):
    ref = _reference(dtype, causal=False)
    port = _port(dtype, causal=False)
    assert [u.name for u in port.forwards] == [u.name for u in ref.forwards]
    assert [u.name for u in port.gds] == [u.name for u in ref.gds]
    want = _ref_tensors(ref)
    got = _port_tensors(port)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert port.loader._shuffle_seed == ref.loader._shuffle_seed
    np.testing.assert_array_equal(port.loader._shuffled,
                                  ref.loader._shuffled)
    # momentum is stored in bf16 in bf16 mode, as in the reference
    acc = port.gds[0].accumulated_gradient_weights
    assert acc.dtype == getattr(torch, dtype)
    assert port.forwards[0].weights.dtype == torch.float32


@pytest.mark.parametrize("dtype,causal,guard", [("float32", False, False),
                                                ("bfloat16", False, True),
                                                ("bfloat16", True, False)])
def test_train_steps_match_the_reference(dtype, causal, guard):
    ref = _reference(dtype, causal, anomaly_guard=guard)
    # another seed: every weight and the sample order must come from
    # the reference's state
    port = _port(dtype, causal, seed=3)
    port.load_reference_state(ref.state_dict())
    _assert_close(_port_tensors(port), _ref_tensors(ref), dtype)
    classes = []
    for _ in range(6):  # valid, 3 × train, epoch end, valid, train
        before = _port_tensors(port)
        _ref_step(ref)
        port.step()
        assert port.loader.minibatch_class == ref.loader.minibatch_class
        classes.append(port.loader.minibatch_class)
        after = _port_tensors(port)
        if port.loader.minibatch_class == VALID:
            # a validation minibatch changes no weight and no momentum
            for key in before:
                np.testing.assert_array_equal(after[key], before[key])
        _assert_close(after, _ref_tensors(ref), dtype)
        assert bool(port.decision.epoch_ended) == bool(
            ref.decision.epoch_ended)
    assert classes == [VALID, TRAIN, TRAIN, TRAIN, VALID, TRAIN]
    assert port.decision.last_epoch_n_err == ref.decision.last_epoch_n_err
    for got, want in zip(port.decision.epoch_loss, ref.decision.epoch_loss):
        if want is None:
            assert got is None
        else:
            assert abs(got - want) <= TOL[dtype]["loss"] * abs(want)
    assert port.loader.epoch_number == ref.loader.epoch_number == 1


@pytest.mark.parametrize("heads", [2, 1])
def test_train_step_at_head_dim_256_matches_the_reference(heads):
    """Two heads of 256 at D = 512, the width C2 opened to the kernels,
    and one head of 512, past 256 (C5): a validation and a train step of
    the port (the plain versions of the kernels) against the
    reference's, whose flash kernel runs at that head dim in interpret
    mode."""
    ref = _reference("bfloat16", causal=True, d=512, heads=heads)
    port = _port("bfloat16", causal=True, seed=3, d=512, heads=heads)
    port.load_reference_state(ref.state_dict())
    classes = []
    for _ in range(2):
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        _assert_close(_port_tensors(port), _ref_tensors(ref), "bfloat16")
    assert classes == [VALID, TRAIN]


def test_gd_softmax_rounds_delta_before_its_products():
    """``GDSoftmax`` writes the reference's formulas: δ is rounded to
    bf16 before ``xᵀ·δ`` and ``δ·Wᵀ`` (autograd would round the products
    instead), ``err_input`` uses W as it was before the update and is
    stored in bf16, the weights stay f32."""
    from znicz_tpu_torch.ops.all2all import All2AllSoftmax
    from znicz_tpu_torch.ops.gd import GDSoftmax
    rng = np.random.default_rng(4)
    unit = All2AllSoftmax((4, 8), torch.bfloat16, output_sample_shape=3)
    unit.load_params({"weights": torch.from_numpy(
        rng.normal(0, 0.3, (32, 3)).astype(np.float32)),
        "bias": torch.zeros(3)})
    gd = GDSoftmax(unit, learning_rate=1.0)  # plain SGD: W −= g
    x = torch.from_numpy(rng.normal(0, 1, (5, 4, 8)).astype(
        np.float32)).to(torch.bfloat16)
    err = torch.from_numpy(rng.normal(0, 0.1, (5, 3)).astype(np.float32))
    w0 = unit.weights.detach().clone()
    err_input = gd.run(x, err)
    delta = err.to(torch.bfloat16).float()
    grad = x.reshape(5, -1).float().t() @ delta
    assert torch.equal(unit.weights.detach(), w0 - grad)
    assert unit.weights.dtype == torch.float32
    assert err_input.dtype == torch.bfloat16
    assert torch.equal(err_input, (delta @ w0.to(torch.bfloat16).float()
                                   .t()).reshape(x.shape).to(torch.bfloat16))
    w = w0.clone().requires_grad_()
    unit.mxu_dot(x.reshape(5, -1), w).backward(err)
    assert not torch.equal(w.grad, grad)  # autograd rounds the product


def test_exported_bundle_serves_in_both_packages(tmp_path):
    port = _port("bfloat16", causal=True)
    for _ in range(4):
        port.step()
    path = port.export_forward(str(tmp_path / "trained.npz"))
    x = _data(seed=6)[0][:3]
    got = ExportedModel.load(path, device="cpu")(x)
    ref_root.common.engine.pallas_interpret = True
    ref_root.common.engine.flash_attention = True
    ref_root.common.engine.pallas_layer_norm = True
    ref_model = RefModel.load(path, device=XLADevice())
    assert ref_model.manifest["dtype"] == "bfloat16"
    assert ref_model.manifest["kind"] == "scorer"
    want = ref_model(x)
    assert got.shape == (3, CLASSES)
    # the serving tolerance of a bf16 bundle (tests/test_torch_serving.py)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_sample_loss_falls_on_the_cpu():
    from znicz_tpu_torch.models.samples import attention_seq
    prng.seed_all(9)
    wf = attention_seq.build(max_epochs=3, n_train=192, n_valid=48)
    wf.initialize(device="cpu")
    losses = []
    while not wf.decision.complete:
        wf.step()
        if wf.decision.epoch_ended:
            losses.append(wf.decision.epoch_loss[TRAIN])
    assert len(losses) == 3 and losses[-1] < 0.5 * losses[0]
    assert wf.decision.min_validation_n_err_pt < 50.0


def test_initialize_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = StandardWorkflow(loader_factory=_loader(ArrayLoader, *_data()),
                          layers=_layers(False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.initialize()


def test_workflow_checks():
    # C12: an MSE loss over a softmax layer is the reference's, and builds
    wf = StandardWorkflow(loader_factory=_loader(ArrayLoader, *_data()),
                          layers=_layers(False), loss="mse")
    assert type(wf.evaluator).__name__ == "EvaluatorMSE"
    with pytest.raises(ValueError, match="unknown loss 'hinge'"):
        StandardWorkflow(loader_factory=_loader(ArrayLoader, *_data()),
                         layers=_layers(False), loss="hinge")
    with pytest.raises(ValueError, match="ends with a 'softmax'"):
        StandardWorkflow(loader_factory=_loader(ArrayLoader, *_data()),
                         layers=_layers(False)[:2])
    wf = _port("float32", causal=False)
    state = wf.state_dict()
    del state["__units__"]["GDSoftmax"]["accumulated_gradient_bias"]
    with pytest.raises(KeyError, match="GDSoftmax.accumulated_gradient"):
        wf.load_reference_state(state)
