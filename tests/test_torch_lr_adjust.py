"""The port's learning-rate schedules against the reference, on the CPU.

The policies' math and ``make_policy``'s forms are the reference's tests
(``tests/test_lr_adjust.py``).  Then the Wine sample (the real UCI set
scikit-learn bundles, or its stand-in in both packages alike) trains
with a schedule in both packages from one seed, the reference on its
XLA CPU backend, across an epoch boundary.  After every step the
iteration count and each scheduled unit's ``lr_state`` must equal the
reference's exactly (both round the same Python float to f32 once),
and each parameter and momentum tensor must lie within 1e-5 of its
largest |value| (f32 summation order; measured ~1e-7).  A
``FixedPolicy`` schedule must give the bits of a run with no schedule
(the update reads the same f32 rate from a tensor instead of a float),
a snapshot written by either package must restore the iteration count
and the rates in the other, and ``run_chunked`` must write the rate
once a chunk, as the reference's does.
"""

import numpy as np
import pytest

from znicz_tpu.backends import XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.samples import wine as ref_wine
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples import wine
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops.lr_adjust import (ArbitraryStepPolicy, ExpPolicy,
                                           FixedPolicy, InvPolicy,
                                           PolyPolicy, StepExpPolicy,
                                           make_policy)
from znicz_tpu_torch.ops.nn_units import GradientDescentBase
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

SEED = 31
EXP = {"lr_policy": ("exp", {"gamma": 0.9})}
#: parameters and momentum, relative to the tensor's largest |value|
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def test_policy_math():
    assert FixedPolicy()(0.1, 99) == 0.1
    assert FixedPolicy(0.5)(0.1, 99) == 0.5
    assert StepExpPolicy(0.1, step=10)(1.0, 9) == pytest.approx(1.0)
    assert StepExpPolicy(0.1, step=10)(1.0, 10) == pytest.approx(0.1)
    assert StepExpPolicy(0.1, step=10)(1.0, 25) == pytest.approx(0.01)
    assert ExpPolicy(0.9)(1.0, 2) == pytest.approx(0.81)
    assert InvPolicy(1.0, power=1.0)(1.0, 3) == pytest.approx(0.25)
    assert PolyPolicy(max_iter=10, power=2.0)(1.0, 5) == pytest.approx(0.25)
    sched = ArbitraryStepPolicy([(0.1, 2), (0.01, 3), (0.001, 1)])
    got = [sched(99.0, i) for i in range(8)]
    assert got == pytest.approx(
        [0.1, 0.1, 0.01, 0.01, 0.01, 0.001, 0.001, 0.001])


def test_make_policy_forms():
    assert make_policy(None) is None
    p = ExpPolicy(0.5)
    assert make_policy(p) is p
    assert isinstance(make_policy({"name": "exp", "gamma": 0.5}), ExpPolicy)
    assert isinstance(make_policy(("inv", {"gamma": 2.0})), InvPolicy)
    with pytest.raises(TypeError):
        make_policy(42)


# -- the two packages side by side -----------------------------------------
def _ref_wine(**kwargs):
    ref_prng.seed_all(SEED)
    wf = ref_wine.build(**kwargs)
    wf.initialize(device=XLADevice())
    return wf


def _port_wine(**kwargs):
    prng.seed_all(SEED)
    wf = wine.build(**kwargs)
    wf.initialize(device="cpu")
    return wf


def _layers(first=None, head=None):
    """Wine's 13 → 8 → 3 with a tanh, an activation and a dropout layer
    between (weightless units a schedule must skip); ``first`` and
    ``head`` are extra ``"<-"`` keys of the weighted layers."""
    return [{"type": "all2all", "->": {"output_sample_shape": 8},
             "<-": {"learning_rate": 0.3, **(first or {})}},
            {"type": "activation_tanh"},
            {"type": "dropout", "->": {"dropout_ratio": 0.0}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.3, "learning_rate_bias": 0.2,
                    "gradient_moment": 0.5, **(head or {})}}]


def _mlp(package, **kwargs):
    """Wine's data through ``_layers`` in one package."""
    x, y = datasets.load_wine()
    workflow, loader = ((RefWorkflow, RefLoader) if package == "ref"
                        else (StandardWorkflow, ArrayLoader))
    (ref_prng if package == "ref" else prng).seed_all(SEED)
    wf = workflow(
        name="wine", layers=_layers(kwargs.pop("first", None),
                                    kwargs.pop("head", None)),
        loader_factory=lambda w: loader(
            w, train_data=x[:150], train_labels=y[:150],
            valid_data=x[150:], valid_labels=y[150:], minibatch_size=10),
        decision_config={"max_epochs": 100}, **kwargs)
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice() if package == "ref" else "cpu")
    return wf


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()
    if wf.lr_adjuster is not None:
        wf.lr_adjuster._fire()


def _ref_state(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.array(vec.mem, np.float32)
    return out


def _port_state(wf) -> dict:
    return {f"{u.name}.{name}": t.detach().numpy().copy()
            for u in [*wf.forwards, *wf.gds]
            for name, t in [*u.named_parameters(recurse=False),
                            *u.named_buffers(recurse=False)]
            if name != "lr_state"}


def _rates(wf, package) -> dict:
    out = {}
    for unit in wf.gds:
        if package == "ref":
            # the reference's activation backwards also carry a rate,
            # which nothing reads
            weights = getattr(unit.forward_unit, "weights", None)
            if unit.lr_state and weights is not None and weights:
                unit.lr_state.map_read()
                out[unit.name] = np.array(unit.lr_state.mem)
        elif unit.lr_state is not None:
            out[unit.name] = unit.lr_state.numpy().copy()
    return out


def _assert_same_run(port, ref):
    want, got = _ref_state(ref), _port_state(port)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=key)
    assert port.lr_adjuster._n_iterations == ref.lr_adjuster._n_iterations
    want_rates, got_rates = _rates(ref, "ref"), _rates(port, "port")
    assert set(got_rates) == set(want_rates) and got_rates
    for key, w in want_rates.items():
        np.testing.assert_array_equal(got_rates[key], w, err_msg=key)


def test_scheduled_wine_matches_the_reference():
    ref = _ref_wine(lr_adjuster_config=EXP)
    port = _port_wine(lr_adjuster_config=EXP)
    classes = []
    for _ in range(22):  # 3 validation + 15 train steps an epoch
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        _assert_same_run(port, ref)
    assert classes.count(TRAIN) == 16 == port.lr_adjuster._n_iterations
    gd = port.gds[0]
    np.testing.assert_array_equal(
        gd.lr_state.numpy(), np.float32([0.3 * 0.9 ** 16] * 2))
    # the region keeps one step a key however the rate moves
    assert port.region.captures == 0  # the CPU runs its steps eagerly


def test_per_layer_policies_and_weightless_units():
    """A layer's own ``lr_policy`` and ``bias_lr_policy`` override the
    adjuster's, and imply one with no ``lr_adjuster_config``; the
    activation and dropout backwards are not scheduled."""
    kwargs = {"first": {"lr_policy": ("fixed", {"lr": 0.05})},
              "head": {"bias_lr_policy": ("inv", {"gamma": 0.5})}}
    ref = _mlp("ref", **kwargs)
    port = _mlp("port", **kwargs)
    assert port.lr_adjuster is not None
    scheduled = [gd.name for gd, _, _ in port.lr_adjuster._gd_units]
    assert scheduled == [port.gds[0].name, port.gds[3].name]
    assert port.gds[1].lr_state is None and port.gds[2].lr_state is None
    for _ in range(8):
        _ref_step(ref)
        port.step()
        _assert_same_run(port, ref)
    itr = port.lr_adjuster._n_iterations
    np.testing.assert_array_equal(port.gds[0].lr_state.numpy(),
                                  np.float32([0.05, 0.05]))
    # the head's weights keep their rate; its bias follows its own policy
    np.testing.assert_array_equal(
        port.gds[3].lr_state.numpy(),
        np.float32([0.3, 0.2 * (1.0 + 0.5 * itr) ** -1.0]))


def test_fixed_policy_is_bit_equal_to_no_schedule():
    fixed = _mlp("port", lr_adjuster_config={"lr_policy": ("fixed", {})})
    plain = _mlp("port")
    assert fixed.gds[0].lr_state is not None and plain.lr_adjuster is None
    assert plain.gds[0].lr_state is None
    for _ in range(20):
        fixed.step()
        plain.step()
    a, b = _port_state(fixed), _port_state(plain)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_snapshot_restores_the_schedule(writer):
    """Eleven steps in one package; the other loads its state (the
    reference's ``Workflow.state_dict``/``load_state`` and the port's,
    which read each other's) and both go on for five steps alike."""
    ref = _ref_wine(lr_adjuster_config=EXP)
    port = _port_wine(lr_adjuster_config=EXP)
    source, dest = (ref, port) if writer == "ref" else (port, ref)
    step = _ref_step if writer == "ref" else StandardWorkflow.step
    for _ in range(11):
        step(source)
    dest.load_state(source.state_dict())
    assert dest.lr_adjuster._n_iterations == \
        source.lr_adjuster._n_iterations == 8
    _assert_same_run(port, ref)
    for _ in range(5):
        _ref_step(ref)
        port.step()
        _assert_same_run(port, ref)


def test_a_snapshot_without_rates_takes_them_from_the_count():
    """A state with no ``lr_state`` (a run with no schedule, or one
    written before the schedule existed) still resumes: the adjuster
    writes the rates of its iteration count."""
    port = _port_wine(lr_adjuster_config=EXP)
    for _ in range(6):
        port.step()
    state = port.state_dict()
    for unit in state["__units__"].values():
        unit.pop("lr_state", None)
    fresh = _port_wine(lr_adjuster_config=EXP)
    fresh.load_state(state)
    assert fresh.lr_adjuster._n_iterations == 3
    np.testing.assert_array_equal(fresh.gds[1].lr_state.numpy(),
                                  port.gds[1].lr_state.numpy())


def test_run_chunked_writes_the_rate_once_a_chunk():
    """``run_chunked(4)`` of both packages over two epochs: the port's
    rates are written once a train chunk, the trajectories and the
    final rates agree with the reference's."""
    ref = _ref_wine(lr_adjuster_config=EXP, max_epochs=2)
    port = _port_wine(lr_adjuster_config=EXP, max_epochs=2)
    writes = []
    real = GradientDescentBase.write_lr_state

    def spy(unit, lr, lr_bias):
        if unit is port.gds[0]:
            writes.append(lr)
        real(unit, lr, lr_bias)

    GradientDescentBase.write_lr_state = spy
    try:
        port.run_chunked(4)
    finally:
        GradientDescentBase.write_lr_state = real
    ref.run_chunked(4)
    assert port.decision.complete and port.loader.epoch_number == 1
    _assert_same_run(port, ref)
    assert port.lr_adjuster._n_iterations == 30
    # 15 train steps an epoch in chunks of 4, 4, 4, 3: after each the
    # rate of the next chunk's first step
    starts = [4, 8, 12, 15, 19, 23, 27, 30]
    assert writes == [0.3 * 0.9 ** i for i in starts]
