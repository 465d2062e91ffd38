"""The port's anomaly guard (``znicz_tpu_torch.resilience.guard``, the
guarded update of ``ops/nn_units.py``, the evaluator's and the
decision's hooks) against the reference's, on the CPU.

Each case builds both packages' ``StandardWorkflow`` from one seed on
the same blobs (the reference on its XLA CPU backend, or both on their
numpy oracles) and holds them to each other:

- the guard cases of ``tests/test_resilience.py`` (an injected
  non-finite loss or gradient skipped and counted, the numpy oracle's
  skip, a clean run bit-equal with the guard off, the K-streak rollback
  to the last snapshot, a streak with no snapshot going on), each
  through both packages;
- both packages at their defaults (guard and fingerprints on): the
  parameters, ``anomaly_state`` and the fingerprints;
- a snapshot taken with the guard on loads in the other package;
- a NaN planted in one training sample under ``run``, ``run_chunked``,
  ``run_accumulated`` and ``run_pipelined``: the step (the optimizer
  step) that gathers it leaves every parameter and momentum tensor bit
  for bit, with the reference's verdicts;
- the guarded update's forms on one unit: a skipped tensor keeps its
  bits (``-0.0`` included), a finite step is bit-equal to the unguarded
  one (an f32 and a bf16 momentum store), a non-finite gradient clears
  the running flag for the tensors after it; a finite gradient whose
  f32 Σ g² overflows skipped by both packages' device forms and applied
  by both oracles (C16's mechanism);
- the card's read of the state a step behind
  (``AnomalyGuard.poll_state``, the CUDA event stood in for): the
  rollback one step later than the read of the moment, and once;
- the region's bookkeeping with a stand-in for the CUDA graph API: the
  guard's tensors are fixed in the capture, arming a drill leaf and a
  rollback's in-place load capture nothing;
- 2-rank gloo worlds (``tests/torch_parallel_worker.py``, mode
  ``guard``): ZeRO-1 and tensor parallelism with a NaN in one rank's
  block of a gradient, both ranks skipping, the fingerprint of a
  sharded tensor equal to the logical tensor's, and
  ``run_accumulated`` under ZeRO-1 with an injected step.

Tolerances: parameters within 1e-5 of each tensor's largest |value|
(f32 sums in another order, as ``tests/test_torch_mlp.py``); anomaly
states and counters equal; the fingerprints within 1e-4 relative (XLA
and torch add the ~64 weighted samples in other orders; measured
~1e-5); on the numpy oracles everything bit-equal.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from conftest import make_blobs
from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.observe import metrics as ref_metrics
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu.utils.snapshotter import Snapshotter as RefSnapshotter
from znicz_tpu_torch.accelerated_units import JitRegion, _Phase
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.ops.all2all import All2All
from znicz_tpu_torch.ops.gd import GradientDescent
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

TOL = 1e-5
FP_RTOL = 1e-4
SEED = 11
LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
          {"type": "softmax", "->": {"output_sample_shape": 3},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _data(poison: int | None = None):
    data, labels = make_blobs(40, 3, 10)
    if poison is not None:
        data = data.copy()
        data[poison, 3] = np.nan
    return data, labels


def _config(**engine):
    for key, value in engine.items():
        setattr(root.common.engine, key, value)
        setattr(ref_root.common.engine, key, value)


def _both(name, ref_device=None, port_device="cpu", max_epochs=4,
          snap_dir=None, poison=None, **kwargs):
    """The reference's and the port's workflow on one seed and one set
    of blobs (96 train rows, 24 validation rows, minibatches of 24)."""
    data, labels = _data(poison)
    out = []
    for pkg, loader_cls, wf_cls, seed_all, device in (
            ("ref", RefLoader, RefWorkflow, ref_prng.seed_all,
             ref_device or XLADevice()),
            ("port", ArrayLoader, StandardWorkflow, prng.seed_all,
             port_device)):
        seed_all(SEED)
        snap = ({"directory": os.path.join(snap_dir, pkg), "prefix": name}
                if snap_dir else None)
        wf = wf_cls(
            name=name,
            loader_factory=lambda w, cls=loader_cls: cls(
                w, train_data=data[:96], train_labels=labels[:96],
                valid_data=data[96:], valid_labels=labels[96:],
                minibatch_size=24),
            layers=LAYERS, decision_config={"max_epochs": max_epochs},
            snapshotter_config=snap, **kwargs)
        wf._max_fires = 100_000
        wf.initialize(device=device)
        out.append(wf)
    return out


def _ref_params(wf) -> list:
    out = []
    for unit in [*wf.forwards, *wf.gds]:
        for name in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            vec = unit.__dict__.get(name)
            if vec is not None and vec:
                vec.map_read()
                out.append(np.array(vec.mem, dtype=np.float32, copy=True))
    return out


def _port_params(wf) -> list:
    out = []
    for unit in [*wf.forwards, *wf.gds]:
        for name in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            t = getattr(unit, name, None)
            if isinstance(t, torch.Tensor):
                out.append(t.detach().float().numpy().copy())
    return out


def _assert_params_close(ref, port, exact=False):
    for got, want in zip(_port_params(port), _ref_params(ref), strict=True):
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= TOL * scale


def _bits(wf) -> dict:
    """Every parameter, momentum and microbatch sum of the port's ``wf``
    as raw bytes (a NaN equal to the same NaN)."""
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for name, t in [*unit.named_parameters(recurse=False),
                        *unit.named_buffers(recurse=False)]:
            if name != "lr_state":
                out[f"{unit.name}.{name}"] = t.detach().contiguous().view(
                    torch.uint8).numpy().tobytes()
    return out


# ----------------------------------------------------------------------
# the guard cases of tests/test_resilience.py, through both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site,kind", [("train.nonfinite_loss", "loss"),
                                       ("train.nonfinite_grad", "grad")])
def test_guard_skips_injected_nonfinite_step(site, kind):
    """One injected step in each package: the update skipped, the
    weights finite, the run converging anyway, the anomaly counted under
    its kind, the streak cleared, the two runs alike."""
    _config(faults={site: {"at": [2]}})
    ref, port = _both(f"guard_{kind}")
    before = metrics.step_anomalies(port.name, kind).value
    ref_before = ref_metrics.step_anomalies(ref.name, kind).value
    ref.run()
    port.run()
    assert torch.isfinite(port.forwards[0].weights).all()
    assert metrics.step_anomalies(port.name, kind).value - before == 1
    assert ref_metrics.step_anomalies(ref.name, kind).value \
        - ref_before == 1
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state()
    assert port.anomaly_guard.read_state()[0] == 0
    assert port.decision.min_validation_n_err_pt < 50.0
    assert port.decision.min_validation_n_err == \
        ref.decision.min_validation_n_err
    _assert_params_close(ref, port)


def test_guard_numpy_oracle_parity():
    """The numpy oracles take the same skip path, bit for bit: the
    parameters, the anomaly state and the fingerprints."""
    _config(faults={"train.nonfinite_loss": {"at": [2]}})
    ref, port = _both("guard_np", ref_device=NumpyDevice(),
                      port_device="numpy", max_epochs=2)
    ref.run()
    port.run()
    assert np.isfinite(port.forwards[0].weights.numpy()).all()
    assert metrics.step_anomalies("guard_np", "loss").value >= 1
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state() == (0, 1, 0)
    np.testing.assert_array_equal(port.anomaly_guard.read_sdc_fingerprint(),
                                  ref.anomaly_guard.read_sdc_fingerprint())
    _assert_params_close(ref, port, exact=True)


def test_guard_clean_run_matches_unguarded_bitwise():
    """``where(ok, new, old)`` with a true predicate is the identity: a
    clean run ends bit-equal with the guard on and off, and close to the
    reference's guarded run."""
    ref, on = _both("guard_on", max_epochs=2)
    ref.run()
    on.run()
    prng.seed_all(SEED)
    data, labels = _data()
    off = StandardWorkflow(
        name="guard_off",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=24),
        layers=LAYERS, decision_config={"max_epochs": 2},
        anomaly_guard=False)
    assert off.anomaly_guard is None and off.integrity is None
    off.initialize(device="cpu")
    off.run()
    assert _bits(on) == _bits(off)
    _assert_params_close(ref, on)


def test_guard_rollback_restores_poisoned_weights(tmp_path):
    """Weights poisoned with NaN mid-training drive K anomalous steps in
    a row; each package's decision rolls its workflow back to its last
    snapshot after the same number of steps, and the run trains on."""
    _config(anomaly_rollback_k=3)
    ref, port = _both("guard_rb", max_epochs=2, snap_dir=str(tmp_path))
    ref.run()
    port.run()
    assert port.snapshotter.destination is not None
    steps = {}
    for pkg, wf, count in (
            ("ref", ref, ref_metrics.anomaly_rollbacks("guard_rb")),
            ("port", port, metrics.anomaly_rollbacks("guard_rb"))):
        base = count.value
        if pkg == "ref":
            w = wf.forwards[0].weights
            w.map_write()
            w.mem[...] = np.nan
        else:
            wf.forwards[0].weights.fill_(float("nan"))
        n = 0
        while count.value == base and n < 40:
            wf.loader.run()
            if pkg == "ref":
                wf._region_unit.run()
            else:
                wf.anomaly_guard.run()
                wf._region_unit.run()
            wf.decision.run()
            n += 1
        assert count.value == base + 1, f"{pkg}: no rollback in {n} steps"
        assert wf.anomaly_guard.read_state()[0] == 0
        steps[pkg] = n
        for _ in range(4):
            wf.loader.run()
            wf._region_unit.run()
            wf.decision.run()
    assert steps["port"] == steps["ref"]
    assert all(np.isfinite(p).all() for p in _port_params(port))
    _assert_params_close(ref, port)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU, where a copy has
    landed when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _steps_to_rollback(tmp_path, monkeypatch, lagged: bool) -> int:
    """Steps from weights made NaN to the K-streak rollback, the guard
    polled as on the card (``lagged``) or as on the CPU; asserts one
    rollback, not two, and the run training on."""
    name = f"guard_poll_{int(lagged)}"
    port = _both(name, max_epochs=2, snap_dir=str(tmp_path / name))[1]
    port.run()
    guard = port.anomaly_guard
    monkeypatch.setattr(guard, "_lagged", lambda: lagged)
    count = metrics.anomaly_rollbacks(name)
    base = count.value
    port.forwards[0].weights.fill_(float("nan"))

    def step():
        port.loader.run()
        guard.run()
        port._region_unit.run()
        port.decision.run()

    n = 0
    while count.value == base and n < 40:
        step()
        n += 1
    assert count.value == base + 1
    assert guard.read_state()[0] == 0
    for _ in range(6):
        step()
    assert count.value == base + 1
    assert all(np.isfinite(p).all() for p in _port_params(port))
    return n


def test_the_cards_poll_reads_one_step_behind(tmp_path, monkeypatch):
    """On the card the decision's tick reads the state the previous tick
    queued (``AnomalyGuard.poll_state``): the K-streak rollback comes one
    step later than with the read of the moment (the CPU's, where it
    comes with the reference's, as the test above holds), there is one
    rollback, not two (the copy queued before it is dropped), and the
    run trains on."""
    _config(anomaly_rollback_k=3)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    now = _steps_to_rollback(tmp_path, monkeypatch, False)
    behind = _steps_to_rollback(tmp_path, monkeypatch, True)
    assert behind == now + 1


def test_guard_streak_without_snapshot_warns_and_continues():
    _config(anomaly_rollback_k=2,
            faults={"train.nonfinite_loss": {"after": 1}})
    ref, port = _both("guard_nosnap", max_epochs=2)
    ref.run()
    port.run()  # every train step anomalous: it completes, it does not raise
    assert torch.isfinite(port.forwards[0].weights).all()
    assert metrics.step_anomalies("guard_nosnap", "loss").value > 2
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state()
    _assert_params_close(ref, port, exact=False)


# ----------------------------------------------------------------------
# the defaults, and snapshots across the packages
# ----------------------------------------------------------------------
def test_defaults_hold_the_port_to_the_reference():
    """Both packages at their defaults build the guard and the
    fingerprint folds; a few epochs later the parameters, the anomaly
    state and the fingerprints agree."""
    ref, port = _both("defaults", max_epochs=3)
    assert port.anomaly_guard is not None and port.integrity is not None
    assert port.region.units[-1] is port.anomaly_guard
    ref.run()
    port.run()
    _assert_params_close(ref, port)
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state() == (0, 0, 0)
    got = port.anomaly_guard.read_sdc_fingerprint()
    want = ref.anomaly_guard.read_sdc_fingerprint()
    assert got[3] == want[3] == 0.0
    np.testing.assert_allclose(got, want, rtol=FP_RTOL)


def test_snapshots_cross_with_the_guard_on(tmp_path):
    """A port snapshot taken with the guard on loads in the reference and
    the reverse (the guard's tensors are in neither), and each goes on
    as the other would."""
    ref, port = _both("cross", max_epochs=3)
    for _ in range(4):
        ref.loader.run()
        ref.anomaly_guard.run()
        ref._region_unit.run()
        ref.decision.run()
        port.step()
    assert "anomaly_guard" not in port.state_dict()["__units__"]
    port_path = Snapshotter.write(port.state_dict(), str(tmp_path), "p", "s")
    ref_path = RefSnapshotter.write(ref.state_dict(), str(tmp_path), "r",
                                    "s")
    ref2, port2 = _both("cross2", max_epochs=3)
    ref2.load_state(RefSnapshotter.load(port_path))
    port2.load_state(Snapshotter.load(ref_path))
    _assert_params_close(ref2, port)
    _assert_params_close(ref, port2)
    ref2.run()
    port2.run()
    _assert_params_close(ref2, port2)


# ----------------------------------------------------------------------
# a NaN sample under each training loop
# ----------------------------------------------------------------------
def _run_mode(wf, mode):
    if mode == "run":
        wf.run()
    elif mode == "chunked":
        wf.run_chunked(4)
    elif mode == "accumulated":
        wf.run_accumulated(2)
    else:
        wf.run_pipelined(2, 2)


@pytest.mark.parametrize("mode", ["run", "chunked", "accumulated",
                                  "pipelined"])
def test_a_nan_sample_skips_its_step_bitwise(mode):
    """Sample 5 of the train set carries a NaN: in each epoch the step
    (under accumulation and the pipeline, the optimizer step) that
    gathers it is skipped, every parameter, momentum and microbatch sum
    bit for bit; the verdicts and the run equal the reference's under
    the same loop."""
    if mode in ("accumulated", "pipelined"):
        _config(grad_accum=2)
    ref, port = _both(f"nan_{mode}", max_epochs=2, poison=5)
    skipped, moved = [], []
    last = {"bits": _bits(port), "state": port.anomaly_guard.read_state()}

    def hook():
        bits, state = _bits(port), port.anomaly_guard.read_state()
        if port.loader.minibatch_class == TRAIN:
            if state[1] > last["state"][1]:
                skipped.append(bits == last["bits"])
            else:
                moved.append(bits != last["bits"])
        last.update(bits=bits, state=state)

    port.add_step_hook(hook)
    _run_mode(ref, mode)
    _run_mode(port, mode)
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state()
    assert port.anomaly_guard.read_state()[1] == 2  # once an epoch
    if mode != "chunked":  # a chunk's steps are not seen one by one
        assert skipped == [True, True] and moved and all(moved)
    assert all(np.isfinite(p).all() for p in _port_params(port))
    _assert_params_close(ref, port)


# ----------------------------------------------------------------------
# the guarded update on one unit
# ----------------------------------------------------------------------
def _unit(moment: float, dtype=torch.float32):
    fwd = All2All(input_shape=(5,), output_sample_shape=4,
                  compute_dtype=dtype)
    fwd.initialize(device="cpu")
    gd = GradientDescent(fwd, learning_rate=0.1, gradient_moment=moment,
                         weights_decay=0.01)
    gd.initialize(device="cpu")
    gd.anomaly_flag = torch.ones(2)
    gd.sdc_fingerprint = torch.zeros(5)
    return fwd, gd


@pytest.mark.parametrize("moment,dtype", [
    (0.0, torch.float32), (0.9, torch.float32), (0.9, torch.bfloat16)])
def test_the_guarded_update_forms(moment, dtype):
    """A skipped tensor keeps its parameter and momentum bit for bit,
    ``-0.0`` included; a finite step is bit-equal to the unguarded
    update; a non-finite gradient clears the running flag, so the
    tensors updated after it are skipped too.  In bf16 mode the momentum
    is stored in bf16 (the select rounds the step as the copy does)."""
    if dtype == torch.bfloat16:
        root.common.precision_type = "bfloat16"
    fwd, gd = _unit(moment, dtype)
    plain_fwd, plain = _unit(moment, dtype)
    if moment:
        assert gd.accumulated_gradient_weights.dtype == (
            torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    plain.anomaly_flag = plain.sdc_fingerprint = None
    with torch.no_grad():
        plain_fwd.weights.copy_(fwd.weights)
        plain_fwd.bias.copy_(fwd.bias)
    rng = np.random.default_rng(3)
    gw = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    gb = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    for unit in (gd, plain):
        unit.apply_weights(gw)
        unit.apply_bias(gb)
    assert _bits(_Pair(fwd, gd)) == _bits(_Pair(plain_fwd, plain))
    assert gd.anomaly_flag.tolist() == [1.0, 1.0]
    with torch.no_grad():
        fwd.weights.view(-1)[0] = -0.0
    before = _bits(_Pair(fwd, gd))
    bad = gw.clone()
    bad[2, 1] = float("inf")
    gd.apply_weights(bad)   # clears the running flag
    gd.apply_bias(gb)       # a finite gradient after it: skipped too
    assert _bits(_Pair(fwd, gd)) == before
    assert gd.anomaly_flag.tolist() == [0.0, 1.0]
    assert torch.equal(fwd.weights.view(-1)[0], torch.tensor(-0.0)) \
        and torch.signbit(fwd.weights.view(-1)[0])
    assert sorted(gd._fp_folded) == [f"{fwd.name}.bias",
                                     f"{fwd.name}.weights"]


def _ref_unit_update(grad_scale: float, oracle: bool):
    """The reference's All2All/GradientDescent pair with a guard flag,
    one update from an error of ``grad_scale``: (weights before, after,
    the flag)."""
    from znicz_tpu.dummy import DummyUnit, DummyWorkflow
    from znicz_tpu.memory import Vector
    from znicz_tpu.ops import all2all as ref_all2all
    from znicz_tpu.ops import gd as ref_gd
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    err = (grad_scale * rng.normal(size=(8, 4))).astype(np.float32)
    device = NumpyDevice() if oracle else XLADevice()
    wf = DummyWorkflow()
    source = DummyUnit(wf, output=Vector(x, name="x"))
    fwd = ref_all2all.All2All(wf, 4)
    fwd.link_attrs(source, ("input", "output"))
    fwd.initialize(device=device)
    err_source = DummyUnit(wf, err=Vector(err, name="err"))
    bwd = ref_gd.GradientDescent(wf, learning_rate=0.1)
    bwd.link_attrs(fwd, "input", "output", "weights", "bias")
    bwd.link_attrs(err_source, ("err_output", "err"))
    bwd.initialize(device=device)
    bwd.anomaly_flag = Vector(np.ones(2, np.float32), name="flags")
    bwd.anomaly_flag.initialize(device)
    fwd.weights.map_read()
    before = fwd.weights.mem.copy()
    fwd.run()
    bwd.run()
    for vec in (fwd.weights, bwd.anomaly_flag):
        vec.map_read()
    return before, fwd.weights.mem.copy(), bwd.anomaly_flag.mem.tolist()


@pytest.mark.parametrize("oracle", [False, True])
def test_a_finite_gradient_whose_square_sum_overflows(oracle):
    """C16's mechanism (the full-width sequence stack at its old rate on
    the card): every element of the gradient finite, its Σ g² past
    f32's range.  The device form sums the squares in f32, as the
    reference's XLA form does, so the step is an anomaly and is skipped;
    the numpy oracle sums them in f64, as the reference's numpy form
    does, and applies it."""
    ref_before, ref_after, ref_flags = _ref_unit_update(1e19, oracle)
    fwd, gd = _unit(0.0)
    gw = torch.from_numpy(
        1e19 * np.random.default_rng(6).normal(size=(5, 4))
        .astype(np.float32))
    assert bool(torch.isfinite(gw).all())
    assert not bool(torch.isfinite((gw * gw).sum()))
    before = fwd.weights.detach().clone()
    if oracle:
        gd.numpy_apply_weights(gw.numpy())
    else:
        gd.apply_weights(gw)
    skipped = torch.equal(fwd.weights, before)
    ref_skipped = np.array_equal(ref_after, ref_before)
    assert skipped == ref_skipped == (not oracle)
    assert gd.anomaly_flag.tolist()[0] == ref_flags[0] == \
        (1.0 if oracle else 0.0)


class _Pair:
    """A forward and its backward unit seen as a two-unit workflow."""

    def __init__(self, fwd, gd):
        self.forwards, self.gds = [fwd], [gd]


def test_accumulation_commits_once_at_apply():
    """Under accumulation the guard commits in the apply phase only and
    resets the flags there; the accumulate phase ANDs the loss verdicts
    of the microbatches."""
    port = _both("phases", max_epochs=1)[1]
    guard, ev = port.anomaly_guard, port.evaluator
    with _Phase(("accum", 2)):
        ev._seed_step_flags(torch.tensor(False))
        guard.device_run()
    assert guard.step_flags.tolist() == [0.0, 0.0]
    assert guard.anomaly_state.tolist() == [0, 0, 0]
    with _Phase(("apply", 2)):
        ev._seed_step_flags(torch.tensor(True))
        guard.device_run()
    assert guard.anomaly_state.tolist() == [1, 1, 0]
    assert guard.step_flags.tolist() == [1.0, 1.0]


# ----------------------------------------------------------------------
# the region's bookkeeping around its graphs
# ----------------------------------------------------------------------
def test_graphed_guard_fixes_its_tensors_and_captures_nothing_new(
        monkeypatch, tmp_path):
    """With a stand-in for the CUDA graph API (a capture runs the
    members, a replay runs nothing): the guard's tensors are fixed in
    the train step's capture, arming a drill leaf writes it in place,
    and a rollback's load writes the captured tensors in place, so no
    replay is refused and no key is captured again."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(self)

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(JitRegion, "graphed",
                        property(lambda self: self.mark is None))
    _config(faults={"train.nonfinite_loss": {"at": [3]}})
    port = _both("graphed", max_epochs=1, snap_dir=str(tmp_path))[1]
    guard = port.anomaly_guard
    for _ in range(3):  # validation, then train steps
        port.step()
    assert port.region.captures == 2
    labels = {label for entry in port.region._cache.values()
              for _, label, *_ in entry.fixed}
    assert {"anomaly_guard.step_flags", "anomaly_guard.anomaly_state",
            "anomaly_guard.fault_inject",
            "anomaly_guard.sdc_fingerprint"} <= labels
    leaf = guard.fault_inject
    port.step()  # the third train arrival: armed in place
    assert guard.fault_inject is leaf and torch.isnan(leaf[0])
    path = Snapshotter.write(port.state_dict(), str(tmp_path), "g", "s")
    port.load_state(Snapshotter.load(path))
    port.step()
    assert port.region.captures == 2 and len(replays) >= 3


# ----------------------------------------------------------------------
# 2-rank gloo worlds
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def guard_world(tmp_path_factory):
    return worker.spawn_world("guard", 2, tmp_path_factory.mktemp("guard"))


def test_zero1_and_tp_verdicts_agree_on_every_rank(guard_world):
    """A NaN in one rank's block of a gradient after the ZeRO-1
    reduce-scatter, and in one model block under tensor parallelism:
    the verdict is folded over the axis, so both ranks skip the tensor
    (and the ones after it) and keep every parameter and momentum bit
    for bit; a finite update moves both."""
    for arm in ("zero1", "tp"):
        ranks = [r[arm] for r in guard_world]
        assert all(r["skipped_unchanged"] for r in ranks), arm
        assert all(r["finite_moved"] for r in ranks), arm
        assert [r["flags"] for r in ranks] == [[0.0, 1.0]] * 2, arm


def test_sharded_fingerprints_are_the_logical_tensors(guard_world):
    """The fold of each rank's block, summed over the axes that split
    it, is the reference's fingerprint of the logical tensor: a ZeRO-1
    gradient shard and the replicated parameter around it, a
    column-parallel parameter and its gradient block."""
    from znicz_tpu.resilience.integrity import tensor_fingerprint
    for rank in guard_world:
        for name, (got, logical) in rank["fingerprints"].items():
            want = float(tensor_fingerprint(np, logical))
            assert got == pytest.approx(want, rel=1e-6), name


def test_accumulated_zero1_step_skipped_on_both_ranks(guard_world):
    """``run_accumulated(2)`` under ZeRO-1 on 2 ranks with
    ``train.nonfinite_grad`` at the second optimizer step: both ranks
    count it and end equal to the port's one-process run of the same
    recipe, and the guarded fingerprint of the logical parameters is
    the one-process run's."""
    root.common.engine.grad_accum = 2
    root.common.engine.faults = {"train.nonfinite_grad": {"at": [2]}}
    prng.seed_all(1234)
    single = worker.build_fc(hidden2=None)
    single.initialize(device="cpu")
    single.run_accumulated(2)
    want = worker.params(single)
    for rank in guard_world:
        got = rank["accumulated"]
        assert got["state"] == list(single.anomaly_guard.read_state())
        for a, b in zip(got["params"], want, strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got["fingerprint"][:3],
            single.anomaly_guard.read_sdc_fingerprint()[:3], rtol=FP_RTOL)
