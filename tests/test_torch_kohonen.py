"""The Kohonen units and the ``kohonen`` sample of the port against the
reference, on the CPU (the port of ``tests/test_kohonen.py``).

- ``KohonenForward`` and ``KohonenTrainer`` over three steps against
  the reference's ``xla_run`` at the reference test's bars: the winners
  equal, the distances and the weights within rtol 1e-4 / atol 1e-5,
  the clock at 3; on the numpy oracle bit-equal to the reference's.
- The clock and the schedule after k steps: ``time`` = k, and the
  update at step k takes σ(k) and lr(k) (the trainer's step equals the
  update written out at that σ and rate); eval steps leave both alone;
  the hits count every sample.
- ``kohonen`` through ``Main().run([... "-b", "numpy"])`` bit-equal to
  the reference's ``NumpyDevice`` run over 3 epochs (the epoch QE and
  the weights); on ``-b cpu`` one epoch against the
  reference's ``xla_run`` (the epoch QE within 1e-4 relative, the
  weights at rtol 1e-4 / atol 1e-5), and the reference test's bar
  (best QE < 0.5 × the first epoch's, in 10 epochs), ``--chunk 4`` the
  same to the bit.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector as RefVector
from znicz_tpu.models.samples import kohonen as ref_kohonen
from znicz_tpu.ops import kohonen as ref_ops
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.models.samples import kohonen
from znicz_tpu_torch.ops.kohonen import (KohonenForward, KohonenTrainer,
                                         grid_coords)
from znicz_tpu_torch.utils.config import reset_root, root

RNG = np.random.default_rng(77)
SEED = 1234
#: the reference test's bars between its numpy and XLA steps
RTOL, ATOL = 1e-4, 1e-5
#: the epoch QE of the port's CPU run against the reference's xla_run
QE_RTOL = 1e-4
#: the reference test's bar: the best QE of a 10-epoch run under this
#: share of the first epoch's
QE_BAR, BAR_EPOCHS = 0.5, 10
GRID = (3, 4)


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    ref_root.common.engine.anomaly_guard = False
    yield
    reset_root()


def _ref_pair(device, x, w, **trainer_kwargs):
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=RefVector(x.copy(), name="x"))
    fwd = ref_ops.KohonenForward(wf, shape=GRID)
    fwd.link_attrs(src, ("input", "output"))
    fwd.weights.reset(w.copy())
    fwd.initialize(device=device)
    tr = ref_ops.KohonenTrainer(wf, **trainer_kwargs)
    tr.link_attrs(src, ("input", "output"))
    tr.link_attrs(fwd, "weights", "winners")
    tr.shape_grid = GRID
    tr.initialize(device=device)
    return fwd, tr


def _port_pair(device, x, w, **trainer_kwargs):
    fwd = KohonenForward(input_shape=x.shape[1:], shape=GRID)
    fwd.load_params({"weights": torch.from_numpy(w.copy())})
    fwd.initialize(device=device)
    tr = KohonenTrainer(**trainer_kwargs)
    tr.link_attrs(fwd, "weights", "winners")
    tr.shape_grid = GRID
    tr.initialize(device=device)
    value = x.copy() if device == "numpy" else torch.from_numpy(x)
    fwd.input = tr.input = value
    return fwd, tr


def _ref_values(fwd, tr):
    for vec in (fwd.winners, fwd.output, fwd.weights, fwd.hits, tr.time):
        vec.map_read()
    return (fwd.winners.mem.copy(), fwd.output.mem.copy(),
            fwd.weights.mem.copy(), fwd.hits.mem.copy(), float(tr.time.mem))


def _np(value):
    return np.array(value if isinstance(value, np.ndarray)
                    else value.detach().numpy())


def _port_values(fwd, tr):
    return (_np(fwd.winners), _np(fwd.output), _np(fwd.weights),
            _np(fwd.hits), float(tr.time))


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_forward_and_trainer_against_the_reference(device):
    x = RNG.normal(size=(10, 5)).astype(np.float32)
    w = RNG.normal(size=(12, 5)).astype(np.float32)
    kwargs = {"learning_rate": 0.4, "decay_steps": 50}
    ref = _ref_pair(RefNumpyDevice() if device == "numpy" else XLADevice(),
                    x, w, **kwargs)
    port = _port_pair(device, x, w, **kwargs)
    for _ in range(3):           # three steps advance the clock too
        for fwd, tr in (ref, port):
            fwd.run()
            tr.run()
    want, got = _ref_values(*ref), _port_values(*port)
    np.testing.assert_array_equal(got[0], want[0])     # winners
    np.testing.assert_array_equal(got[3], want[3])     # hits
    assert got[4] == want[4] == 3.0
    if device == "numpy":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)


def test_winner_golden():
    w = np.zeros((12, 2), np.float32)
    w[7] = [1.0, 1.0]
    x = np.array([[0.9, 1.1], [-5.0, -5.0]], np.float32)
    fwd, _ = _port_pair("cpu", x, w)
    fwd.run()
    assert int(fwd.winners[0]) == 7     # the [1, 1] neuron is nearest
    assert int(fwd.winners[1]) == 0     # a tie of eleven: the first
    assert int(fwd.hits.sum()) == 2


def test_clock_and_schedule_after_k_steps():
    x = RNG.normal(size=(8, 3)).astype(np.float32)
    w = RNG.normal(size=(12, 3)).astype(np.float32)
    fwd, tr = _port_pair("cpu", x, w, learning_rate=0.5, decay_steps=4,
                         sigma_inf=0.25)
    assert tr.sigma0 == 2.0             # half the grid's longer side
    coords = grid_coords(*GRID)
    for k in range(6):
        fwd.run()
        before = tr.weights.detach().numpy().copy()
        tr.run()
        assert float(tr.time) == k + 1
        frac = min(k / 4.0, 1.0)
        sigma = 2.0 * (0.25 / 2.0) ** frac
        lr = 0.5 * 0.01 ** frac
        win = fwd.winners.long().numpy()
        d2 = ((coords[win][:, None, :] - coords[None]) ** 2).sum(-1)
        h = np.exp(-d2 / (2.0 * sigma * sigma))
        want = before + lr / len(x) * (h.T @ x - h.sum(0)[:, None] * before)
        np.testing.assert_allclose(tr.weights.detach().numpy(), want,
                                   rtol=1e-5, atol=1e-6)
    assert int(fwd.hits.sum()) == 6 * len(x)
    tr.forward_mode = "eval"
    before = tr.weights.detach().clone()
    fwd.run()
    tr.run()
    assert torch.equal(tr.weights, before) and float(tr.time) == 6.0


# -- the sample -------------------------------------------------------------------
def _ref_sample(device, epochs: int):
    ref_prng.seed_all(SEED)
    wf = ref_kohonen.build(max_epochs=epochs)
    wf.initialize(device=device)
    qes = []
    on_epoch_ended = wf.decision.on_epoch_ended

    def record():
        on_epoch_ended()
        qes.append(wf.decision.epoch_qe)

    wf.decision.on_epoch_ended = record
    wf.run()
    wf.forward.weights.map_read()
    return qes, np.array(wf.forward.weights.mem)


def _port_sample(backend: str, epochs: int, *args):
    qes = []
    on_epoch_ended = kohonen.DecisionSOM.on_epoch_ended

    def record(decision):
        on_epoch_ended(decision)
        qes.append((decision.epoch_qe, decision.neurons_used))

    kohonen.DecisionSOM.on_epoch_ended = record
    try:
        main = Main()
        assert main.run(["kohonen", "-b", backend, "--seed", str(SEED),
                         *args, "--root", f"kohonen.max_epochs={epochs}"]) \
            == 0
    finally:
        kohonen.DecisionSOM.on_epoch_ended = on_epoch_ended
    wf = main.launcher.workflow
    assert wf.decision.complete
    return wf, qes


def test_kohonen_on_the_oracle_equals_the_references():
    np.testing.assert_array_equal(kohonen.make_data(),
                                  ref_kohonen.make_data())
    assert dict(root.kohonen.as_dict()) == dict(ref_root.kohonen.as_dict())
    port, qes = _port_sample("numpy", 3)
    assert port.region is None
    want_qe, want_w = _ref_sample(RefNumpyDevice(), 3)
    assert [q for q, _ in qes] == want_qe and len(want_qe) == 3
    np.testing.assert_array_equal(port.forward.weights.detach().numpy(),
                                  want_w)


def test_kohonen_on_the_cpu_against_xla_run_and_the_bar():
    port, qes = _port_sample("cpu", 1)
    want_qe, want_w = _ref_sample(XLADevice(), 1)
    assert abs(qes[0][0] - want_qe[0]) <= QE_RTOL * want_qe[0]
    np.testing.assert_allclose(port.forward.weights.detach().numpy(),
                               want_w, rtol=RTOL, atol=ATOL)
    runs = [_port_sample("cpu", BAR_EPOCHS, *chunk)
            for chunk in ([], ["--chunk", "4"])]
    (wf, qes), (chunked, chunked_qes) = runs
    assert wf.region.captures == 0 and len(qes) == BAR_EPOCHS
    assert wf.decision.best_qe < QE_BAR * qes[0][0], qes
    assert chunked_qes == qes
    assert torch.equal(chunked.forward.weights, wf.forward.weights)
