"""``root.common.engine.debug_checks`` on the port, on the CPU (the
reference's ``tests/test_debug_checks.py``, ported, and what the port's
flags add).

The reference compiles its region through ``checkify`` and raises a
located error with "nan" in its text.  A CUDA graph cannot raise partway
through a replay, so every member of a port region step writes a device
flag for each floating tensor it wrote, and the host reads the flags
after the step and raises, naming the first unit in step order that
wrote a NaN, and the tensor.

- A ``log`` unit in a region: a negative input raises with "nan", a
  clean run passes, and the checks are off by default (the NaN flows
  through).
- A NaN planted in place in one unit's parameters of a
  ``StandardWorkflow`` (the sequence stack's layer norm γ, a dense
  layer's weights) raises naming that unit; with the checks on a clean
  run is bit-equal to the run with them off.
- The key: with a stand-in for the CUDA graph API, switching the checks
  on captures one more graph and switching them off replays the old
  one; with them off no flag is written.
- ``run_chunk`` with the checks reads the flags after every step;
  ``run_accum`` refuses them; the numpy oracle checks each unit after
  its ``numpy_run``.
- The other checkify checks: the port's index sites (the embedding
  clamps its ids; the evaluator's gather of the labels, which torch
  bounds-checks itself) and no integer division.
"""

import contextlib

import numpy as np
import pytest
import torch

from znicz_tpu_torch import accelerated_units
from znicz_tpu_torch.accelerated_units import AcceleratedUnit, JitRegion
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops.evaluator import EvaluatorSoftmax
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


class LogUnit(AcceleratedUnit):
    """log(input): NaN for negative inputs."""

    WRITES = ("output",)

    def __init__(self, values, **kwargs):
        super().__init__(None, name="log", **kwargs)
        self.input = torch.tensor(values, dtype=torch.float32)
        self.output = None

    def device_run(self):
        self.output = torch.log(self.input)


def _region(values):
    unit = LogUnit(values)
    unit.initialize(device="cpu")
    return unit, JitRegion("dbg", [unit], unit.device)


def test_nan_raises_located_error():
    root.common.engine.debug_checks = True
    unit, region = _region([1.0, -1.0])
    with pytest.raises(RuntimeError, match="nan in 'output' written by "
                                           "unit 'log'"):
        region.run()


def test_clean_run_passes_with_checks_on():
    root.common.engine.debug_checks = True
    unit, region = _region([1.0, 2.0])
    region.run()
    np.testing.assert_allclose(unit.output.numpy(), np.log([1.0, 2.0]),
                               rtol=1e-6)


def test_checks_off_is_silent_default():
    assert root.common.engine.get("debug_checks", False) is False
    unit, region = _region([1.0, -1.0])
    region.run()  # no flags; the NaN flows through
    assert np.isnan(unit.output[1].item())
    assert region._flags is None


# -- a workflow ---------------------------------------------------------------------
V, T = 12, 8
GD = {"learning_rate": 0.1, "gradient_moment": 0.9}
SEQ = [{"type": "embedding", "->": {"vocab_size": V, "dim": 16}, "<-": GD},
       {"type": "pos_encoding", "->": {}},
       {"type": "attention", "->": {"n_heads": 2, "causal": True}, "<-": GD},
       {"type": "layer_norm", "->": {}, "<-": GD},
       {"type": "last_token", "->": {}},
       {"type": "softmax", "->": {"output_sample_shape": V}, "<-": GD}]


def _seq(device="cpu", layers=SEQ):
    rng = np.random.default_rng(31)
    start = rng.integers(0, V, size=48)
    data = ((start[:, None] + np.arange(T)[None, :]) % V).astype(np.float32)
    labels = ((start + T) % V).astype(np.int32)
    prng.seed_all(5)
    wf = StandardWorkflow(
        name="seq", loader_factory=lambda w: ArrayLoader(
            w, train_data=data[16:], train_labels=labels[16:],
            valid_data=data[:16], valid_labels=labels[:16],
            minibatch_size=8),
        layers=layers, decision_config={"max_epochs": 100})
    wf.initialize(device=device)
    return wf


def _state(wf):
    return {f"{u.name}.{n}": t.detach().clone()
            for u in [*wf.forwards, *wf.gds]
            for n, t in [*u.named_parameters(recurse=False),
                         *u.named_buffers(recurse=False)]}


def test_checks_on_is_bit_equal_to_checks_off():
    """Six steps (validation and train, the epoch boundary) of the
    sequence stack with the checks on and off: every state tensor and
    the evaluator's sums equal to the bit."""
    runs = []
    for checks in (False, True):
        root.common.engine.debug_checks = checks
        wf = _seq()
        for _ in range(6):
            wf.step()
        runs.append((_state(wf), wf.evaluator.epoch_loss.clone()))
    (off, loss_off), (on, loss_on) = runs
    assert set(on) == set(off)
    for key in off:
        assert torch.equal(on[key], off[key]), key
    assert torch.equal(loss_on, loss_off)


def test_planted_nan_names_its_unit():
    """A NaN planted in place in the layer norm's γ: the step raises
    naming the layer-norm unit and its output, the first unit in step
    order to write a NaN (everything after it is NaN too)."""
    root.common.engine.debug_checks = True
    wf = _seq()
    wf.step()
    ln = wf.forwards[3]
    with torch.no_grad():
        ln.weights[2] = float("nan")
    with pytest.raises(RuntimeError, match=f"nan in 'output' written by "
                                           f"unit '{ln.name}'"):
        wf.step()


def test_planted_nan_in_a_gradient_names_the_backward_unit():
    """A NaN in the error the softmax's backward writes (its forward's
    weights poisoned after the forward ran): the backward unit is
    named, with the tensor it wrote."""
    root.common.engine.debug_checks = True
    wf = _seq()
    head, gd_head = wf.forwards[-1], wf.gds[-1]
    while True:
        wf.loader.run()
        if wf.loader.minibatch_class == TRAIN:
            break
    region = wf.region
    poisoned = []

    def poison(name):
        if name == wf.evaluator.name:
            with torch.no_grad():
                head.weights[0, 0] = float("nan")
            poisoned.append(name)

    region.mark = poison
    with pytest.raises(RuntimeError, match=f"written by unit "
                                           f"'{gd_head.name}'"):
        region.run()
    assert poisoned


def _fake_graphs(monkeypatch):
    """A stand-in for the CUDA graph API on the CPU: a capture runs the
    members, a replay runs nothing."""
    class Graph:
        def replay(self):
            pass

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


def test_checks_are_part_of_the_key(monkeypatch):
    """Checks off: one capture, no flag written.  On: one more capture
    (the flags written in its warm-up and capture).  Off again: the old
    graph replays, no capture."""
    _fake_graphs(monkeypatch)
    unit, region = _region([1.0, 2.0])
    flags = accelerated_units.nan_flag
    before = flags.launches
    region.run()
    region.run()
    assert region.captures == 1 and flags.launches == before
    (off_key,) = region._cache
    root.common.engine.debug_checks = True
    region.run()
    assert region.captures == 2
    on_key = next(k for k in region._cache if k != off_key)
    assert on_key == off_key + ("debug_checks",)
    region.run()  # a replay: the flags of the capture's count, once
    assert region.captures == 2
    root.common.engine.debug_checks = False
    region.run()
    assert region.captures == 2


def test_run_chunk_reads_the_flags_every_step(monkeypatch):
    root.common.engine.debug_checks = True
    unit, region = _region([1.0, 2.0])
    reads = []
    check = JitRegion._check_flags
    monkeypatch.setattr(JitRegion, "_check_flags",
                        lambda self: (reads.append(1), check(self)))
    region.run_chunk(5)
    assert len(reads) == 5
    unit.input = torch.tensor([1.0, -1.0])
    with pytest.raises(RuntimeError, match="nan"):
        region.run_chunk(3)
    assert len(reads) == 6  # the first step of the chunk raised


def test_run_chunked_workflow_with_checks():
    """``run_chunked`` with the checks on ends where ``run`` does."""
    root.common.engine.debug_checks = True
    a, b = _seq(), _seq()
    a.decision.max_epochs = b.decision.max_epochs = 2
    a.run()
    b.run_chunked(4)
    sa, sb = _state(a), _state(b)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def test_run_accum_refuses_the_checks():
    root.common.engine.debug_checks = True
    unit, region = _region([1.0, 2.0])
    with pytest.raises(NotImplementedError, match="run_accum"):
        region.run_accum(2)


def test_the_oracle_checks_each_unit():
    """On the numpy oracle the check is a host check after each
    ``numpy_run``: a NaN planted in the layer norm's γ names it."""
    root.common.engine.debug_checks = True
    wf = _seq(device="numpy")
    wf.step()
    ln = wf.forwards[3]
    with torch.no_grad():
        ln.weights[2] = float("nan")
    with pytest.raises(RuntimeError, match=f"numpy oracle: debug check "
                                           f"failed: nan in 'output' "
                                           f"written by unit '{ln.name}'"):
        wf.step()


def test_index_sites():
    """checkify's index checks have two kinds of site in the ported
    units: the embedding's gather, which clamps its ids into the
    vocabulary (so no id is out of range), and the evaluator's gather of
    the labels, whose range torch checks itself (an IndexError on the
    CPU, a device-side assert on the card).  No unit divides integers."""
    ev = EvaluatorSoftmax()
    ev.initialize(device="cpu")
    p = torch.full((4, 3), 1.0 / 3)
    with pytest.raises(IndexError):
        ev.evaluate(p, torch.zeros(4, dtype=torch.int32),
                    torch.tensor([0, 1, 3, 1], dtype=torch.int32),
                    torch.tensor(4), TRAIN)
    wf = _seq()
    emb = wf.forwards[0]
    ids = emb.tokens(torch.tensor([[-3.0, 0.4, 11.6, 40.0]]))
    assert ids.tolist() == [[0, 0, V - 1, V - 1]]
