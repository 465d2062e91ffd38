"""The port's auxiliary units (``znicz_tpu_torch/ops/aux_units.py``) and
fixtures (``znicz_tpu_torch/dummy.py``) on the CPU: the cases of the
reference's ``tests/test_aux_units.py`` through the port, and the port
held to the reference.

- ``MultiHistogram`` counts equal ``np.histogram``'s; ``LabelsPrinter``
  clips to the valid count and marks a wrong row;
- ``ChannelSplitter`` on the numpy oracle and the CPU device gives each
  group's channels, validates its groups; ``ToSequence`` (the
  reference's fifth case) against its oracle and trained through an
  attention head;
- parity: the splitter's device run on the CPU bit-equal to its
  ``numpy_run`` and to the reference's ``numpy_run`` and ``xla_run``;
  its outputs written in place (the same storage after two runs, a
  third run after a host read still read back fresh);
- the splitter inside a region with a stand-in for the CUDA graph API:
  captured once, replayed on the addresses it captured, and a rebound
  output refused by the next replay.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit as RefDummyUnit
from znicz_tpu.dummy import DummyWorkflow as RefDummyWorkflow
from znicz_tpu.memory import Vector as RefVector
from znicz_tpu.ops.aux_units import ChannelSplitter as RefChannelSplitter
from znicz_tpu_torch.accelerated_units import AcceleratedUnit, JitRegion
from znicz_tpu_torch.dummy import DummyUnit, DummyWorkflow, vector_of
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.ops.aux_units import (ChannelSplitter, LabelsPrinter,
                                           MultiHistogram)
from znicz_tpu_torch.utils.config import reset_root

RNG = np.random.default_rng(13)
GROUPS = [[0, 1, 2], [3, 5], [4, 0]]


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def test_multi_histogram_counts():
    wf = DummyWorkflow(device="numpy")
    hist = MultiHistogram(wf, n_bins=10)
    data = RNG.normal(size=(50, 20)).astype(np.float32)
    hist.watch("w", vector_of(data, wf.device))
    hist.watch("t", torch.from_numpy(2 * data))
    payload = hist.make_payload()
    counts, _ = hist.histograms["w"]
    assert counts.sum() == data.size
    np.testing.assert_array_equal(
        counts, np.histogram(data.ravel(), bins=10)[0])
    np.testing.assert_array_equal(
        hist.histograms["t"][0], np.histogram(2 * data.ravel(), bins=10)[0])
    assert payload["kind"] == "multi_hist" and set(payload["panels"]) == {
        "w", "t"}


def test_labels_printer_output():
    wf = DummyWorkflow(device="numpy")
    printer = LabelsPrinter(wf, label_names={0: "cat", 1: "dog"}, limit=4)
    src = DummyUnit(
        wf,
        max_idx=vector_of(np.array([0, 1, 1, 0], np.int32), wf.device),
        labels=vector_of(np.array([0, 0, 1, 1], np.int32), wf.device),
        valid=vector_of(np.array(3, np.int32), wf.device))
    printer.link_attrs(src, "max_idx", "labels",
                       ("minibatch_valid", "valid"))
    printer.run()
    assert len(printer.lines) == 3  # clipped to minibatch_valid
    assert "pred=cat true=cat" in printer.lines[0]
    assert printer.lines[1].startswith("✗")  # pred dog, true cat


def _splitter(device, x, groups=GROUPS):
    wf = DummyWorkflow(device=device)
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    split = ChannelSplitter(wf, groups=groups)
    split.link_attrs(src, ("input", "output"))
    split.initialize(device=device)
    return split


def _out(vec) -> np.ndarray:
    vec.map_read()
    return np.array(vec.mem)


@pytest.mark.parametrize("device", ["numpy", "cpu"])
def test_channel_splitter(device):
    x = RNG.normal(size=(4, 5, 5, 6)).astype(np.float32)
    split = _splitter(device, x, [[0, 1, 2], [3, 5]])
    split.run()
    for vec, group in zip(split.outputs, split.groups):
        np.testing.assert_array_equal(_out(vec), x[..., group])
    assert split.output is split.outputs[0]


def test_channel_splitter_validates():
    wf = DummyWorkflow(device="numpy")
    x = RNG.normal(size=(2, 3, 3, 4)).astype(np.float32)
    src = DummyUnit(wf, output=Vector(x, name="x"))
    split = ChannelSplitter(wf, groups=[[0, 9]])
    split.link_attrs(src, ("input", "output"))
    with pytest.raises(ValueError, match="out of range"):
        split.initialize(device="numpy")
    with pytest.raises(ValueError, match="at least one"):
        ChannelSplitter(wf, groups=[])


def _ref_split(device, x):
    wf = RefDummyWorkflow(device=device)
    src = RefDummyUnit(wf, output=RefVector(x.copy(), name="x"))
    split = RefChannelSplitter(wf, groups=GROUPS)
    split.link_attrs(src, ("input", "output"))
    split.initialize(device=device)
    split.run()
    outs = []
    for vec in split.outputs:
        vec.map_read()
        outs.append(np.array(vec.mem))
    return outs


def test_channel_splitter_bit_equal_to_numpy_run_and_the_reference():
    x = RNG.normal(size=(3, 4, 4, 6)).astype(np.float32)
    device = _splitter("cpu", x)
    device.run()  # the device run (torch on the CPU)
    oracle = _splitter("numpy", x)
    oracle.run()  # numpy_run
    for want in (_ref_split(RefNumpyDevice(), x), _ref_split(XLADevice(), x)):
        for i, group in enumerate(GROUPS):
            got = _out(device.outputs[i])
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want[i])
            np.testing.assert_array_equal(_out(oracle.outputs[i]), want[i])
            np.testing.assert_array_equal(got, x[..., group])


def test_channel_splitter_writes_its_outputs_in_place():
    x = RNG.normal(size=(2, 3, 3, 6)).astype(np.float32)
    split = _splitter("cpu", x)
    src = split._linked_attrs["input"].source
    ptrs = [v.devmem.data_ptr() for v in split.outputs]
    split.run()
    first = [_out(v) for v in split.outputs]  # a host read between runs
    src.output.map_write()
    src.output.mem[...] = -x
    src.output.unmap()
    split.run()
    assert [v.devmem.data_ptr() for v in split.outputs] == ptrs
    for vec, group, was in zip(split.outputs, GROUPS, first):
        np.testing.assert_array_equal(was, x[..., group])
        np.testing.assert_array_equal(_out(vec), -x[..., group])


class _Source(AcceleratedUnit):
    """The region's first member: writes its input, doubled, into a fixed
    tensor (as a forward writes its output)."""

    def __init__(self, workflow, x) -> None:
        super().__init__(workflow)
        self.x = torch.from_numpy(x.copy())
        self.output = torch.zeros_like(self.x)

    def device_run(self):
        torch.mul(self.x, 2.0, out=self.output)


def test_channel_splitter_in_a_captured_region(monkeypatch):
    """With a stand-in for the CUDA graph API (a capture runs the members
    once, a replay runs them again on the tensors they hold): the region
    captures the source and the splitter once; each replay writes the
    outputs at the captured addresses, equal to ``numpy_run``; an output
    rebound after the capture is refused by the next replay."""
    members = []

    class Graph:
        def replay(self):
            for unit in members:
                unit.device_run()

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
    x = RNG.normal(size=(4, 3, 3, 6)).astype(np.float32)
    wf = DummyWorkflow(device="cpu")
    src = _Source(wf, x)
    src.initialize(device="cpu")
    split = ChannelSplitter(wf, groups=GROUPS)
    split.link_attrs(src, ("input", "output"))
    split.initialize(device="cpu")
    members.extend([src, split])
    region = JitRegion("split_region", members, wf.device)
    ptrs = [v.devmem.data_ptr() for v in split.outputs]
    for step in range(3):
        src.x.copy_(torch.from_numpy(x * (step + 1)))
        region.run()
        assert region.captures == 1
        assert [v.devmem.data_ptr() for v in split.outputs] == ptrs
        oracle = _splitter("numpy", 2.0 * x * (step + 1))
        oracle.run()
        for got, want in zip(split.outputs, oracle.outputs):
            np.testing.assert_array_equal(_out(got), _out(want))
    split.out1._devmem = split.out1._devmem.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        region.run()


def test_to_sequence_trains_end_to_end():
    """``ToSequence`` (the spatial → token flatten): its oracle equals the
    reshape exactly, and a conv-free to_sequence → attention → softmax
    net trains through it on the CPU."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.ops.seq_reshape import ToSequence
    from znicz_tpu_torch.utils import prng

    x = RNG.normal(size=(2, 3, 4, 5)).astype(np.float32)
    unit = ToSequence(x.shape[1:], torch.float32)
    np.testing.assert_array_equal(unit.numpy_forward(x), x.reshape(2, 12, 5))
    np.testing.assert_array_equal(unit(torch.from_numpy(x)).numpy(),
                                  x.reshape(2, 12, 5))

    prng.seed_all(5)
    rng = np.random.default_rng(5)
    protos = rng.normal(0, 1, (3, 8, 8, 2)).astype(np.float32)
    y = rng.integers(0, 3, 96).astype(np.int32)
    data = protos[y] + 0.5 * rng.normal(size=(96, 8, 8, 2))
    wf = StandardWorkflow(
        name="toseq",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data.astype(np.float32), train_labels=y,
            minibatch_size=32),
        layers=[
            {"type": "to_sequence", "->": {}},
            {"type": "attention", "->": {"n_heads": 2},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": 6})
    wf.initialize(device="cpu")
    losses = []
    orig = wf.decision.on_epoch_ended

    def hooked():
        orig()
        losses.append(wf.decision.epoch_loss[2])

    wf.decision.on_epoch_ended = hooked
    wf.run()
    assert losses[-1] < losses[0], losses
