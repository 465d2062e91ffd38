"""The training step as a region (``znicz_tpu_torch.accelerated_units``)
and the chunked loop (``StandardWorkflow.run_chunked``) on the CPU,
against the port's own per-step ``run()`` and the reference.

On the CPU a region runs its members eagerly, through the same code a
CUDA graph captures on the card, so these runs pin what a graph must
reproduce: every per-step input is device state the step advances (the
loader's device schedule, the seed chains, the evaluator's sums), and
a chunk of k steps with no host work between them gives the bits of k
single steps.

- CIFAR-10's layers at full width on a small dataset (short last
  minibatches in every class): ``run_chunked(8)`` equals ``run()`` bit
  for bit, and the reference's ``run_chunked(8)`` within the f32
  tolerance of ``tests/test_torch_cifar.py``;
- a small AlexNet (conv, max pooling, LRN, dropout at 0.5, fully
  connected): chunked equals per-step bit for bit, with masks that
  change every step (the counterpart of the reference's
  ``test_run_chunked_with_dropout_prng``);
- a resume mid-epoch writes the device cursor and the seed chains back,
  and goes on bit for bit, chunked or not;
- the unit graph (``generate_graph``) has the reference's nodes and
  edges, before and after ``initialize`` (the reference without its
  anomaly guard, which the port has not ported);
- the region's bookkeeping around its graphs, with a stand-in for the
  CUDA graph API: a replay binds its capture's outputs, and refuses a
  device tensor rebound since the capture.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.samples import cifar as ref_cifar
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.accelerated_units import AcceleratedUnit, JitRegion
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples import cifar
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

#: tests/test_torch_cifar.py's f32 tolerance, of each tensor's largest |value|
TOL_F32 = 1e-5
SEED = 17


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _images(n, size=32, classes=10, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, classes, n).astype(np.int32))


def _loader(cls, n_test=6, n_valid=10, n_train=28, batch=8, size=32,
            classes=10):
    """Test, validation and train sets whose last minibatch is short."""
    x, y = _images(n_test + n_valid + n_train, size, classes)
    a, b = n_test, n_test + n_valid
    return lambda w: cls(w, test_data=x[:a], test_labels=y[:a],
                         valid_data=x[a:b], valid_labels=y[a:b],
                         train_data=x[b:], train_labels=y[b:],
                         minibatch_size=batch,
                         normalization_scale=2.0 / 255.0,
                         normalization_bias=-1.0)


def _cifar_layers():
    return cifar.layers(dict(root.cifar.as_dict()))


def _port_cifar(epochs=2, seed=SEED):
    prng.seed_all(seed)
    wf = StandardWorkflow(name="cifar", loader_factory=_loader(ArrayLoader),
                          layers=_cifar_layers(),
                          decision_config={"max_epochs": epochs})
    wf.initialize(device="cpu")
    return wf


def _tensors(state: dict) -> dict:
    return {f"{unit}.{k}": np.asarray(v) for unit, values in
            state["__units__"].items() for k, v in values.items()
            if isinstance(v, np.ndarray) and v.dtype.kind == "f"}


def _assert_same_run(a, b):
    """Bit for bit: every tensor and counter of the two snapshots, and
    the generator."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["__units__"].keys() == sb["__units__"].keys()
    for unit, values in sa["__units__"].items():
        other = sb["__units__"][unit]
        assert values.keys() == other.keys(), unit
        for key, value in values.items():
            np.testing.assert_array_equal(np.asarray(other[key]),
                                          np.asarray(value),
                                          err_msg=f"{unit}.{key}")
    assert str(sa["__prng__"]) == str(sb["__prng__"])


def test_cifar_chunked_equals_per_step_and_the_reference():
    per_step = _port_cifar()
    steps = []
    per_step.add_step_hook(lambda: steps.append(
        per_step.loader.minibatch_class))
    per_step.run()
    chunked = _port_cifar()
    chunks = []
    chunked.add_step_hook(lambda: chunks.append(
        (chunked.loader.minibatch_class, chunked.loader._cursor)))
    regions = []
    run_chunk = chunked.region.run_chunk
    chunked.region.run_chunk = lambda n: regions.append(n) or run_chunk(n)
    chunked.run_chunked(8)
    # 2 epochs of 1 test, 2 validation and 4 train minibatches; a chunk
    # never crosses a class, so 3 chunks an epoch
    assert len(steps) == 14 and regions == [1, 2, 4] * 2
    assert [c for c, _ in chunks] == [0, 1, TRAIN] * 2
    assert chunked.decision.complete and chunked.loader.epoch_number == 1
    _assert_same_run(per_step, chunked)
    assert per_step.decision.epoch_n_err_pt == chunked.decision.epoch_n_err_pt

    ref_root.common.precision_type = "float32"
    ref_prng.seed_all(SEED)
    ref = RefWorkflow(name="cifar", loader_factory=_loader(RefLoader),
                      layers=ref_cifar.layers(dict(ref_root.cifar.as_dict())),
                      decision_config={"max_epochs": 2}, anomaly_guard=False)
    ref._max_fires = 10 ** 6
    ref.initialize(device=XLADevice())
    ref.run_chunked(8)
    # the port's tensors (parameters, momentum, evaluator sums); the
    # reference's snapshot also holds its per-step activations
    want = _tensors(ref.state_dict())
    got = _tensors(chunked.state_dict())
    assert len(got) == 17 and set(got) <= set(want)
    for key, g in got.items():
        w = want[key]
        err = float(np.abs(g - w).max())
        assert err <= TOL_F32 * max(float(np.abs(w).max()), 1e-30), key
    assert list(chunked.decision.last_epoch_n_err) == list(
        ref.decision.last_epoch_n_err)
    assert chunked.loader._cursor == ref.loader._cursor


def _small_alexnet(pooling="max_pooling"):
    gd = {"learning_rate": 0.01, "gradient_moment": 0.9,
          "weights_decay": 5e-4}
    return [{"type": "conv_str", "->": {"n_kernels": 8, "kx": 3, "ky": 3,
                                        "padding": 1}, "<-": gd},
            {"type": pooling, "->": {"kx": 2, "ky": 2}},
            {"type": "norm", "->": {"n": 5}},
            {"type": "all2all_str", "->": {"output_sample_shape": 32},
             "<-": gd},
            {"type": "dropout", "->": {"dropout_ratio": 0.5}},
            {"type": "all2all_str", "->": {"output_sample_shape": 16},
             "<-": gd},
            {"type": "dropout", "->": {"dropout_ratio": 0.5}},
            {"type": "softmax", "->": {"output_sample_shape": 5},
             "<-": gd}]


def _port_alexnet(epochs=3, seed=SEED, dtype="float32",
                  pooling="max_pooling"):
    root.common.precision_type = dtype
    prng.seed_all(seed)
    wf = StandardWorkflow(
        name="alexnet_small",
        loader_factory=_loader(ArrayLoader, n_test=0, n_valid=6, n_train=20,
                               batch=6, size=12, classes=5),
        layers=_small_alexnet(pooling), decision_config={"max_epochs": epochs})
    wf.initialize(device="cpu")
    return wf


def _record_seeds(wf):
    seeds = []
    wf.add_step_hook(lambda: seeds.append(tuple(
        None if u.seed is None else int(u.seed) for u in wf.forwards
        if hasattr(u, "seed"))))
    return seeds


@pytest.mark.parametrize("dtype,pooling", [
    ("float32", "max_pooling"), ("bfloat16", "max_pooling"),
    ("float32", "stochastic_pooling")])
def test_alexnet_with_dropout_chunked_equals_per_step(dtype, pooling):
    """Chunks of 3 against single steps; with stochastic pooling too,
    whose draws come from its own seed chain."""
    per_step = _port_alexnet(dtype=dtype, pooling=pooling)
    seeds = _record_seeds(per_step)
    per_step.run()
    train = [s for s in seeds if s[-1] is not None]
    assert len(train) == 3 * 4 and len(set(train)) == len(train)
    assert len(train[0]) == (3 if pooling == "stochastic_pooling" else 2)
    chunked = _port_alexnet(dtype=dtype, pooling=pooling)
    chunked.run_chunked(3)
    _assert_same_run(per_step, chunked)
    # each chain's next seed is where twelve train steps left it
    for a, b in zip(chunked.forwards, per_step.forwards):
        if hasattr(a, "seed_chain"):
            assert a.seed_chain.get_value() == b.seed_chain.get_value()
    # the backward took the forward's mask: its output is zero where
    # the mask of the step's seed drops
    unit = chunked.forwards[4]
    mask = fk.dropout_apply_plain(torch.ones_like(unit.output), unit.seed,
                                  0.5) != 0
    assert not bool(((unit.output != 0) & ~mask).any())


def test_resume_restores_the_device_cursor_and_the_seed_chains():
    straight = _port_alexnet(epochs=3)
    straight.run()
    first = _port_alexnet(epochs=3)
    for _ in range(9):  # into epoch 1's train minibatches
        first.step()
    state = first.state_dict()
    assert state["__units__"]["DropoutForward"]["seed_chain"] is not None
    for chunk in (1, 3):
        prng.seed_all(1)  # the resume must not depend on the ambient seed
        resumed = _port_alexnet(epochs=3, seed=99)
        cursor = resumed.loader.sched_cursor.devmem
        ptr = cursor.data_ptr()
        resumed.load_state(state)
        resumed.step()
        # the device cursor continues the host's, written in place
        assert resumed.loader.sched_cursor.devmem.data_ptr() == ptr
        assert int(cursor) == resumed.loader._cursor % len(
            resumed.loader._schedule)
        resumed.run_chunked(chunk) if chunk > 1 else resumed.run()
        _assert_same_run(straight, resumed)


def test_replay_accounting_of_the_launch_counters():
    """What a region does with the kernels' counters around a capture:
    take a snapshot, keep what the capture counted, restore the
    counters in place (the plain ints and both kinds of split, dicts
    and Counters), and add the capture's count once a replay."""
    fn = fk.lrn_forward
    before = launch_counts.snapshot()
    start = (fn.launches, fn.launches_by_route["vector"],
             fn.launches_by_shape[25600, 32])
    # a capture that launched the kernel twice at one shape
    fn.launches += 2
    fn.launches_by_route["vector"] += 2
    fn.launches_by_shape[25600, 32] += 2
    fn.launches_by_shape[7, 40] += 1  # a key the snapshot lacks
    gained = launch_counts.delta(before)
    launch_counts.restore(before)
    assert (fn.launches, fn.launches_by_route["vector"],
            fn.launches_by_shape[25600, 32]) == start
    assert (7, 40) not in fn.launches_by_shape
    launch_counts.add(gained, 3)  # three replays
    assert (fn.launches, fn.launches_by_route["vector"],
            fn.launches_by_shape[25600, 32]) == tuple(
        v + 6 for v in start)
    assert fn.launches_by_shape[7, 40] == 3
    launch_counts.restore(before)
    assert (7, 40) not in fn.launches_by_shape


class _Scale(AcceleratedUnit):
    """``output = 2 · weights`` (a new tensor each step, as a forward
    unit's output is) and a step counter written in place."""

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        self.weights = torch.ones(4)
        self.steps = torch.zeros(())

    def device_run(self) -> None:
        self.steps.add_(1)
        self.output = self.weights * 2


def test_a_replay_binds_its_outputs_and_refuses_a_rebound_input(
        monkeypatch):
    """The region's bookkeeping around its graphs, on the CPU with a
    stand-in for the CUDA graph API (a capture runs the members, a
    replay runs nothing): after a capture a unit's output is the
    warm-up's, each replay binds the capture's again (also after the
    host rebound it, or a ``mark``ed step ran eagerly), an in-place
    write passes, and a tensor the graph reads, rebound on the host
    since the capture, makes the next replay raise, naming it."""
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
    units = [_Scale(name="a"), _Scale(name="b")]
    for unit in units:
        unit.initialize(device="cpu")
    region = JitRegion("region", units, units[0].device)
    region.run()  # the warm-up and the capture
    (entry,) = region._cache.values()
    captured = {(id(owner), name): value
                for owner, name, value in entry.outputs}
    assert set(captured) == {(id(u.__dict__), "output") for u in units}
    assert not replays and region.captures == 1
    assert all(u.output is not captured[id(u.__dict__), "output"]
               for u in units)

    def bound():
        return all(u.output is captured[id(u.__dict__), "output"]
                   for u in units)

    region.run()
    assert replays == [entry.graph] and bound()
    units[0].output = torch.zeros(4)  # an output rebound on the host
    region.mark = lambda name: None  # a step run eagerly
    region.run()
    region.mark = None
    assert len(replays) == 1 and not bound()
    units[1].steps.copy_(torch.tensor(7.0))  # in place
    region.run_chunk(3)
    assert len(replays) == 4 and bound()
    units[1].weights = torch.ones(4)  # rebound since the capture
    with pytest.raises(RuntimeError, match="b.weights was rebound"):
        region.run()
    assert len(replays) == 4


def _graph(dot: str) -> tuple[set, set]:
    """(nodes as (name, class), edges as (name, name)) of a DOT text."""
    labels = dict(re.findall(r'(u\d+) \[label="([^"]+)"\]', dot))
    nodes = {tuple(label.split("\\n")) for label in labels.values()}
    edges = {(labels[a].split("\\n")[0], labels[b].split("\\n")[0])
             for a, b in re.findall(r"(u\d+) -> (u\d+);", dot)}
    return nodes, edges


def test_cifar_graph_has_the_reference_nodes_and_edges():
    port = StandardWorkflow(name="cifar", loader_factory=_loader(ArrayLoader),
                            layers=_cifar_layers(),
                            snapshotter_config={"prefix": "cifar"})
    ref = RefWorkflow(name="cifar", loader_factory=_loader(RefLoader),
                      layers=ref_cifar.layers(dict(ref_root.cifar.as_dict())),
                      snapshotter_config={"prefix": "cifar"},
                      anomaly_guard=False)
    assert _graph(port.generate_graph()) == _graph(ref.generate_graph())
    prng.seed_all(SEED)
    port.initialize(device="cpu")
    ref.initialize(device=XLADevice())
    nodes, edges = _graph(port.generate_graph())
    assert (nodes, edges) == _graph(ref.generate_graph())
    assert ("train_region", "RegionUnit") in nodes
    assert {("loader", "train_region"), ("train_region", "decision")} <= {
        (a.replace("ArrayLoader", "loader"), b) for a, b in edges}
