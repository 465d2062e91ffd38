"""The streaming data plane of the port (``znicz_tpu_torch.loader.
streaming``, the counter-based order of ``loader.base``) against the
reference's, on the CPU.

- ``train_order``/``epoch_order``/``schedule_entry`` equal to the
  reference's for epochs 0–3, with and without ``shuffle_limit``, and
  the resident loader's pick unchanged;
- shards written by either package read by the other, bit-equal;
- streamed batches, labels and indices bit-equal to the reference's
  ``StreamingLoader`` over 3 epochs, every step served by a prefetch
  (the epoch's first entries included: the test waits for the batch to
  be staged before each step, no clock); the normalized batch within
  one f32 ulp of the reference's region (XLA fuses its multiply-add, as
  the port's uint8 table rounds once), and on the numpy oracle equal to
  the reference's oracle;
- a 2-process split that partitions each epoch, and the guard on a
  minibatch the processes do not divide;
- a mid-epoch resume, from the port's snapshot and from the
  reference's, delivering the uninterrupted run's sequence;
- the three fault sites with the reference's recovery: a dead reader
  restarted bit-clean, a corrupt shard quarantined to zeros, a short
  read retried;
- a streamed workflow trained beside the reference's (1e-5) and beside
  the resident loader (bit-equal);
- with a stand-in for the CUDA graph API: the in-place delivery
  replays, a rebinding one is refused by the next replay, and a capture
  holds ``CAPTURE_LOCK`` (which the uploader takes on the card).
"""

import contextlib
import os
import time

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyWorkflow
from znicz_tpu.loader.fullbatch import ArrayLoader as RefArrayLoader
from znicz_tpu.loader.streaming import StreamingLoader as RefStreaming
from znicz_tpu.loader.streaming import ShardReader as RefReader
from znicz_tpu.loader.streaming import write_shards as ref_write_shards
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.accelerated_units import CAPTURE_LOCK, JitRegion
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.loader.streaming import (ShardReader, StreamingLoader,
                                              write_shards)
from znicz_tpu_torch.memory import StagingRing, Vector
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.workflow import Workflow

N_CLASSES, DIM = 3, 12
SEED = 77
BATCH = 24


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    root.common.engine.read_backoff_s = 0.0
    ref_root.common.engine.read_backoff_s = 0.0
    yield
    reset_root()


def u8_blobs(n_per_class=60, seed=7):
    """Gaussian blobs quantized to uint8 (the reference test's data)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (N_CLASSES, DIM))
    data = np.concatenate([
        c + 0.3 * rng.normal(size=(n_per_class, DIM)) for c in centers])
    data = np.clip((data + 4.0) * 32.0, 0, 255).astype(np.uint8)
    labels = np.repeat(np.arange(N_CLASSES),
                       n_per_class).astype(np.int32)
    order = rng.permutation(len(data))
    return data[order], labels[order]


@pytest.fixture
def shards(tmp_path):
    data, labels = u8_blobs()
    d = str(tmp_path / "shards")
    write_shards(d, data[:144], labels[:144], valid_data=data[144:],
                 valid_labels=labels[144:], rows_per_shard=50)
    glob = np.concatenate([data[144:], data[:144]])
    glob_lab = np.concatenate([labels[144:], labels[:144]])
    return d, data, labels, glob, glob_lab


def port_streaming(d, seed=SEED, device="cpu", **kwargs):
    prng.seed_all(seed)
    ld = StreamingLoader(Workflow(name="w"), d, minibatch_size=BATCH,
                         **kwargs)
    ld.initialize(device=device)
    return ld


def ref_streaming(d, seed=SEED, **kwargs):
    ref_prng.seed_all(seed)
    ld = RefStreaming(DummyWorkflow(), d, minibatch_size=BATCH, **kwargs)
    ld.initialize(device=NumpyDevice())
    return ld


def staged(ld, timeout=60.0):
    """Block until the pipeline has the next batch uploaded (a gated
    producer, no clock in the assertion): the next step is then a
    prefetch hit."""
    if ld.pipeline is None:
        ld.warmup()
    deadline = time.monotonic() + timeout
    while ld.pipeline.ready_batches == 0:
        if ld.pipeline.error is not None or time.monotonic() > deadline:
            raise AssertionError("the pipeline staged nothing")
        time.sleep(0.001)


def port_step(ld):
    """One step: the indices, count, labels and raw and normalized
    batch delivered."""
    ld.run()
    return (np.asarray(ld.minibatch_indices).copy(),
            int(ld.minibatch_valid),
            np.asarray(ld.minibatch_labels).copy(),
            ld.minibatch_raw.devmem.numpy().copy(),
            np.asarray(ld.minibatch_data).copy(),
            (ld.epoch_number, ld.minibatch_class))


def ref_step(ld):
    ld.run()
    ld.minibatch_raw.map_read()
    ld.minibatch_labels.map_read()
    raw = np.array(ld.minibatch_raw.mem)
    labels = np.array(ld.minibatch_labels.mem)
    ld.numpy_run()
    ld.minibatch_data.map_read()
    return (np.asarray(ld._host_indices).copy(), ld.minibatch_size, labels,
            raw, np.array(ld.minibatch_data.mem),
            (ld.epoch_number, ld.minibatch_class))


# ----------------------------------------------------------------------
# the counter-based order
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shuffle_limit", [None, 2, 0])
def test_orders_equal_the_reference(shuffle_limit):
    data, labels = u8_blobs()
    kw = {} if shuffle_limit is None else {"shuffle_limit": shuffle_limit}
    ref_prng.seed_all(SEED)
    ref = RefArrayLoader(DummyWorkflow(), train_data=data[:144],
                         train_labels=labels[:144], valid_data=data[144:],
                         valid_labels=labels[144:], minibatch_size=BATCH,
                         **kw)
    ref.initialize(device=NumpyDevice())
    prng.seed_all(SEED)
    port = ArrayLoader(Workflow(name="w"), train_data=data[:144],
                       train_labels=labels[:144], valid_data=data[144:],
                       valid_labels=labels[144:], minibatch_size=BATCH,
                       **kw)
    port.initialize(device="cpu")
    assert port._shuffle_seed == ref._shuffle_seed
    for epoch in range(4):
        np.testing.assert_array_equal(port.train_order(epoch),
                                      ref.train_order(epoch))
        np.testing.assert_array_equal(port.epoch_order(epoch),
                                      ref.epoch_order(epoch))
        for cursor in range(len(ref._schedule)):
            for got, want in zip(port.schedule_entry(epoch, cursor),
                                 ref.schedule_entry(epoch, cursor)):
                np.testing.assert_array_equal(got, want)
    # the resident pick over 4 epochs: the reference's indices
    for _ in range(4 * len(ref._schedule)):
        ref.run()
        port.run()
        ref.minibatch_indices.map_read()
        np.testing.assert_array_equal(np.asarray(port.minibatch_indices),
                                      ref.minibatch_indices.mem)
    if shuffle_limit == 0:
        lo, hi = port.class_index_range(TRAIN)
        np.testing.assert_array_equal(port.train_order(3),
                                      np.arange(lo, hi))


# ----------------------------------------------------------------------
# the shard format
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shards_read_across_the_packages(tmp_path, writer):
    data, labels = u8_blobs()
    d = str(tmp_path / "shards")
    (write_shards if writer == "port" else ref_write_shards)(
        d, data[:144], labels[:144], valid_data=data[144:],
        valid_labels=labels[144:], rows_per_shard=50)
    other = str(tmp_path / "other")
    (ref_write_shards if writer == "port" else write_shards)(
        other, data[:144], labels[:144], valid_data=data[144:],
        valid_labels=labels[144:], rows_per_shard=50)
    for name in sorted(os.listdir(d)):  # the same bytes, file by file
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(other, name), "rb") as b:
            assert a.read() == b.read(), name
    port, ref = ShardReader(d), RefReader(d)
    assert port.class_lengths == ref.class_lengths == [0, 36, 144]
    assert port.sample_shape == ref.sample_shape == (DIM,)
    assert port.dtype == ref.dtype and port.nbytes == ref.nbytes
    idx = np.asarray([0, 35, 36, 49, 50, 121, 179])  # across shards
    got = np.empty((len(idx), DIM), np.uint8)
    want = np.empty_like(got)
    port.gather(idx, got)
    ref.gather(idx, want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.labels(idx), ref.labels(idx))


def test_staging_ring_bounds_the_host_memory(shards):
    d = shards[0]
    ld = port_streaming(d, prefetch_depth=3, ring_slots=4)
    try:
        ld.run()
        ring = ld.pipeline.ring
        assert ring.n_slots == 4 and not ring.pinned
        assert ring.nbytes == 4 * BATCH * DIM < ld.dataset_nbytes
        assert len(ld.pipeline.stage_raw) == 3
    finally:
        ld.stop()
    ring = StagingRing(2, (3,), np.int64)
    a, b = ring.acquire(), ring.acquire()
    assert {a, b} == {0, 1} and ring.acquire(timeout=0.01) is None
    ring.release(a)
    assert ring.acquire(timeout=0.01) == a


# ----------------------------------------------------------------------
# the streamed batches
# ----------------------------------------------------------------------
def test_streamed_batches_equal_the_reference(shards):
    d, _, _, glob, glob_lab = shards
    kw = {"normalization_scale": 1 / 127.5, "normalization_bias": -1.0,
          "prefetch_depth": 2}
    ref = ref_streaming(d, **kw)
    port = port_streaming(d, **kw)
    n = 3 * len(port._schedule)
    try:
        for _ in range(n):
            staged(port)
            got, want = port_step(port), ref_step(ref)
            idx, count, labels, raw, data, where = got
            np.testing.assert_array_equal(idx, want[0])
            assert count == want[1] and where == want[5]
            np.testing.assert_array_equal(labels, want[2])
            np.testing.assert_array_equal(raw, want[3])
            np.testing.assert_array_equal(raw, glob[idx])
            np.testing.assert_array_equal(labels, glob_lab[idx])
        # every step a prefetch, both epoch boundaries crossed ahead
        assert port.prefetch_hits == n and port.prefetch_misses == 0
        assert port.epoch_cross_prefetches == 2
        assert metrics.loader_prefetch(port.name, "epoch_cross").value >= 2
        assert metrics.prefetch_depth(port.name).value == 2
        assert metrics.input_stage_seconds(port.name).count >= n
    finally:
        port.stop()
        ref.stop()


def test_streamed_order_equals_the_resident_loaders(shards):
    d, data, labels, _, _ = shards
    prng.seed_all(SEED)
    res = ArrayLoader(Workflow(name="r"), train_data=data[:144],
                      train_labels=labels[:144], valid_data=data[144:],
                      valid_labels=labels[144:], minibatch_size=BATCH,
                      normalization_scale=2 / 255, normalization_bias=-1.0)
    res.initialize(device="cpu")
    port = port_streaming(d, normalization_scale=2 / 255,
                          normalization_bias=-1.0)
    try:
        for _ in range(3 * len(port._schedule)):
            res.run()
            port.run()
            assert torch.equal(port.minibatch_indices, res.minibatch_indices)
            assert torch.equal(port.minibatch_labels, res.minibatch_labels)
            assert torch.equal(port.minibatch_data, res.minibatch_data)
            assert int(port.minibatch_valid) == int(res.minibatch_valid)
    finally:
        port.stop()


def test_numpy_oracle_streams(shards):
    d, _, _, glob, _ = shards
    ref = ref_streaming(d, normalization_scale=1 / 127.5,
                        normalization_bias=-1.0)
    port = port_streaming(d, device="numpy", normalization_scale=1 / 127.5,
                          normalization_bias=-1.0)
    try:
        for _ in range(len(port._schedule) + 2):
            port.run()
            want = ref_step(ref)
            idx = np.asarray(port.minibatch_indices)
            np.testing.assert_array_equal(port.minibatch_raw.mem, glob[idx])
            np.testing.assert_array_equal(port.minibatch_data, want[4])
    finally:
        port.stop()
        ref.stop()


# ----------------------------------------------------------------------
# per-process blocks
# ----------------------------------------------------------------------
def test_two_process_split_partitions_each_epoch(shards):
    d = shards[0]
    loaders = [port_streaming(d, seed=5, process_index=p, process_count=2)
               for p in range(2)]
    refs = [ref_streaming(d, seed=5, process_index=p, process_count=2)
            for p in range(2)]
    try:
        a, b = loaders
        assert a.local_batch == b.local_batch == a.local_rows == 12
        for epoch in (0, 1):
            per_proc = []
            for p, ld in enumerate(loaders):
                rows = []
                for c in range(len(ld._schedule)):
                    np.testing.assert_array_equal(
                        ld.local_indices(epoch, c),
                        refs[p].local_indices(epoch, c))
                    idx, _, count = ld.schedule_entry(epoch, c)
                    lo = p * ld.local_batch
                    if lo < count:  # past count: the pad, masked
                        rows.append(idx[lo:min(lo + ld.local_batch, count)])
                per_proc.append(np.concatenate(rows))
            assert not set(per_proc[0]) & set(per_proc[1])
            assert sorted(np.concatenate(per_proc)) == list(range(180))
        # each process delivers its block of the rows, the global count
        b.run()
        idx, _, count = b.schedule_entry(0, 0)
        np.testing.assert_array_equal(np.asarray(b.minibatch_indices),
                                      idx[12:24])
        assert int(b.minibatch_valid) == count
        assert b.minibatch_raw.devmem.shape == (12, DIM)
    finally:
        for ld in loaders + refs:
            ld.stop()


def test_a_minibatch_the_processes_do_not_divide_is_refused(shards):
    prng.seed_all(1)
    ld = StreamingLoader(Workflow(name="w"), shards[0], minibatch_size=25,
                         process_index=0, process_count=2)
    with pytest.raises(ValueError, match="not divisible"):
        ld.initialize(device="cpu")
    with pytest.raises(ValueError, match="both process_index"):
        StreamingLoader(Workflow(name="w"), shards[0], process_index=0)


# ----------------------------------------------------------------------
# resume
# ----------------------------------------------------------------------
def _sequence(ld, n):
    out = []
    for _ in range(n):
        ld.run()
        out.append((ld.epoch_number, ld.minibatch_class,
                    tuple(np.asarray(ld.minibatch_indices).tolist()),
                    ld.minibatch_raw.devmem.numpy().tobytes()))
    return out


@pytest.mark.parametrize("source", ["port", "reference"])
def test_mid_epoch_resume_delivers_the_uninterrupted_sequence(shards,
                                                              source):
    d = shards[0]
    straight = port_streaming(d, seed=5)
    n_sched = len(straight._schedule)
    cut, total = n_sched + 2, 3 * n_sched  # two entries into epoch 1
    try:
        want = _sequence(straight, total)
    finally:
        straight.stop()
    if source == "port":
        head = port_streaming(d, seed=5)
        try:
            assert _sequence(head, cut) == want[:cut]
            state = head.state_dict()
        finally:
            head.stop()
    else:
        head = ref_streaming(d, seed=5)
        try:
            for _ in range(cut):
                head.run()
            state = head.state_dict()
        finally:
            head.stop()
    resumed = port_streaming(d, seed=999)  # not the ambient seed's order
    resumed.load_state(state)
    try:
        assert _sequence(resumed, total - cut) == want[cut:]
    finally:
        resumed.stop()


# ----------------------------------------------------------------------
# the fault sites
# ----------------------------------------------------------------------
def _faulted(d, recipe, n, make, step):
    root.common.engine.faults = dict(recipe)
    ref_root.common.engine.faults = dict(recipe)
    ld = make(d)
    try:
        return [step(ld)[:4] for _ in range(n)], ld
    finally:
        ld.stop()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_reader_death_restarts_bit_clean(shards):
    d = shards[0]
    clean = port_streaming(d)
    n = len(clean._schedule) + 2
    try:
        want = [port_step(clean)[:4] for _ in range(n)]
    finally:
        clean.stop()
    restarts = metrics.loader_pipeline_restarts(clean.name).value
    got, port = _faulted(d, {"loader.reader_death": {"at": [3]}}, n,
                         port_streaming, port_step)
    ref_got, ref = _faulted(d, {"loader.reader_death": {"at": [3]}}, n,
                            ref_streaming, ref_step)
    _same(got, want)
    _same(got, ref_got)
    assert port.pipeline_restarts == ref.pipeline_restarts == 1
    assert metrics.loader_pipeline_restarts(port.name).value \
        == restarts + 1


def test_persistently_corrupt_shard_is_quarantined_to_zeros(shards):
    d, _, _, glob, _ = shards
    recipe = {"loader.corrupt_shard": {"shard": 1, "after": 1}}
    n = len(port_streaming(d)._schedule)
    got, port = _faulted(d, recipe, n, port_streaming, port_step)
    ref_got, ref = _faulted(d, recipe, n, ref_streaming, ref_step)
    _same(got, ref_got)
    assert 1 in port._reader.quarantined and 1 in ref._reader.quarantined
    zeros = 0
    for idx, _, _, raw in got:
        in_shard = (idx >= 50) & (idx < 100)
        assert not raw[in_shard].any()
        np.testing.assert_array_equal(raw[~in_shard], glob[idx[~in_shard]])
        zeros += int(in_shard.sum())
    assert zeros and metrics.loader_rows_quarantined(port.name).value \
        >= zeros
    assert metrics.loader_shards_quarantined(port.name).value >= 1


def test_short_read_is_retried(shards):
    d, _, _, glob, _ = shards
    recipe = {"loader.short_read": {"shard": 0, "at": [1]}}
    retries = metrics.loader_read_retries(
        port_streaming(d).name).value
    got, port = _faulted(d, recipe, 4, port_streaming, port_step)
    ref_got, _ = _faulted(d, recipe, 4, ref_streaming, ref_step)
    _same(got, ref_got)
    assert not port._reader.quarantined
    for idx, _, _, raw in got:
        np.testing.assert_array_equal(raw, glob[idx])
    assert metrics.loader_read_retries(port.name).value == retries + 1


def test_dead_pipeline_beyond_the_restart_budget_raises(shards):
    root.common.engine.faults = {"loader.reader_death": {"after": 1}}
    root.common.engine.reader_restarts = 1
    ld = port_streaming(shards[0])
    try:
        with pytest.raises(Exception, match="died"):
            ld.run()
        assert ld.pipeline_restarts == 2
    finally:
        ld.stop()


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
          {"type": "softmax", "->": {"output_sample_shape": 3},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


def _port_stream_wf(d, name="stream"):
    prng.seed_all(3)
    wf = StandardWorkflow(
        name=name, loader_factory=lambda w: StreamingLoader(
            w, d, minibatch_size=BATCH, prefetch_depth=2,
            normalization_scale=1 / 127.5, normalization_bias=-1.0),
        layers=LAYERS, decision_config={"max_epochs": 2})
    wf.initialize(device="cpu")
    return wf


def _params(wf):
    return {f"{u.name}.{n}": p.detach().numpy().copy()
            for u in wf.forwards for n, p in u.named_parameters()}


def test_streamed_training_matches_the_reference(shards):
    """Two epochs step by step beside the reference's streamed workflow
    on XLA: each normalized batch within one f32 ulp, the parameters
    within 1e-5 of their largest value at the end."""
    d = shards[0]
    ref_prng.seed_all(3)
    ref = RefWorkflow(
        name="stream", loader_factory=lambda w: RefStreaming(
            w, d, minibatch_size=BATCH, prefetch_depth=2,
            normalization_scale=1 / 127.5, normalization_bias=-1.0),
        layers=LAYERS, decision_config={"max_epochs": 2})
    ref._max_fires = 100_000
    ref.initialize(device=XLADevice())
    port = _port_stream_wf(d)
    try:
        for _ in range(2 * len(port.loader._schedule)):
            ref.loader._fire()
            ref._region_unit._fire()
            ref.decision._fire()
            port.step()
            ref.loader.minibatch_data.map_read()
            np.testing.assert_array_max_ulp(
                np.asarray(port.loader.minibatch_data),
                np.asarray(ref.loader.minibatch_data.mem), maxulp=1)
        want = {}
        for unit in ref.forwards:
            for attr in ("weights", "bias"):
                vec = getattr(unit, attr)
                vec.map_read()
                want[f"{unit.name}.{attr}"] = np.array(vec.mem)
        got = _params(port)
        assert set(got) == set(want)
        for key, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[key] - w).max()) <= 1e-5 * scale, key
    finally:
        ref.stop()
        port.stop()


def test_streamed_training_equals_the_resident_loaders(shards):
    d, data, labels, _, _ = shards
    prng.seed_all(3)
    res = StandardWorkflow(
        name="resident", loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:144], train_labels=labels[:144],
            valid_data=data[144:], valid_labels=labels[144:],
            minibatch_size=BATCH, normalization_scale=1 / 127.5,
            normalization_bias=-1.0),
        layers=LAYERS, decision_config={"max_epochs": 2})
    res.initialize(device="cpu")
    res.run()
    port = _port_stream_wf(d)
    try:
        port.run()
        want, got = _params(res), _params(port)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    finally:
        port.stop()


# ----------------------------------------------------------------------
# the delivery and the region's graphs (a stand-in for the CUDA graph API)
# ----------------------------------------------------------------------
@pytest.fixture
def graph_stand_in(monkeypatch):
    """A capture runs the members and checks CAPTURE_LOCK is held; a
    replay runs nothing."""
    replays, locked = [], []

    class Graph:
        def replay(self):
            replays.append(self)

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capturing(graph):
        locked.append(CAPTURE_LOCK.locked())
        yield

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", capturing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(JitRegion, "graphed",
                        property(lambda self: self.mark is None))
    return replays, locked


def test_delivery_in_place_replays_and_a_rebinding_is_refused(
        shards, graph_stand_in, monkeypatch):
    replays, locked = graph_stand_in
    wf = _port_stream_wf(shards[0])
    loader = wf.loader
    raw = loader.minibatch_raw.devmem
    try:
        for _ in range(4):  # validation and train keys: captures, replays
            wf.step()
            assert loader.minibatch_raw.devmem is raw  # written in place
        assert wf.region.captures == 2 and len(replays) == 2
        assert locked == [True, True]
        assert not CAPTURE_LOCK.locked()

        def rebinding(self, value):
            self._devmem = value.clone()
        monkeypatch.setattr(Vector, "accept_device", rebinding)
        with pytest.raises(RuntimeError, match="minibatch_raw was rebound"):
            wf.step()
    finally:
        wf.stop()
