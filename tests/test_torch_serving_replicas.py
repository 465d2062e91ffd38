"""Serving replication (the reference's ``ServingEngine.resolve_device``
and its replicated engine): one model a device, a dispatch's rows split
over them and joined in order.

On the CPU two replicas stand on the host (``device=["cpu", "cpu"]``),
which exercises the split, the join and the swap on every replica; the
replies must equal the one-model engine's bit for bit (the same chain on
the same rows).  The card's path is the same code with one device a
replica.
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from tests.conftest import make_blobs
from znicz_tpu_torch.backends import CpuDevice
from znicz_tpu_torch.serving.engine import ServingEngine
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    reset_root()
    out = tmp_path_factory.mktemp("replicas")
    paths = []
    for seed in (1234, 99):
        prng.seed_all(seed)
        wf = worker.build_fc(hidden2=None)
        wf.initialize(device=CpuDevice(torch.device("cpu")))
        wf.run()
        paths.append(wf.export_forward(str(out / f"model_{seed}.npz")))
    reset_root()
    return paths


@pytest.mark.parametrize("rows", [1, 3, 8, 13, 16])
def test_replicas_reply_as_one_model(bundles, rows):
    x = make_blobs(40, 3, 12)[0][:rows].astype(np.float32)
    with ServingEngine(bundles[0], max_batch=16, device="cpu") as one, \
            ServingEngine(bundles[0], max_batch=16,
                          device=["cpu", "cpu"]) as two:
        want = one(x, timeout=60)
        got = two(x, timeout=60)
        assert len(two.replicas) == 2 and two.stats()["replicas"] == 2
    assert got.shape == (rows, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [3, 4, 7, 8])
def test_three_replicas_cover_every_row(bundles, rows):
    """A replica count that does not divide the bucket: every request
    still gets its own rows' reply, as from one model.  The replicas run
    smaller batches than the one model, and the CPU's product may then
    sum a row in another order: held to 1e-6 (a missing or shifted row
    is off by 1e-1)."""
    x = make_blobs(40, 3, 12)[0][:rows].astype(np.float32)
    with ServingEngine(bundles[0], max_batch=8, device="cpu") as one, \
            ServingEngine(bundles[0], max_batch=8,
                          device=["cpu"] * 3) as three:
        want = [one(row[None], timeout=60) for row in x]
        futures = [three.submit(row[None]) for row in x]
        got = [f.result(timeout=60) for f in futures]
        whole = three(x, timeout=60)
    for g, w in zip(got, want):
        assert g.shape == (1, 3)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert whole.shape == (rows, 3)
    np.testing.assert_allclose(whole, np.concatenate(want),
                               rtol=1e-6, atol=1e-6)


def test_a_swap_reaches_every_replica(bundles):
    x = make_blobs(40, 3, 12)[0][:16].astype(np.float32)
    with ServingEngine(bundles[1], max_batch=16, device="cpu") as ref:
        want = ref(x, timeout=60)
    with ServingEngine(bundles[0], max_batch=16,
                       device=["cpu", "cpu"]) as eng:
        eng.swap_weights(bundles[1])
        got = eng(x, timeout=60)
        assert all(r.weights_version == 1 for r in eng.replicas)
    np.testing.assert_array_equal(got, want)


def test_resolve_device_follows_the_visible_cards(monkeypatch):
    """Two or more cards: one replica each; one card (or the gate off):
    that card, as the reference below two devices; no card: the error
    of every entry point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert ServingEngine.resolve_device() == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]
    root.common.serving.replicate = False
    try:
        assert ServingEngine.resolve_device() == torch.device("cuda", 0)
    finally:
        reset_root()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ServingEngine.resolve_device() == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.resolve_device()


def test_a_replica_captures_on_its_own_card(bundles, monkeypatch):
    """C24: ``torch.cuda.graph`` without ``stream=`` captures on a stream
    made once for the process on the device current at its first use,
    so a replica on ``cuda:1`` captured its kernels on a stream of
    ``cuda:0``.  With a stand-in for the CUDA graph API that tracks the
    current device: a model whose device is ``cuda:1`` (its chain on the
    host) runs its warm-up on a stream of ``cuda:1``, captures under
    ``cuda:1``'s guard on that stream, passed as ``stream=``, into a
    pool made there, and replays under the guard; the caller's current
    device is ``cuda:0`` before and after."""
    import contextlib

    from znicz_tpu_torch.export import ExportedModel
    current = [0]
    log = []

    class Stream:
        def __init__(self, device=None):
            self.device = torch.device("cuda", current[0]) \
                if device is None else torch.device(device)

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], torch.device(dev).index
        try:
            yield
        finally:
            current[0] = prev

    @contextlib.contextmanager
    def stream(s):
        log.append(("warm-up", s.device.index, current[0]))
        yield

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        log.append(("capture", current[0],
                    None if stream is None else stream.device.index, pool))
        yield

    class Graph:
        def replay(self):
            log.append(("replay", current[0]))

    model = ExportedModel.load(bundles[0], device="cpu", max_batch=4)
    prog = model._resident(4)
    model.device = torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(dev))
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", current[0]))
    x = torch.from_numpy(make_blobs(40, 3, 12)[0][:4].astype(np.float32))
    prog.buf.copy_(x)
    warm = model._capture(prog)
    model._replay(prog)
    assert log == [("warm-up", 1, 1), ("capture", 1, 1, ("pool", 1)),
                   ("replay", 1)]
    assert current == [0] and model._side.device == torch.device("cuda", 1)
    assert prog.graph is not None and prog.out.shape == warm.shape == (4, 3)
