"""Hot swap in the port (``ExportedModel.swap_weights``,
``ServingEngine.swap_weights``) against the reference, on the CPU.

Two bundles trained by the reference's ``StandardWorkflow`` (the blob
classifier of ``tests/test_swap.py``, 1 and 4 epochs) serve through
both packages' engines; the port's replies are held to the reference's
within the f32 tolerance of ``tests/test_torch_serving.py`` (1e-5,
summation order only), and to themselves bit for bit where the
contract is bitwise:

- a swap serves the new weights, counts a promotion and bumps the
  versions; an incompatible candidate raises ``SwapIncompatible`` in
  both packages and leaves the incumbent's replies bit-identical;
- a dispatch in flight when a swap is asked for finishes on the old
  weights, and the swap publishes after it (the port publishes on the
  scheduler thread, between two dispatches);
- requests racing swaps each equal one model's reply bit for bit, never
  a mix (the dispatches and the swaps interleaved by barriers, with no
  sleep);
- a tied autoencoder's weights stay one tensor through a swap;
- with a stand-in for the CUDA graph API (a capture runs the chain, a
  replay runs it again with the launch counters quiet), the engine's
  buckets are captured once each at ``start()`` and never again across
  swaps, the counters gain exactly the capture's launches a replay, a
  bucket above the ladder is captured once (evicting the least recently
  used bucket: the reference's cap of one ladder's programs), and a swap
  that rebinds a parameter instead of copying into it makes the next
  replay raise.
"""

import contextlib
import threading
import types

import numpy as np
import pytest
import torch

from conftest import make_blobs
from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.export import SwapIncompatible as RefIncompatible
from znicz_tpu.loader.fullbatch import ArrayLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow
from znicz_tpu.serving import ServingEngine as RefEngine
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.export import (ExportedModel, SwapIncompatible,
                                    read_bundle)
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.ops.all2all import All2AllSoftmax
from znicz_tpu_torch.serving import ServingEngine
from znicz_tpu_torch.utils.config import reset_root

DIM, CLASSES = 10, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _bundle(path, name: str, epochs: int) -> str:
    data, labels = make_blobs(24, CLASSES, DIM)
    ref_prng.seed_all(17)
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh",
                 "->": {"output_sample_shape": 16},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                {"type": "softmax", "->": {"output_sample_shape": CLASSES},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": epochs})
    wf._max_fires = 100_000
    wf.initialize(device=XLADevice())
    wf.run()
    out = str(path / f"{name}.npz")
    wf.export_forward(out)
    return out


@pytest.fixture(scope="module")
def two_bundles(tmp_path_factory):
    path = tmp_path_factory.mktemp("swap")
    return _bundle(path, "swap_a", 1), _bundle(path, "swap_b", 4)


def _x(seed, n=4):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)


# ----------------------------------------------------------------------
# the reference's four engine tests, against the reference's engine
# ----------------------------------------------------------------------
def test_engine_swap_serves_new_weights(two_bundles):
    a, b = two_bundles
    x = _x(3, 5)
    with RefEngine(a, max_batch=8, max_delay_ms=1.0,
                   device=XLADevice()) as ref:
        want_a = ref(x, timeout=60)
        ref.swap_weights(b)
        want_b = ref(x, timeout=60)
    assert not np.allclose(want_a, want_b, atol=1e-4), "bundles identical?"
    with ServingEngine(a, max_batch=8, max_delay_ms=1.0,
                       device="cpu") as eng:
        np.testing.assert_allclose(eng(x, timeout=60), want_a, rtol=0,
                                   atol=TOL)
        res = eng.swap_weights(b)
        assert res["version"] == 1 and res["outcome"] == "promoted"
        assert res["weights_version"] == 1 and eng.model_version == 1
        assert res["pause_ms"] >= 0 and res["stage_ms"] >= 0
        np.testing.assert_allclose(eng(x, timeout=60), want_b, rtol=0,
                                   atol=TOL)
        st = eng.stats()
    assert st["swaps"]["promoted"] == 1 and st["model_version"] == 1
    assert st["weights_version"] == 1
    # the host-side bundle is the new one (what the shadow oracle reads)
    _, params_b = read_bundle(b)
    for key, value in eng.current_bundle()[1].items():
        np.testing.assert_array_equal(value, params_b[key])


def test_swap_incompatible_leaves_incumbent(two_bundles):
    a, _b = two_bundles
    x = _x(4, 3)
    manifest, params = read_bundle(a)
    bad = dict(manifest)
    bad["layers"] = [dict(spec, type="conv") for spec in manifest["layers"]]
    partial = {k: v for k, v in params.items() if k != "layer1_weights"}
    cases = [({"layer0_weights": np.zeros((2, 2), np.float32)}, "shape"),
             ((bad, params), "layer table"), (partial, "missing")]
    with RefEngine(a, max_batch=8, max_delay_ms=1.0,
                   device=XLADevice()) as ref:
        for state, match in cases:
            with pytest.raises(RefIncompatible, match=match):
                ref.swap_weights(state)
    with ServingEngine(a, max_batch=8, max_delay_ms=1.0,
                       device="cpu") as eng:
        before = eng(x, timeout=60)
        for state, match in cases:
            with pytest.raises(SwapIncompatible, match=match):
                eng.swap_weights(state)
        with pytest.raises(SwapIncompatible, match="dtype"):
            eng.swap_weights((dict(manifest, dtype="bfloat16"), params))
        after = eng(x, timeout=60)
        np.testing.assert_array_equal(before, after)
        assert eng.model_version == 0 and eng.model.weights_version == 0
        assert eng.swap_counts["promoted"] == 0


def test_mid_swap_dispatch_is_bitwise_pre_swap(two_bundles, monkeypatch):
    """A dispatch in flight when the swap is asked for finishes on the
    old weights bit for bit: the swap stages (the calling thread), then
    waits for the scheduler thread, which publishes only after the
    dispatch; the next reply is the new weights'."""
    a, b = two_bundles
    x = _x(5)
    want_a = ExportedModel.load(a, device="cpu")(x)
    want_b = ExportedModel.load(b, device="cpu")(x)
    in_dispatch, release = threading.Event(), threading.Event()
    staged = threading.Event()
    eng = ServingEngine(a, max_batch=8, max_delay_ms=1.0, device="cpu")
    eng.start()
    try:
        original = eng.model.forward_padded

        def held(buf):
            out = original(buf)
            if not in_dispatch.is_set():
                in_dispatch.set()
                assert release.wait(60)
            return out

        monkeypatch.setattr(eng.model, "forward_padded", held)
        stage = eng.model.stage_weights

        def stage_and_tell(*args, **kwargs):
            out = stage(*args, **kwargs)
            staged.set()
            return out

        monkeypatch.setattr(eng.model, "stage_weights", stage_and_tell)
        inflight = eng.submit(x)
        assert in_dispatch.wait(60)
        swapper = threading.Thread(target=eng.swap_weights, args=(b,))
        swapper.start()
        assert staged.wait(60)
        # staged, but the scheduler thread is inside the dispatch
        assert eng.model.weights_version == 0
        release.set()
        swapper.join(60)
        np.testing.assert_array_equal(inflight.result(timeout=60), want_a)
        assert eng.model.weights_version == 1
        np.testing.assert_array_equal(eng(x, timeout=60), want_b)
    finally:
        release.set()
        eng.shutdown()


def test_swap_hammer_never_torn(two_bundles):
    """Requests racing 8 swaps each equal one of the two models' replies
    bit for bit.  Each round a submitter and the swapper leave one
    barrier together, so the request and the swap race from the same
    point, with no sleep."""
    a, b = two_bundles
    x = _x(6)
    rounds = 8
    with ServingEngine(a, max_batch=8, max_delay_ms=0.5,
                       device="cpu") as eng:
        ref_a = eng(x, timeout=60)
        eng.swap_weights(b)
        ref_b = eng(x, timeout=60)
        eng.swap_weights(a)
        gate = threading.Barrier(2, timeout=60)
        results: list = []

        def hammer():
            for _ in range(rounds):
                gate.wait()
                results.append(eng(x, timeout=60))
                results.append(eng(x, timeout=60))

        t = threading.Thread(target=hammer)
        t.start()
        for state in [b, a] * (rounds // 2):
            gate.wait()
            eng.swap_weights(state)
        t.join(60)
        assert eng.swap_counts["promoted"] == rounds + 2
    assert len(results) == 2 * rounds
    for i, out in enumerate(results):
        assert np.array_equal(out, ref_a) or np.array_equal(out, ref_b), \
            f"reply {i} matches neither model bit for bit (a torn swap?)"


# ----------------------------------------------------------------------
# a tied autoencoder's weights through a swap
# ----------------------------------------------------------------------
AE_LAYERS = [{"type": "conv_tanh", "config": {"n_kernels": 3, "kx": 3,
                                              "ky": 3, "padding": 1}},
             {"type": "max_pooling", "config": {"kx": 2, "ky": 2}},
             {"type": "depooling", "config": {}, "tied_to": 1},
             {"type": "deconv_tanh", "config": {}, "tied_to": 0,
              "tied_weights": True}]


def _ae_bundle(seed):
    rng = np.random.default_rng(seed)
    manifest = {"format": "znicz-tpu-forward", "version": 1,
                "workflow": "tied_ae", "kind": "scorer",
                "input_shape": [6, 6, 1], "dtype": "float32",
                "layers": AE_LAYERS}
    params = {"layer0_weights": rng.normal(0, 0.3, (3, 3, 1, 3)),
              "layer0_bias": rng.normal(0, 0.1, (3,))}
    return manifest, {k: v.astype(np.float32) for k, v in params.items()}


def test_tied_autoencoder_swap_keeps_one_tensor():
    (manifest, params_a), (_, params_b) = _ae_bundle(1), _ae_bundle(2)
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 1)).astype(
        np.float32)
    ref = RefModel(manifest, dict(params_a), device=XLADevice(),
                   max_batch=4)
    ref.swap_weights(dict(params_b), manifest=manifest)
    want = np.asarray(ref(x))
    model = ExportedModel(manifest, params_a, device="cpu", max_batch=4)
    conv, deconv = model.forwards[0], model.forwards[3]
    assert deconv.weights is conv.weights
    # the tied deconv's weights are the conv's: one parameter to swap
    assert [key for key, _, _ in model._pairs] == [
        "layer0_weights", "layer0_bias"]
    model(x)
    model.swap_weights(params_b, manifest=manifest)
    assert deconv.weights is conv.weights
    assert deconv.weights.data_ptr() == conv.weights.data_ptr()
    np.testing.assert_array_equal(conv.weights.numpy(),
                                  params_b["layer0_weights"])
    np.testing.assert_allclose(model(x), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        model(x), ExportedModel(manifest, params_b, device="cpu")(x))


# ----------------------------------------------------------------------
# the per-bucket graphs, with a stand-in for the CUDA graph API
# ----------------------------------------------------------------------
class _Graph:
    """A stand-in ``CUDAGraph``: a replay runs what was bound to it."""

    def __init__(self):
        self.run = None
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """The CUDA graph API stood in for on the CPU, ``ExportedModel``
    graphed there, and a launch counter on the softmax head (the probe,
    one launch a forward) that a replay's rerun leaves quiet, as a real
    replay runs no Python."""
    quiet = []
    probe = types.SimpleNamespace(launches=0, launches_by_rows={})
    forward = All2AllSoftmax.forward

    def counted(self, x):
        if not quiet:
            probe.launches += 1
            rows = int(x.shape[0])
            probe.launches_by_rows[rows] = \
                probe.launches_by_rows.get(rows, 0) + 1
        return forward(self, x)

    capture = ExportedModel._capture

    def bound_capture(self, prog):
        warm = capture(self, prog)

        def rerun():
            quiet.append(True)
            try:
                with torch.inference_mode():
                    prog.out.copy_(self.forward_padded(prog.buf))
            finally:
                quiet.pop()

        prog.graph.run = rerun
        return warm

    monkeypatch.setattr(All2AllSoftmax, "forward", counted)
    monkeypatch.setattr(launch_counts, "_COUNTED",
                        launch_counts._COUNTED + [probe])
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(ExportedModel, "graphed",
                        property(lambda self: not self.host_only))
    monkeypatch.setattr(ExportedModel, "_capture", bound_capture)
    return probe


def test_graphed_engine_captures_once_and_swaps_in_place(
        two_bundles, fake_graphs):
    a, b = two_bundles
    probe = fake_graphs
    sizes = (1, 3, 8, 2)
    want = {(p, n): ExportedModel.load(p, device="cpu")(_x(10 + n, n))
            for p in (a, b) for n in sizes}
    probe.launches, probe.launches_by_rows = 0, {}
    with ServingEngine(a, max_batch=8, max_delay_ms=1.0,
                       device="cpu") as eng:
        st = eng.stats()
        assert st["programs"] == {"built": 4, "live": 4, "captures": 4,
                                  "graphed": True}
        assert st["engine"] == "bucketed-graphs"
        # warm-up: one eager launch a bucket; the captures launched none
        assert probe.launches == 4
        assert probe.launches_by_rows == {1: 1, 2: 1, 4: 1, 8: 1}
        dispatches = 0
        for state in (a, b, a, b):
            if dispatches:
                eng.swap_weights(state)
            for n in sizes:
                got = eng(_x(10 + n, n), timeout=60)
                np.testing.assert_array_equal(got, want[state, n])
                dispatches += 1
            assert eng.model.captures == 4  # never captured again
        assert probe.launches == 4 + dispatches  # one a replay, exactly
        assert probe.launches_by_rows == {1: 5, 2: 5, 4: 5, 8: 5}
        replays = sum(p.graph.replays for p in eng.model._programs.values())
        assert replays == dispatches
        assert eng.stats()["swaps"]["promoted"] == 3


def test_graphed_bucket_above_the_ladder_and_a_rebinding_swap(
        two_bundles, fake_graphs):
    a, b = two_bundles
    probe = fake_graphs
    x = _x(7, 11)
    want = ExportedModel.load(a, device="cpu")(x)
    probe.launches = 0
    model = ExportedModel.load(a, device="cpu", max_batch=4)
    assert model.warmup(4) == 3 and model.captures == 3
    # bucket 16: captured on its first dispatch (the warm-up's reply);
    # the cap (three programs, the ladder up to 4) evicts bucket 1, the
    # least recently used
    np.testing.assert_array_equal(model(x), want)
    assert model.captures == 3 and probe.launches == 4
    assert list(model._programs) == [2, 4, 16]
    np.testing.assert_array_equal(model(x), want)
    assert model.captures == 3 and probe.launches == 5
    assert model._programs[16].graph.replays == 1
    assert model.program_hits[16] == 1
    # a swap that rebinds a parameter (a new tensor) instead of copying
    # into the one the graphs read: the next replay refuses it
    _, params_b = read_bundle(b)
    model.forwards[1].load_params(
        {"weights": torch.from_numpy(params_b["layer1_weights"]),
         "bias": torch.from_numpy(params_b["layer1_bias"])})
    with pytest.raises(RuntimeError, match="layer1_weights was rebound"):
        model(x)
    assert probe.launches == 5
