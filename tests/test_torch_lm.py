"""The token LM and the LSTM chain through the port's ``StandardWorkflow``
against the reference, on the CPU, and microbatch accumulation
(``run_accumulated``).

The LM is the chain of ``benchmarks/serve_bench.py``'s
``train_and_export_lm`` (embedding → pos_encoding → causal attention →
last_token → softmax; V = 12, D = 16, T = 8, 2 heads) on its synthetic
next-token task (``x_{t+1} = (x_t + 1) mod V``, the label
``(x_0 + T) mod V``), with the reference's flash kernel in interpret
mode.  Both packages start from one seed, which gives both the same
initial state, and step through the same minibatches.  Tolerances,
relative to each tensor's largest |reference| value, are those of
``tests/test_torch_training.py`` (the same rounding points, other
summation orders): f32 1e-5; bf16 1e-2 for weights, 2e-2 for momentum.

Accumulation: on the reference's exact-arithmetic linear autoencoder
(``tests/test_pipeline.py``: data in {−1, 0, 1}, dyadic weights,
learning rate 2⁻⁴, momentum 2⁻¹, power-of-two batches; without ZeRO-1,
the anomaly guard and the SDC fingerprints, which the port does not
have) 4 microbatches of 8 equal one fused batch of 32 bit for bit, and
equal the reference's ``run_accumulated``; the accumulated LM is held to
the reference's within the f32 tolerance above.
"""

import contextlib

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.export import _sequence_meta as ref_sequence_meta
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch import accelerated_units
from znicz_tpu_torch.accelerated_units import JitRegion, current_accum_phase
from znicz_tpu_torch.export import ExportedModel, _sequence_meta
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

V, D, T, HEADS = 12, 16, 8, 2
N_TRAIN, N_VALID, BATCH = 64, 32, 16
TOL = {"float32": {"weights": 1e-5, "momentum": 1e-5},
       "bfloat16": {"weights": 1e-2, "momentum": 2e-2}}


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _lm_data(seed=31, n=N_TRAIN + N_VALID):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, V, size=n)
    data = ((start[:, None] + np.arange(T)[None, :]) % V).astype(np.float32)
    return data, ((start + T) % V).astype(np.int32)


def _lm_layers(causal=True):
    return [{"type": "embedding", "->": {"vocab_size": V, "dim": D},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
            {"type": "pos_encoding", "->": {}},
            {"type": "attention", "->": {"n_heads": HEADS, "causal": causal},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "last_token", "->": {}},
            {"type": "softmax", "->": {"output_sample_shape": V},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}]


def _loader(cls, data, labels, n_train=N_TRAIN, batch=BATCH, **kwargs):
    return lambda w: cls(w, train_data=data[:n_train],
                         train_labels=labels[:n_train],
                         valid_data=data[n_train:],
                         valid_labels=labels[n_train:],
                         minibatch_size=batch, **kwargs)


def _ref_lm(dtype="float32", grad_accum=1, layers=None, epochs=100,
            batch=BATCH):
    ref_root.common.engine.pallas_interpret = True
    ref_root.common.engine.flash_attention = True
    ref_root.common.engine.anomaly_guard = False
    ref_root.common.engine.grad_accum = grad_accum
    ref_root.common.precision_type = dtype
    ref_prng.seed_all(31)
    wf = RefWorkflow(name="lm", loader_factory=_loader(
        RefLoader, *_lm_data(), batch=batch),
        layers=layers or _lm_layers(), decision_config={"max_epochs": epochs})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    return wf


def _port_lm(dtype="float32", grad_accum=1, layers=None, epochs=100,
             batch=BATCH, **loader_kwargs):
    root.common.precision_type = dtype
    root.common.engine.grad_accum = grad_accum
    prng.seed_all(31)
    wf = StandardWorkflow(name="lm", loader_factory=_loader(
        ArrayLoader, *_lm_data(), batch=batch, **loader_kwargs),
        layers=layers or _lm_layers(), decision_config={"max_epochs": epochs})
    wf.initialize(device="cpu")
    return wf


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


_STATE = ("weights", "bias", "weights_out", "bias_out",
          "accumulated_gradient_weights", "accumulated_gradient_bias",
          "accumulated_gradient_weights_out", "accumulated_gradient_bias_out")


def _ref_tensors(wf):
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _STATE:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.asarray(vec.mem, np.float32)
    return out


def _port_tensors(wf):
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]
            if name in _STATE}


def _assert_close(got, want, dtype):
    assert set(got) == set(want)
    for key, w in want.items():
        kind = "momentum" if "accumulated" in key else "weights"
        atol = TOL[dtype][kind] * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_steps_match_the_reference(dtype):
    """Two validation and four train steps, across the epoch boundary,
    from one seed; the error counts equal."""
    ref, port = _ref_lm(dtype), _port_lm(dtype)
    assert [u.name for u in port.forwards] == [u.name for u in ref.forwards]
    _assert_close(_port_tensors(port), _ref_tensors(ref), dtype)
    assert port.loader._shuffle_seed == ref.loader._shuffle_seed
    classes = []
    for _ in range(8):  # valid × 2, train × 4, valid × 2 of epoch 1
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        _assert_close(_port_tensors(port), _ref_tensors(ref), dtype)
    assert classes == [VALID] * 2 + [TRAIN] * 4 + [VALID] * 2
    assert port.decision.last_epoch_n_err == ref.decision.last_epoch_n_err


def test_export_writes_the_references_lm_manifest(tmp_path):
    """``export_forward`` of the same trained chain: the port's manifest
    is the reference's, ``kind`` "lm" and its ``sequence`` block
    included, and each package serves the other's bundle with equal
    replies (f32: 1e-5 of a probability)."""
    ref, port = _ref_lm(), _port_lm()
    for _ in range(6):
        _ref_step(ref)
        port.step()
    ref_path = ref.export_forward(str(tmp_path / "ref.npz"))
    port_path = port.export_forward(str(tmp_path / "port.npz"))
    got = ExportedModel.load(port_path, device="cpu")
    want = RefModel.load(ref_path, device=XLADevice())
    assert got.manifest == want.manifest
    assert got.manifest["kind"] == "lm" and got.kind == "lm"
    assert got.sequence == want.sequence == {
        "train_t": T, "vocab": V, "dim": D,
        "cache": [{"layer": 2, "kind": "attention", "heads": HEADS,
                   "head_dim": D // HEADS, "features": D}]}
    x = _lm_data(seed=8, n=5)[0]
    # the reference's bundle in the port, the port's in the reference
    np.testing.assert_allclose(ExportedModel.load(ref_path, device="cpu")(x),
                               want(x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got(x), RefModel.load(port_path, device=XLADevice())(x), rtol=0,
        atol=1e-5)
    assert got(x).shape == (5, V)


@pytest.mark.parametrize("layers", [
    [{"type": "embedding", "config": {"vocab_size": 9, "dim": 8}},
     {"type": "lstm", "config": {"units": 6}},
     {"type": "softmax", "config": {"output_sample_shape": 9}}],
    [{"type": "embedding", "config": {"vocab_size": 9, "dim": 8}},
     {"type": "attention", "config": {"n_heads": 2}},
     {"type": "softmax", "config": {"output_sample_shape": 9}}],
    [{"type": "embedding", "config": {"vocab_size": 9, "dim": 8}},
     {"type": "pos_encoding", "config": {}},
     {"type": "softmax", "config": {"output_sample_shape": 9}}],
    [{"type": "attention", "config": {"n_heads": 2, "causal": True}}],
    []])
def test_sequence_meta_is_the_references(layers):
    """The copy of ``_sequence_meta``: an LSTM LM, and the chains that
    are scorers (a bidirectional attention, nothing to cache, not
    token-first, no layers)."""
    assert _sequence_meta(layers, (7,)) == ref_sequence_meta(layers, (7,))


def test_kind_of_a_bundle_without_one():
    """A bundle written before ``kind`` existed derives it from its
    layers; an explicit ``kind`` is taken as written."""
    port = _port_lm()
    manifest = {"format": "znicz-tpu-forward", "version": 1,
                "input_shape": [T], "dtype": "float32",
                "layers": [{"type": s["type"], "config": s.get("->", {})}
                           for s in _lm_layers()]}
    params = {f"layer{i}_{attr}": getattr(unit, attr).detach().numpy()
              for i, unit in enumerate(port.forwards)
              for attr in unit.EXPORT_PARAMS}
    legacy = ExportedModel(manifest, params, device="cpu")
    assert legacy.kind == "lm" and legacy.sequence["vocab"] == V
    scorer = ExportedModel({**manifest, "kind": "scorer"}, params,
                           device="cpu")
    assert scorer.kind == "scorer" and scorer.sequence is None


def test_token_model_trains():
    """The reference's ``tests/test_embedding.py::test_token_model_trains``
    on the port, to the same bar: embedding → pos_encoding → attention
    → softmax learns which marker token a sequence holds."""
    rng = np.random.default_rng(61)
    n, t, n_classes, v, d = 120, 8, 3, 11, 8
    x = rng.integers(3, v, size=(n, t)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    for i in range(n):
        x[i, rng.integers(0, t)] = y[i]
    prng.seed_all(62)
    wf = StandardWorkflow(
        name="token_wf",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[:96], train_labels=y[:96],
            valid_data=x[96:], valid_labels=y[96:], minibatch_size=24),
        layers=[
            {"type": "embedding",
             "->": {"vocab_size": v, "dim": d, "weights_stddev": 0.5},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
            {"type": "pos_encoding", "->": {"scale": 0.1}},
            {"type": "attention", "->": {"n_heads": 2},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": n_classes},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        ],
        decision_config={"max_epochs": 40})
    wf.initialize(device="cpu")
    wf.run()
    assert wf.decision.min_validation_n_err_pt <= 25.0


def _lstm_task():
    rng = np.random.default_rng(2)
    protos = rng.normal(size=(3, 8, 6)).astype(np.float32)
    data = np.concatenate([p + 0.3 * rng.normal(size=(40, 8, 6))
                           for p in protos]).astype(np.float32)
    labels = np.repeat(np.arange(3), 40).astype(np.int32)
    order = rng.permutation(len(data))
    return data[order], labels[order]


def test_lstm_sequence_classification_e2e():
    """The reference's ``tests/test_lstm.py::
    test_lstm_sequence_classification_e2e`` on the port, to the same
    bar."""
    prng.seed_all(11)
    data, labels = _lstm_task()
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9}
    wf = StandardWorkflow(
        name="seq",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=24),
        layers=[{"type": "lstm", "->": {"units": 16}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": 12})
    wf.initialize(device="cpu")
    wf.run()
    assert wf.decision.min_validation_n_err_pt <= 10.0


LSTM_LM = [{"type": "embedding", "->": {"vocab_size": V, "dim": D},
            "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
           {"type": "lstm", "->": {"units": 16},
            "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
           {"type": "softmax", "->": {"output_sample_shape": V},
            "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}]


def test_lstm_lm_matches_the_reference_in_f32():
    """embedding → lstm → softmax, the chain of phase 10's LSTM pass,
    step by step against the reference in f32."""
    ref, port = _ref_lm(layers=LSTM_LM), _port_lm(layers=LSTM_LM)
    _assert_close(_port_tensors(port), _ref_tensors(ref), "float32")
    for _ in range(6):
        _ref_step(ref)
        port.step()
        _assert_close(_port_tensors(port), _ref_tensors(ref), "float32")


def test_lstm_lm_trains_in_bf16():
    """C11: in bf16 the softmax's backward hands the LSTM a bf16 error,
    which the reference's ``jax.vjp`` refuses; the port takes it in f32
    and trains, its state after four steps within the bf16 tolerances
    above of the f32 run's."""
    ref = _ref_lm("bfloat16", layers=LSTM_LM, epochs=2)
    with pytest.raises(ValueError, match="VJP"):
        ref.run()
    f32 = _port_lm(layers=LSTM_LM, epochs=3)
    bf16 = _port_lm("bfloat16", layers=LSTM_LM, epochs=3)
    for _ in range(4):
        f32.step()
        bf16.step()
    _assert_close(_port_tensors(bf16), _port_tensors(f32), "bfloat16")
    bf16.run()
    assert bf16.decision.epoch_loss[TRAIN] < np.log(V)
    assert all(np.isfinite(v).all() for v in _port_tensors(bf16).values())


# ----------------------------------------------------------------------
# microbatch accumulation
# ----------------------------------------------------------------------
N_LIN, D_LIN = 64, 8
_LIN_DATA = np.random.RandomState(7).randint(
    -1, 2, size=(N_LIN, D_LIN)).astype(np.float32)


def _dyadic(shape, rs):
    return (rs.randint(-8, 9, size=shape) / 16.0).astype(np.float32)


def _linear(minibatch, grad_accum, ref=False):
    """The reference's exact-arithmetic autoencoder, in either package,
    for one epoch."""
    layers = [{"type": "all2all", "->": {"output_sample_shape": D_LIN},
               "<-": {"learning_rate": 0.0625, "gradient_moment": 0.5}}]
    if ref:
        ref_root.common.engine.grad_accum = grad_accum
        ref_root.common.engine.anomaly_guard = False
        ref_prng.seed_all(17)
        wf = RefWorkflow(name="pp", loader_factory=lambda w: RefLoader(
            w, train_data=_LIN_DATA, minibatch_size=minibatch),
            layers=layers, loss="mse", decision_config={"max_epochs": 1})
        wf._max_fires = 100_000
        wf.initialize(device=XLADevice())
    else:
        root.common.engine.grad_accum = grad_accum
        prng.seed_all(17)
        wf = StandardWorkflow(name="pp", loader_factory=lambda w: ArrayLoader(
            w, train_data=_LIN_DATA, minibatch_size=minibatch),
            layers=layers, loss="mse", decision_config={"max_epochs": 1})
        wf.initialize(device="cpu")
    rs = np.random.RandomState(23)
    for fwd in wf.forwards:
        for attr in ("weights", "bias"):
            value = getattr(fwd, attr)
            if ref:
                value.map_write()
                value.mem[...] = _dyadic(value.mem.shape, rs)
            else:
                with torch.no_grad():
                    value.copy_(torch.from_numpy(
                        _dyadic(tuple(value.shape), rs)))
    return wf


def _linear_params(wf):
    out = []
    for fwd in wf.forwards:
        for attr in ("weights", "bias"):
            value = getattr(fwd, attr)
            if isinstance(value, torch.Tensor):
                out.append(value.detach().numpy().copy())
            else:
                value.map_read()
                out.append(np.array(value.mem, copy=True))
    return out


@pytest.mark.parametrize("minibatch,n_micro", [(8, 4), (16, 2)])
def test_accum_step_bitwise_equals_fused_batch(minibatch, n_micro):
    """grad_accum = 4 microbatches of 8 (and 2 of 16) against one fused
    batch of 32, and against the reference's ``run_accumulated``: bit
    for bit, over the epoch's two optimizer steps."""
    fused = _linear(32, 1)
    fused.run()
    accum = _linear(minibatch, n_micro)
    assert set(accum.gds[0]._micro_accum) == {
        id(accum.forwards[0].weights), id(accum.forwards[0].bias)}
    accum.run_accumulated()
    ref = _linear(minibatch, n_micro, ref=True)
    ref.run_accumulated()
    want = _linear_params(fused)
    for got in (_linear_params(accum), _linear_params(ref)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(want[0],
                               _linear_params(_linear(32, 1))[0])  # moved
    assert metrics.grad_accum_microbatches("pp").value == n_micro
    assert accum.loader.epoch_number == fused.loader.epoch_number
    # the buffers are zero between optimizer steps
    assert all(float(b.abs().max()) == 0.0 for g in accum.gds
               for n, b in g.named_buffers() if n.startswith("micro_"))


def test_accumulated_lm_matches_the_references():
    """The LM with 2 microbatches of 16 a step against the reference's
    ``run_accumulated`` for 2 epochs, in f32; the decision's counts
    equal."""
    ref = _ref_lm(grad_accum=2, epochs=2)
    ref.run_accumulated()
    port = _port_lm(grad_accum=2, epochs=2)
    port.run_accumulated()
    _assert_close(_port_tensors(port), _ref_tensors(ref), "float32")
    assert port.decision.epoch_n_err == ref.decision.epoch_n_err
    assert port.loader.epoch_number == ref.loader.epoch_number == 1
    # attention's output projection accumulates too
    names = {n for n, _ in port.gds[2].named_buffers()}
    assert {"micro_accum_w", "micro_accum_b", "micro_accum_wo",
            "micro_accum_bo"} <= names
    assert not any(n.startswith("micro_") for n, _ in
                   port.gds[1].named_buffers())  # weightless


def test_run_accum_is_accumulation_microbatch_by_microbatch():
    """On the CPU the region runs the two phases eagerly: its
    ``run_accum(4)`` equals four single region steps run by hand in the
    accumulate, accumulate, accumulate, apply phases, and in those the
    parameters and momentum stay as they were until the apply step,
    while the f32 sums grow, and the apply step empties them."""
    a = _port_lm(grad_accum=4, n_train=N_TRAIN)
    b = _port_lm(grad_accum=4, n_train=N_TRAIN)
    for wf in (a, b):  # the two validation minibatches first
        for _ in range(2):
            wf.step()
    for _ in range(4):
        a.loader.run()
    a.region.run_accum(4)
    start = _port_tensors(b)
    sums = []
    for i in range(4):
        b.loader.run()
        phase = ("accum", 4) if i < 3 else ("apply", 4)
        with accelerated_units._Phase(phase):
            assert current_accum_phase() == phase
            b.region.run()
        assert current_accum_phase() is None
        sums.append(b.gds[0].micro_accum_w.clone())
        if i < 3:
            for key, value in _port_tensors(b).items():
                np.testing.assert_array_equal(value, start[key], err_msg=key)
            assert float(sums[-1].abs().max()) > 0
            if i:
                assert not torch.equal(sums[-1], sums[-2])
    assert float(sums[-1].abs().max()) == 0.0
    got, want = _port_tensors(a), _port_tensors(b)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not np.array_equal(want["Embedding.weights"],
                              start["Embedding.weights"])


def test_accumulated_graphs_bookkeeping(monkeypatch):
    """On the card ``run_accum(M)`` is two graphs a key: with a stand-in
    for the CUDA graph API (a capture runs its members, a replay runs
    nothing), the first step captures the accumulate graph (its warm-up
    is microbatch 1), replays it M − 2 times and captures the apply
    graph; a later step replays the first M − 1 times and the second
    once; each capture ran in its phase."""
    replays, phases = [], []

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
    wf = _port_lm(grad_accum=4)
    unit = wf.gds[0]
    run = unit.device_run

    def recording_run():
        phases.append(current_accum_phase())
        run()

    monkeypatch.setattr(unit, "device_run", recording_run)
    region = wf.region
    accum, apply = ("accum", 4), ("apply", 4)

    def optimizer_step():
        for _ in range(2):  # the epoch's validation minibatches
            wf.step()
        for _ in range(4):
            wf.loader.run()
        region.run_accum(4)

    optimizer_step()
    # warm-up and capture of each phase
    assert phases == [accum, accum, apply, apply]
    graphs = {k[-2]: region._cache[k].graph for k in region._cache
              if k[-2:] in (accum, apply)}
    assert len(graphs) == 2 and region.captures == 3  # + validation
    assert replays.count(graphs["accum"]) == 2
    assert replays.count(graphs["apply"]) == 0
    optimizer_step()
    assert replays.count(graphs["accum"]) == 5
    assert replays.count(graphs["apply"]) == 1
    assert region.captures == 3 and len(phases) == 4
    for _ in range(2):
        wf.step()
    wf.loader.run()
    region.run_accum(1)  # one microbatch is a plain step: a new key
    assert region.captures == 4 and phases[-1] is None


def test_run_accumulated_refusals_and_the_schedule():
    """The train set must divide into whole accumulated steps; the
    loader's schedule must be on the device; M = 1 is ``run``; the
    learning-rate schedule advances once an optimizer step."""
    wf = _port_lm(grad_accum=4, batch=12)  # 64 = 5 × 12 + 4
    with pytest.raises(RuntimeError, match="does not divide"):
        wf.run_accumulated()

    class HostScheduleLoader(ArrayLoader):
        device_schedule = False

    root.common.engine.grad_accum = 2
    prng.seed_all(31)
    wf = StandardWorkflow(name="lm", loader_factory=_loader(
        HostScheduleLoader, *_lm_data()), layers=_lm_layers(),
        decision_config={"max_epochs": 1})
    wf.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="on the device"):
        wf.run_accumulated()

    layers = _lm_layers()
    layers[-1] = {**layers[-1], "<-": {**layers[-1]["<-"],
                                       "lr_policy": ("exp", {"gamma": 0.5})}}
    wf = _port_lm(grad_accum=2, layers=layers, epochs=3)
    wf.run_accumulated()
    # 3 epochs × 64 / (2 × 16) optimizer steps
    assert wf.lr_adjuster._n_iterations == 6
    head = wf.gds[-1]
    np.testing.assert_allclose(float(head.lr_state[0]), 0.1 * 0.5 ** 6,
                               rtol=1e-6)
    plain = _port_lm(grad_accum=1, epochs=1)
    plain.run_accumulated()  # M = 1 is run()
    assert plain.decision.complete and plain.loader.epoch_number == 0
    assert not any(n.startswith("micro_") for g in plain.gds
                   for n, _ in g.named_buffers())


def test_accumulation_needs_its_buffers():
    """A step in an accumulation phase in a run initialized without
    ``engine.grad_accum`` raises rather than train without a sum."""
    wf = _port_lm(grad_accum=1)
    for _ in range(2):
        wf.step()
    wf.loader.run()
    with accelerated_units._Phase(("accum", 2)):
        with pytest.raises(RuntimeError, match="grad_accum"):
            wf.region.run()


def test_snapshot_with_microbatch_buffers_crosses_both_ways():
    """The buffers are state (the reference's ``micro_accum_*`` names):
    a state without them loads, zero; the reference's loads too."""
    port = _port_lm(grad_accum=2)
    state = port.state_dict()
    assert "micro_accum_w" in state["__units__"][port.gds[0].name]
    plain = _port_lm(grad_accum=1).state_dict()
    port.load_state(plain)
    ref = _ref_lm(grad_accum=2)
    port.load_state(ref.state_dict())
    _assert_close(_port_tensors(port), _ref_tensors(ref), "float32")
