"""The port's serving slice against the reference, end to end on the CPU.

One scorer bundle (attention → layer_norm → softmax, the sequence stack
of ``benchmarks/seq_bench.py`` cut to T=16, D=32, 2 heads), its weights
drawn from a numpy seed, goes through the reference's ``ExportedModel``
with both Pallas kernels engaged in interpret mode, and through the
port's ``ExportedModel(device="cpu")``, which runs the kernels' plain
versions.  Then ragged requests go through both ``ServingEngine``\\ s.

Tolerances on the class probabilities: a float32 bundle 1e-5 (summation
order only); a bf16 bundle 1e-3 (both round at the same points — the
request, q/k/v, p, the attention and layer-norm outputs — but summation
order can move an f32 value across a bf16 rounding boundary, one step
of 2⁻⁸ relative in an activation, ~1e-5 in a probability; the bound
leaves room for a handful of such steps adding up).
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.serving import ServingEngine as RefEngine
from znicz_tpu.utils.config import root
from znicz_tpu_torch import backends
from znicz_tpu_torch.export import (ExportedModel, params_from_jax,
                                    read_bundle)
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.serving import ServingEngine

T, D, HEADS, CLASSES = 16, 32, 2, 8
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
REPO = pathlib.Path(__file__).resolve().parent.parent


def _params(seed=0):
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.normal(0.0, std, shape).astype(np.float32)

    return {"layer0_weights": normal((D, 3 * D), D ** -0.5),
            "layer0_bias": normal((3 * D,), 0.1),
            "layer0_weights_out": normal((D, D), D ** -0.5),
            "layer0_bias_out": normal((D,), 0.1),
            "layer1_weights": 1.0 + normal((D,), 0.1),
            "layer1_bias": normal((D,), 0.1),
            "layer2_weights": normal((T * D, CLASSES), (T * D) ** -0.5),
            "layer2_bias": normal((CLASSES,), 0.1)}


def _manifest(dtype, causal=False):
    return {"format": "znicz-tpu-forward", "version": 1,
            "workflow": "torch_slice", "kind": "scorer",
            "input_shape": [T, D], "dtype": dtype,
            "layers": [
                {"type": "attention",
                 "config": {"n_heads": HEADS, "causal": causal}},
                {"type": "layer_norm", "config": {"eps": 1e-5}},
                {"type": "softmax",
                 "config": {"output_sample_shape": CLASSES}}]}


def _requests(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.5, (8, T, D)).astype(np.float32)


def _write_bundle(tmp_path, manifest, params):
    """The reference's bundle format: a JSON manifest beside the
    ``layer{i}_{attr}`` arrays in one ``.npz``."""
    path = tmp_path / "scorer.npz"
    np.savez(path, manifest=np.frombuffer(json.dumps(manifest).encode(),
                                          dtype=np.uint8), **params)
    return path


def _reference(manifest, params):
    """The reference model on the CPU with both kernels engaged in
    interpret mode (single device, so no data-axis mesh)."""
    root.common.engine.pallas_interpret = True
    root.common.engine.flash_attention = True
    root.common.engine.pallas_layer_norm = True
    return RefModel(manifest, dict(params), device=XLADevice(),
                    max_batch=8)


@pytest.mark.parametrize("dtype,causal", [("float32", False),
                                          ("bfloat16", False),
                                          ("bfloat16", True)])
def test_exported_model_matches_reference(dtype, causal):
    manifest, params, x = _manifest(dtype, causal), _params(), _requests()
    ref = _reference(manifest, params)
    want = ref(x[:3])
    # the reference really went through both kernels
    assert ref.forwards[0]._flash_pallas and ref.forwards[1]._pallas_ln
    port = ExportedModel(manifest, params, device="cpu", max_batch=8)
    got = port(x[:3])
    assert got.dtype == np.float32 and got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(port.predict_classes(x[:3]),
                                  ref.predict_classes(x[:3]))
    assert port.forwards[2].classify(
        torch.from_numpy(x[:3]).to(port.dtype))[1].dtype == torch.int32


def test_serving_engines_agree_on_ragged_requests(tmp_path):
    manifest, params, x = _manifest("bfloat16"), _params(), _requests()
    path = _write_bundle(tmp_path, manifest, params)
    with RefEngine(_reference(*read_bundle(str(path))), max_batch=8,
                   max_delay_ms=1.0) as ref_eng:
        want = [ref_eng(x[:n], timeout=120) for n in (1, 3, 8)]
    with ServingEngine(path, max_batch=8, max_delay_ms=1.0,
                       device="cpu") as eng:
        futures = [eng.submit(x[:n]) for n in (1, 3, 8)]
        got = [f.result(timeout=120) for f in futures]
        stats = eng.stats()
    for n, g, w in zip((1, 3, 8), got, want):
        assert g.shape == (n, CLASSES)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL["bfloat16"])
    assert stats["buckets_warmed"] == [1, 2, 4, 8]
    assert stats["programs"] == {"built": 4, "live": 4, "captures": 0,
                                 "graphed": False}
    assert stats["submitted"] == stats["served"] == 3
    assert sum(b["rows"] for b in stats["buckets"].values()) == 12
    scrape = metrics.REGISTRY.to_prometheus()
    assert (f'znicz_serving_requests_total{{engine="{eng._obs_id}",'
            f'event="served"}} 3') in scrape


def test_serves_a_bundle_exported_by_a_trained_reference_workflow(
        tmp_path):
    """``export_forward`` of a reference workflow trained for an epoch
    loads in the port unchanged and replies as the reference does."""
    from znicz_tpu.export import export_forward
    from znicz_tpu.loader.fullbatch import ArrayLoader
    from znicz_tpu.models.standard_workflow import StandardWorkflow
    from znicz_tpu.utils import prng

    rng = np.random.default_rng(21)
    x = rng.normal(0, 0.5, size=(32, 6, 8)).astype(np.float32)
    y = rng.integers(0, 3, size=32).astype(np.int32)
    prng.seed_all(22)
    gd = {"learning_rate": 0.05}
    wf = StandardWorkflow(
        name="torch_export",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=16),
        layers=[{"type": "attention", "->": {"n_heads": 2}, "<-": gd},
                {"type": "layer_norm", "->": {}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": 1})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    path = export_forward(wf, str(tmp_path / "trained.npz"))
    want = RefModel.load(path, device=XLADevice())(x[:5])
    got = ExportedModel.load(path, device="cpu")(x[:5])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["float32"])


def test_params_from_jax_keeps_parameters_f32():
    import jax.numpy as jnp
    manifest = _manifest("bfloat16")
    params = _params()
    live = {k: jnp.asarray(v) for k, v in params.items()}
    live["layer2_bias"] = live["layer2_bias"].astype(jnp.bfloat16)
    out = params_from_jax(manifest, live)
    assert set(out) == set(params)
    for key, value in out.items():
        assert value.dtype == torch.float32 and value.device.type == "cpu"
        want = np.asarray(live[key]).astype(np.float32)
        np.testing.assert_array_equal(value.numpy(), want)
    # a live reference model's jax.Array leaves carry across unchanged
    ref = _reference(manifest, params)
    ref(_requests()[:1])
    leaves = {f"layer{i}_{attr}": getattr(unit, attr).devmem
              for i, unit in enumerate(ref.forwards)
              for attr in unit.EXPORT_PARAMS if getattr(unit, attr)}
    carried = params_from_jax(manifest, leaves)
    for key in params:
        np.testing.assert_array_equal(carried[key].numpy(), params[key])
    with pytest.raises(ValueError, match="belongs to no layer"):
        params_from_jax(manifest, {"layer7_weights": params[
            "layer0_weights"]})
    with pytest.raises(ValueError, match="non-float"):
        params_from_jax(manifest, {"layer0_bias": np.arange(3 * D)})


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """No device given and no GPU: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    manifest, params = _manifest("float32"), _params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExportedModel(manifest, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(_write_bundle(tmp_path, manifest, params))
    with pytest.raises(RuntimeError, match="requested but no CUDA"):
        backends.resolve_device("cuda")
    assert backends.resolve_device("cpu") == torch.device("cpu")


#: a layer type no registry has (the reference's or the port's)
UNKNOWN_TYPE = "no_such_layer"


def test_bundle_checks():
    from znicz_tpu.models.standard_workflow import layer_type as ref_type
    params = _params()
    with pytest.raises(ValueError, match="unknown layer type"):
        ref_type(UNKNOWN_TYPE)
    with pytest.raises(ValueError, match=f"'{UNKNOWN_TYPE}' is not ported"):
        layer_type(UNKNOWN_TYPE)
    bad = _manifest("float32")
    bad["layers"][2]["type"] = UNKNOWN_TYPE
    with pytest.raises(ValueError, match=f"'{UNKNOWN_TYPE}' is not ported"):
        ExportedModel(bad, params, device="cpu")
    with pytest.raises(ValueError, match="missing from the bundle"):
        ExportedModel(_manifest("float32"),
                      {k: v for k, v in params.items()
                       if k != "layer1_bias"}, device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        ExportedModel(_manifest("float16"), params, device="cpu")
    with pytest.raises(ValueError, match="input sample shape"):
        ExportedModel(_manifest("float32"), params, device="cpu")(
            np.zeros((1, T, D + 1), np.float32))


def test_reference_cutter_bundle_serves(tmp_path):
    """A bundle with a ``cutter`` layer, written by the reference's
    exporter from a trained conv → cutter → max_pooling → softmax chain,
    serves on the port (CPU) as the reference's ``ExportedModel``
    serves it."""
    from znicz_tpu.export import export_forward
    from znicz_tpu.loader.fullbatch import ArrayLoader
    from znicz_tpu.models.standard_workflow import StandardWorkflow
    from znicz_tpu.utils import prng
    rng = np.random.default_rng(4)
    x = rng.normal(size=(24, 8, 8, 2)).astype(np.float32)
    y = rng.integers(0, 3, size=24).astype(np.int32)
    gd = {"learning_rate": 0.05}
    prng.seed_all(9)
    wf = StandardWorkflow(
        name="cutter_chain",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=8),
        layers=[{"type": "conv_tanh", "->": {"n_kernels": 3, "kx": 3,
                                             "ky": 3}, "<-": gd},
                {"type": "cutter", "->": {"padding": (1, 0, 0, 1)}},
                {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": 1})
    wf.initialize(device=XLADevice())
    wf.run()
    path = export_forward(wf, str(tmp_path / "cutter.npz"))
    manifest, _ = read_bundle(path)
    assert manifest["layers"][1]["type"] == "cutter"
    rows = x[:5]
    want = RefModel.load(path, device=XLADevice())(rows)
    got = ExportedModel.load(path, device="cpu")(rows)
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["float32"])


def test_batcher_backpressure_deadline_and_retry():
    from concurrent.futures import wait
    from znicz_tpu_torch.serving import (ContinuousBatcher,
                                         DeadlineExceeded, QueueFull)
    calls = []

    def run(batch):
        calls.append([r.n for r in batch])
        if len(calls) == 1:
            raise RuntimeError("first dispatch fails")
        for r in batch:
            r.future.set_result(r.n)

    b = ContinuousBatcher(run, max_batch=4, max_delay_ms=50.0,
                          max_queue=4, retry_budget=1)
    try:
        f1 = b.submit(np.zeros((3, 1)))
        with pytest.raises(QueueFull):
            b.submit(np.zeros((2, 1)))
        with pytest.raises(DeadlineExceeded):
            b.submit(np.zeros((1, 1)), deadline_ms=0)
        with pytest.raises(ValueError, match="outside 1..4"):
            b.submit(np.zeros((5, 1)))
        wait([f1], timeout=10)
        assert f1.result() == 3 and b.retries_total == 1
        assert calls == [[3], [3]]
    finally:
        b.shutdown(timeout=10)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "znicz_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("*.py"))  # the port's A/B tools
    assert len(files) > 10
    # the sequence units of the token LM among them, the RBM, the SOM
    # and the cutter, and the fault plan, the flight recorder and the
    # quantizer (host-only modules the port copies)
    assert {f"{m}.py" for m in ("embedding", "pos_encoding", "seq_reshape",
                                "lstm", "rbm_units", "kohonen", "cutter",
                                "faults", "recorder", "quantize")} \
        <= {p.name for p in files}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "znicz_tpu",
                               "ml_dtypes"), f"{path} imports {name}"
