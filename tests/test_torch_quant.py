"""int8 bundles in the port (``znicz_tpu_torch.serving.quantize``,
``ExportedModel``'s dequantize-on-load and its numpy oracle) against the
reference, on the CPU.

- the quantizer bit for bit against the reference's (the two tests of
  ``tests/test_quant.py`` on the quantizer itself): the same keys, int8
  tensors, scales, record, byte counts and calibration accuracies;
- the reference's int8 bundles served by the port against the
  reference's ``ExportedModel``: the sequence scorer of
  ``tests/test_torch_serving.py`` (its Pallas kernels in interpret
  mode) in f32 and bf16, within that file's ``TOL`` for the dtype
  (1e-5, 1e-3: the same arithmetic up to summation order, the weight
  ``q·scale`` rounded to the manifest dtype in both), and the trained
  blob classifier;
- the port's numpy oracle (``device="numpy"``) bit-equal to the
  reference's ``NumpyDevice`` oracle on f32 and int8 bundles, bf16
  manifests included;
- swaps between f32 and int8: int8 into an int8 chain, int8 into an f32
  chain (its dequantized values), f32 into an int8 chain refused, as in
  the reference, the replies held to the reference's after each swap;
- ``quant.calib_corrupt`` fires after the gate in both packages with
  the same corrupted scales;
- ``params_from_jax`` carries the int8 tensors and their scales and
  refuses what the quant record does not name.
"""

import json

import numpy as np
import pytest
import torch

from conftest import make_blobs
from test_torch_serving import TOL, _manifest, _params, _reference, _requests
from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.export import read_bundle
from znicz_tpu.loader.fullbatch import ArrayLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow
from znicz_tpu.serving import quantize as ref_qz
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.export import (ExportedModel, SwapIncompatible,
                                    params_from_jax)
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.serving import quantize as qz
from znicz_tpu_torch.utils.config import reset_root, root

DIM, N_CLASSES = 12, 4


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


@pytest.fixture(scope="module")
def fc_setup(tmp_path_factory):
    """The reference's trained blob classifier (``tests/test_quant.py``'s
    fixture): its f32 bundle and held-out calibration stream."""
    data, labels = make_blobs(48, N_CLASSES, DIM)
    hx, hy = data[160:], labels[160:]
    ref_prng.seed_all(9)
    wf = StandardWorkflow(
        name="quant_fc",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:160], train_labels=labels[:160],
            valid_data=hx, valid_labels=hy, minibatch_size=32),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax",
             "->": {"output_sample_shape": N_CLASSES},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": 2})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    path = str(tmp_path_factory.mktemp("quant") / "f32.npz")
    wf.export_forward(path)
    manifest, params = read_bundle(path)
    return {"calib": (hx, hy), "manifest": manifest, "params": params}


def _ref_oracle(manifest, params, x):
    return np.asarray(RefModel(dict(manifest), dict(params),
                               device=NumpyDevice())(x), np.float32)


# ----------------------------------------------------------------------
# the quantizer
# ----------------------------------------------------------------------
def test_quantizer_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    params = {
        "layer0_weights": rng.normal(size=(6, 8)).astype(np.float32),
        "layer0_bias": rng.normal(size=(8,)).astype(np.float32),
        "layer1_weights": np.zeros((4, 3), np.float32),  # degenerate
        "counter": np.arange(4, dtype=np.int32),
    }
    keys = qz.quantizable_keys(params)
    assert keys == ref_qz.quantizable_keys(params) == [
        "layer0_weights", "layer1_weights"]
    qparams, keys = qz.quantize_params(params, keys)
    want, _ = ref_qz.quantize_params(params, keys)
    assert set(qparams) == set(want)
    for key, value in qparams.items():
        assert value.dtype == want[key].dtype
        np.testing.assert_array_equal(value, want[key])
    for key in keys:
        q, s = qparams[key], qparams[qz.scale_key(key)]
        assert q.dtype == np.int8 and s.dtype == np.float32
        assert s.shape == (params[key].shape[1],)  # per-out-channel
        err = np.abs(q.astype(np.float32) * s - params[key])
        assert np.all(err <= s[None, :] / 2 + 1e-12)
    np.testing.assert_array_equal(
        qz.dequantize_array(qparams["layer1_weights"],
                            qparams[qz.scale_key("layer1_weights")]),
        params["layer1_weights"])
    rec = {"dtype": "int8", "weights": keys}
    out = qz.dequantize_params({"quant": rec}, qparams)
    ref = ref_qz.dequantize_params({"quant": rec}, want)
    assert set(out) == set(ref) == {"layer0_weights", "layer0_bias",
                                    "layer1_weights", "counter"}
    for key in out:
        np.testing.assert_array_equal(out[key], ref[key])


def test_bundle_record_bytes_and_oracle_accuracy(fc_setup):
    manifest, params = fc_setup["manifest"], fc_setup["params"]
    hx, hy = fc_setup["calib"]
    qman, qparams, info = qz.quantize_bundle(manifest, params,
                                             calib=(hx, hy))
    rman, rparams, rinfo = ref_qz.quantize_bundle(manifest, params,
                                                  calib=(hx, hy))
    assert qman == rman and info == rinfo
    for key in rparams:
        np.testing.assert_array_equal(qparams[key], rparams[key])
    rec = qman["quant"]
    assert rec["dtype"] == "int8" and "per-channel" in rec["scheme"]
    assert info["bytes_ratio"] <= 0.55
    assert abs(rec["calib_acc_delta"]) <= 0.05
    assert qz._oracle_accuracy(qman, qparams, hx, hy) == \
        ref_qz._oracle_accuracy(qman, qparams, hx, hy) == \
        pytest.approx(rec["calib_acc_int8"])


# ----------------------------------------------------------------------
# int8 bundles served, and the oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_scorer_served_as_the_reference(dtype):
    manifest, params, x = _manifest(dtype), _params(), _requests()
    qman, qparams, info = ref_qz.quantize_bundle(manifest, params)
    assert sorted(qman["quant"]["weights"]) == [
        "layer0_weights", "layer0_weights_out", "layer2_weights"]
    want = _reference(qman, qparams)(x[:3])
    port = ExportedModel(qman, qparams, device="cpu", max_batch=8)
    got = port(x[:3])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the int8 tensors and their scales are what the chain holds
    assert {k: (tuple(q.shape), q.dtype) for k, (q, _) in
            port._qtensors.items()} == {
        k: (qparams[k].shape, torch.int8) for k in qman["quant"]["weights"]}
    for i, unit in enumerate(port.forwards):
        for name, param in unit.named_parameters(recurse=False):
            if f"layer{i}_{name}" in port._qkeys:
                assert param.device.type == "meta"  # no f32 copy kept
    f32 = ExportedModel(manifest, params, device="cpu")
    assert port.resident_weight_bytes() == info["bytes_quant"]
    assert f32.resident_weight_bytes() == info["bytes_f32"]
    assert port.weights_nbytes() == info["bytes_quant"]


def test_int8_classifier_served_as_the_reference(fc_setup):
    hx, _hy = fc_setup["calib"]
    qman, qparams, _ = ref_qz.quantize_bundle(fc_setup["manifest"],
                                              fc_setup["params"])
    want = np.asarray(RefModel(qman, dict(qparams), device=XLADevice())(
        hx[:16]), np.float32)
    got = ExportedModel(qman, qparams, device="cpu")(hx[:16])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["float32"])
    np.testing.assert_allclose(
        got, ExportedModel(qman, qparams, device="numpy")(hx[:16]),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype,quantized", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)])
def test_oracle_bit_equal_to_the_reference(dtype, quantized):
    manifest, params, x = _manifest(dtype), _params(), _requests()
    if quantized:
        manifest, params, _ = ref_qz.quantize_bundle(manifest, params)
    port = ExportedModel(manifest, params, device="numpy")
    assert port.host_only and port.serve_dtype == torch.float32
    got = port(x[:5])
    assert got.dtype == np.float32 and got.shape == (5, 8)
    np.testing.assert_array_equal(got, _ref_oracle(manifest, params, x[:5]))


def test_oracle_of_a_trained_bundle_bit_equal(fc_setup):
    hx, _ = fc_setup["calib"]
    for manifest, params in (
            (fc_setup["manifest"], fc_setup["params"]),
            ref_qz.quantize_bundle(fc_setup["manifest"],
                                   fc_setup["params"])[:2]):
        np.testing.assert_array_equal(
            ExportedModel(manifest, params, device="numpy")(hx),
            _ref_oracle(manifest, params, hx))


# ----------------------------------------------------------------------
# swaps between f32 and int8
# ----------------------------------------------------------------------
def _twins(seed):
    manifest, params = _manifest("bfloat16"), _params(seed)
    qman, qparams, _ = ref_qz.quantize_bundle(manifest, params)
    return (manifest, params), (qman, qparams)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_int8_and_f32_swaps_as_the_reference(device):
    (man_a, f32_a), (qman_a, q_a) = _twins(0)
    (man_b, f32_b), (qman_b, q_b) = _twins(5)
    x = _requests()[:3]
    ref_dev = NumpyDevice if device == "numpy" else XLADevice
    tol = 0.0 if device == "numpy" else TOL["bfloat16"]

    def ref_model(manifest, params):
        if device == "numpy":
            return RefModel(manifest, dict(params), device=NumpyDevice())
        return _reference(manifest, params)

    def check(port, ref):
        np.testing.assert_allclose(port(x), np.asarray(ref(x), np.float32),
                                   rtol=0, atol=tol)

    # int8 into an int8 chain: the resident q and scales written in place
    port, ref = ExportedModel(qman_a, q_a, device=device), \
        ref_model(qman_a, q_a)
    check(port, ref)
    before = {k: (q.data_ptr(), s.data_ptr())
              for k, (q, s) in port._qtensors.items()}
    assert port.swap_weights(q_b, manifest=qman_b) == 1
    ref.swap_weights(dict(q_b), manifest=qman_b)
    check(port, ref)
    assert {k: (q.data_ptr(), s.data_ptr())
            for k, (q, s) in port._qtensors.items()} == before
    for key in qman_b["quant"]["weights"]:
        assert port._params[key].dtype == np.int8
        np.testing.assert_array_equal(port._params[key], q_b[key])
    # f32 into an int8 chain: refused in both, the incumbent untouched
    kept = port(x)
    with pytest.raises(SwapIncompatible, match="int8"):
        port.swap_weights(f32_a, manifest=man_a)
    with pytest.raises(Exception, match="int8"):
        ref.swap_weights(dict(f32_a), manifest=man_a)
    np.testing.assert_array_equal(port(x), kept)
    assert port.weights_version == 1
    # int8 into an f32 chain: its dequantized values, in f32
    port, ref = ExportedModel(man_a, f32_a, device=device), \
        ref_model(man_a, f32_a)
    port.swap_weights(q_b, manifest=qman_b)
    ref.swap_weights(dict(q_b), manifest=qman_b)
    check(port, ref)
    assert not port._qtensors
    np.testing.assert_array_equal(
        port._params["layer0_weights"],
        qz.dequantize_array(q_b["layer0_weights"],
                            q_b["layer0_weights_scale"]))
    assert port.weights_nbytes() == qz.weight_nbytes(f32_b)


# ----------------------------------------------------------------------
# quant.calib_corrupt and params_from_jax
# ----------------------------------------------------------------------
def test_calib_corrupt_fires_after_the_gate(fc_setup):
    manifest, params = fc_setup["manifest"], fc_setup["params"]
    calib = fc_setup["calib"]
    recipe = {"quant.calib_corrupt": {"at": [1], "factor": 32.0}}
    root.common.engine.faults = dict(recipe)
    ref_root.common.engine.faults = dict(recipe)
    injected = metrics.faults_injected("quant.calib_corrupt").value
    qman, qparams, info = qz.quantize_bundle(manifest, params, calib=calib)
    rman, rparams, rinfo = ref_qz.quantize_bundle(manifest, params,
                                                  calib=calib)
    assert info["corrupted"] and rinfo["corrupted"]
    assert metrics.faults_injected("quant.calib_corrupt").value == \
        injected + 1
    assert qman == rman
    for key in rparams:
        np.testing.assert_array_equal(qparams[key], rparams[key])
    # the gate's accuracies were taken before the corruption
    assert abs(qman["quant"]["calib_acc_delta"]) <= 0.05
    clean = qz.quantize_bundle(manifest, params)[1]
    for key in qman["quant"]["weights"]:
        sk = qz.scale_key(key)
        np.testing.assert_array_equal(qparams[key], clean[key])
        want = clean[sk] * np.float32(32.0)
        want[::2] *= -1.0
        np.testing.assert_array_equal(qparams[sk], want)
    # only the first arrival fired
    assert not qz.quantize_bundle(manifest, params)[2].get("corrupted")


def test_params_from_jax_carries_int8_and_scales():
    import jax.numpy as jnp
    manifest, params = _manifest("bfloat16"), _params()
    qman, qparams, _ = ref_qz.quantize_bundle(manifest, params)
    live = {k: jnp.asarray(v) for k, v in qparams.items()}
    out = params_from_jax(qman, live)
    assert set(out) == set(qparams)
    for key, value in out.items():
        assert value.device.type == "cpu"
        if key in qman["quant"]["weights"]:
            assert value.dtype == torch.int8
        else:
            assert value.dtype == torch.float32
        np.testing.assert_array_equal(value.numpy(), qparams[key])
    # int8 the record does not name, a stray scale, a missing scale
    with pytest.raises(ValueError, match="non-float"):
        params_from_jax(manifest, {"layer0_weights":
                                   qparams["layer0_weights"]})
    with pytest.raises(ValueError, match="belongs to no layer"):
        params_from_jax(manifest, {"layer0_weights_scale": np.ones(3)})
    with pytest.raises(ValueError, match="without their scales"):
        params_from_jax(qman, {k: v for k, v in qparams.items()
                               if k != "layer2_weights_scale"})
    bad = dict(qman, quant=dict(qman["quant"],
                                weights=["layer9_weights"]))
    with pytest.raises(ValueError, match="belong to no layer"):
        params_from_jax(bad, {})
    wrong = dict(qparams, layer2_weights=params["layer2_weights"])
    with pytest.raises(ValueError, match="int8 by the quant record"):
        params_from_jax(qman, wrong)
    # the bundle file round trip, as a publisher writes it
    assert json.loads(json.dumps(qman)) == qman
