"""Post-training int8 weight quantization (copy of
``znicz_tpu/serving/quantize.py``).

Weight-only, per-output-channel symmetric absmax scheme (Dettmers et
al., *LLM.int8()*, arXiv:2208.07339): for a 2-D weight ``W`` stored
``(in, out)`` — this repo's layout — each output channel ``o`` gets one
scale ``s[o] = max|W[:, o]| / 127`` and the stored tensor becomes
``q = round(W / s)`` in int8.  Dequantization ``q.astype(f32) * s`` is
exact arithmetic on representable values, so the in-program
dequantize-on-load path and the host-side dequantized numpy oracle are
bitwise identical — the repo's oracle discipline survives quantization
unchanged.

Only 2-D float arrays whose key contains ``weights`` are quantized
(dense/attention projections and embeddings); biases, conv kernels,
and norm gains stay f32 — they are a rounding error of the bundle
bytes and per-channel semantics are ill-defined for them.  The chosen
keys are stamped into the manifest as ``manifest["quant"]`` next to
the existing ``dtype`` record, so every consumer (:class:`~znicz_tpu_torch.
export.ExportedModel`, the swap validator) discovers
quantization from the bundle alone.

Calibration rides the publish pipeline (the publisher is ROADMAP A11):
the publisher's canary/shadow stream supplies ``(x, y)`` and the numpy
f32 oracle (``ExportedModel(device="numpy")``) is the accuracy gate —
a quantization whose calibration accuracy regresses past the swap
guard margin is never published (the f32 bundle ships instead).  The ``quant.calib_corrupt`` fault site corrupts the scales
AFTER the gate, modeling a calibration bug that slips publication: the
SwapController's canary must then reject the bundle downstream.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.resilience import faults as _faults

QUANT_DTYPE = "int8"
SCHEME = "symmetric-per-channel"

#: absmax floor — an all-zero channel quantizes to zeros with a scale
#: that never divides by zero
_EPS = 1e-12


def scale_key(key: str) -> str:
    """The params key carrying a quantized tensor's per-channel
    scales."""
    return f"{key}_scale"


def is_quantized(manifest: dict | None) -> dict | None:
    """The bundle's quant record (``{"dtype", "scheme", "weights"}``)
    or ``None`` for f32 bundles."""
    if not manifest:
        return None
    return manifest.get("quant") or None


def quantizable_keys(params: dict) -> list[str]:
    """Keys this scheme quantizes: 2-D float ``*weights*`` arrays —
    per-output-channel scales need a well-defined output axis (last,
    in the ``(in, out)`` layout).  Everything else ships f32."""
    out = []
    for key, arr in params.items():
        a = np.asarray(arr)
        if ("weights" in key and not key.endswith("_scale")
                and a.ndim == 2 and a.dtype.kind == "f"):
            out.append(key)
    return sorted(out)


def quantize_array(w) -> tuple[np.ndarray, np.ndarray]:
    """``(in, out)`` f32 → ``(q int8, scale f32 (out,))``."""
    w = np.asarray(w, dtype=np.float32)
    scale = np.maximum(np.abs(w).max(axis=0), _EPS) / 127.0
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_array(q, scale) -> np.ndarray:
    """int8 + per-channel scales → f32 (broadcast over the last
    axis)."""
    return np.asarray(q, dtype=np.float32) * np.asarray(
        scale, dtype=np.float32)


def quantize_params(params: dict,
                    keys: list[str] | None = None
                    ) -> tuple[dict, list[str]]:
    """Quantize ``keys`` (default: every quantizable key) of a bundle
    param dict; returns ``(new_params, keys)`` with int8 tensors under
    the original keys plus ``<key>_scale`` f32 leaves."""
    if keys is None:
        keys = quantizable_keys(params)
    out = {}
    for key, arr in params.items():
        if key in keys:
            q, s = quantize_array(arr)
            out[key] = q
            out[scale_key(key)] = s
        else:
            out[key] = arr
    return out, list(keys)


def dequantize_params(manifest: dict | None, params: dict) -> dict:
    """Expand a quantized bundle's params back to f32 (scale keys
    dropped).  No-op passthrough for f32 bundles — safe to call on
    anything the watcher hands over."""
    rec = is_quantized(manifest)
    if rec is None:
        return params
    keys = set(rec.get("weights", []))
    out = {}
    for key, arr in params.items():
        if key in keys:
            out[key] = dequantize_array(arr, params[scale_key(key)])
        elif not (key.endswith("_scale") and key[:-6] in keys):
            out[key] = arr
    return out


def weight_nbytes(params: dict) -> int:
    """Total parameter bytes of a bundle's array dict (manifest buffer
    excluded by construction — it is not in the dict)."""
    return int(sum(np.asarray(v).nbytes for v in params.values()))


def _oracle_accuracy(manifest: dict, params: dict, x, y) -> float:
    """Top-1 accuracy of the bundle on the calibration stream through
    the compile-free numpy oracle (the same scorer the canary uses)."""
    from znicz_tpu_torch.export import ExportedModel
    model = ExportedModel(dict(manifest), dict(params), device="numpy")
    pred = model.predict_classes(np.asarray(x))
    return float(np.mean(pred == np.asarray(y).reshape(-1)))


def quantize_bundle(manifest: dict, params: dict,
                    calib: tuple | None = None) -> tuple:
    """Quantize an exported bundle: ``(manifest, params)`` →
    ``(new_manifest, new_params, info)``.

    When ``calib=(x, y)`` is given (the canary/shadow stream), both
    arms are scored through the numpy f32 oracle and the accuracies
    ride the quant record — the publisher compares ``acc_delta``
    against the guard margin and falls back to f32 on a regression.
    The ``quant.calib_corrupt`` fault fires AFTER the gate (payload
    ``factor``, default 64), mis-scaling the published tensors the way
    a calibration bug would: downstream canary rejection is the only
    line of defense left, which is exactly what the chaos drill
    proves.
    """
    keys = quantizable_keys(params)
    info = {"keys": keys, "bytes_f32": weight_nbytes(params)}
    if not keys:
        info.update(bytes_quant=info["bytes_f32"], bytes_ratio=1.0,
                    quantized=False)
        return manifest, params, info
    qparams, keys = quantize_params(params, keys)
    record = {"dtype": QUANT_DTYPE, "scheme": SCHEME, "weights": keys}
    if calib is not None:
        x, y = calib
        new_manifest = dict(manifest)
        new_manifest["quant"] = record
        acc_f32 = _oracle_accuracy(manifest, params, x, y)
        acc_q = _oracle_accuracy(new_manifest, qparams, x, y)
        record["calib_acc_f32"] = acc_f32
        record["calib_acc_int8"] = acc_q
        record["calib_acc_delta"] = acc_f32 - acc_q
    payload = _faults.fire("quant.calib_corrupt")
    if payload is not None:
        # mis-scale AND sign-scramble alternating channels — a pure
        # uniform blow-up can survive saturating activations with its
        # argmax intact, which would let a broken calibration pass the
        # canary this drill exists to trip
        factor = float(payload.get("factor", 64.0))
        for key in keys:
            sk = scale_key(key)
            s = np.asarray(qparams[sk], np.float32) * factor
            s[::2] *= -1.0
            qparams[sk] = s
        info["corrupted"] = True
    new_manifest = dict(manifest)
    new_manifest["quant"] = record
    info.update(bytes_quant=weight_nbytes(qparams),
                quantized=True,
                acc_f32=record.get("calib_acc_f32"),
                acc_int8=record.get("calib_acc_int8"),
                acc_delta=record.get("calib_acc_delta"))
    info["bytes_ratio"] = info["bytes_quant"] / max(
        1, info["bytes_f32"])
    return new_manifest, qparams, info
