"""Exported forward chains: load a bundle and serve it (port of
``znicz_tpu/export.py``).

The bundle format is the reference's, read unchanged: one ``.npz``
holding a JSON ``manifest`` (layer types + constructor configs + input
geometry + the dtype the net trained under) beside the parameter
arrays, keyed ``layer{i}_{attr}``.  :class:`ExportedModel` rebuilds
the forward chain from the manifest's layer table
(:func:`znicz_tpu_torch.models.layers.layer_type`) as ``nn.Module``
units on one device, in the trained precision mode.

Programs: batch sizes round up to the power-of-two bucket ladder
(:mod:`znicz_tpu_torch.serving.buckets`), as in the reference, and a
request runs the chain at its bucket's padded size.  PyTorch runs
eagerly, so a program here is the chain bound to one bucket size;
:meth:`ExportedModel.warmup` runs every bucket once at start, which
builds the kernels and pays every first-launch cost (kernel loading,
cuBLAS workspaces, allocator growth) before any request does.  Every
bucket keeps one device input buffer, refilled in place per dispatch.

:func:`export_forward` writes a trained port workflow in the same
format, so the bundle serves through this module and through the
reference's.  A token-first causal chain (an ``embedding`` first, every
attention causal, something to cache: an attention or an LSTM) is an
``"lm"`` bundle with the reference's ``sequence`` block (the decode
slice's metadata); any other chain a ``"scorer"``.  Both serve one-shot
here: an LM's reply is the head's distribution over the next token.

A layer's ``tied_to`` (a conv autoencoder's decoder) is written into
the manifest with ``tied_weights`` as the reference writes it, and the
chain is rebuilt with its ties: a deconv tied with ``tied_weights``
holds its conv's weights tensor itself, not a copy.

Parameters stay float32 in every precision mode.  Hot swap, int8
bundles and replication over several GPUs belong to later slices.
"""

from __future__ import annotations

import io
import json
import os
import threading

import numpy as np
import torch

from znicz_tpu_torch.backends import resolve_device, torch_dtype
from znicz_tpu_torch.models.layers import layer_type, tie, tied_config
from znicz_tpu_torch.ops.depooling import Depooling
from znicz_tpu_torch.serving.buckets import bucket_for, ladder
from znicz_tpu_torch.utils.logger import Logger

FORMAT_NAME = "znicz-tpu-forward"
FORMAT_VERSION = 1
#: default ladder cap for direct ``ExportedModel`` use (the engine
#: passes its own, typically much smaller, ``max_batch``)
DEFAULT_MAX_BATCH = 1024


def read_bundle(path: str) -> tuple[dict, dict]:
    """An exported ``.npz`` bundle's ``(manifest, params)`` as numpy,
    without building a model."""
    with np.load(path) as bundle:
        manifest = json.loads(bytes(bundle["manifest"]).decode())
        params = {k: bundle[k] for k in bundle.files if k != "manifest"}
    return manifest, params


def _sequence_meta(layers: list[dict], input_shape) -> dict | None:
    """Decode metadata of a token-first causal chain, from its layer
    specs (the reference's ``_sequence_meta``, copied): the sequence
    length it trained at, the vocabulary, the width, and one cache entry
    a stateful layer (an attention's heads, an LSTM's carries).  None
    for a chain a decoder cannot drive: no leading ``embedding``, a
    non-causal attention, or nothing to cache.  It also derives
    ``kind`` and ``sequence`` for a bundle written before they
    existed."""
    if not layers or layers[0]["type"] != "embedding":
        return None
    cfg0 = layers[0].get("config", {})
    vocab = int(cfg0["vocab_size"])
    dim = int(cfg0["dim"])
    d = dim
    cache: list[dict] = []
    for i, spec in enumerate(layers):
        kind, cfg = spec["type"], spec.get("config", {})
        if kind == "attention":
            if not cfg.get("causal"):
                return None  # bidirectional: no incremental step
            heads = int(cfg["n_heads"])
            cache.append({"layer": i, "kind": "attention",
                          "heads": heads, "head_dim": d // heads,
                          "features": d})
        elif kind == "lstm":
            hidden = cfg.get("units", cfg.get("output_sample_shape"))
            cache.append({"layer": i, "kind": "lstm",
                          "hidden": int(hidden)})
            d = int(hidden)
    if not cache:
        return None
    return {"train_t": int(input_shape[0]), "vocab": vocab,
            "dim": dim, "cache": cache}


def export_forward(workflow, path: str) -> str:
    """Write the forward chain of a trained
    :class:`~znicz_tpu_torch.models.standard_workflow.StandardWorkflow`
    to ``path`` as the reference's ``export_forward`` does: the
    manifest (layer types and configs, which parameters each layer
    has, input geometry, the precision mode it trained under, ``kind``
    "lm" with its ``sequence`` block or "scorer") beside the f32
    ``layer{i}_{attr}`` arrays in one compressed ``.npz``, written to a
    temporary file and renamed into place.  Returns the path."""
    layers = []
    for spec, unit in zip(workflow.layers_config, workflow.forwards):
        params = unit.param_shapes()
        entry = {"type": spec["type"], "config": spec.get("->", {}),
                 # a deconv tied to its conv's weights has them too
                 "has_weights": "weights" in params
                 or bool(spec.get("tied_weights")),
                 "has_bias": "bias" in params, "name": unit.name}
        if spec.get("tied_to") is not None:
            # the tie, which the chain is rebuilt with
            entry["tied_to"] = int(spec["tied_to"])
            entry["tied_weights"] = bool(spec.get("tied_weights"))
        layers.append(entry)
    input_shape = list(workflow.loader.sample_shape)
    manifest = {
        "format": FORMAT_NAME, "version": FORMAT_VERSION,
        "workflow": workflow.name, "loss": workflow.loss,
        "input_shape": input_shape,
        "dtype": str(workflow.compute_dtype).removeprefix("torch."),
        "layers": layers}
    seq = _sequence_meta(layers, input_shape)
    manifest["kind"] = "scorer" if seq is None else "lm"
    if seq is not None:
        manifest["sequence"] = seq
    arrays = {f"layer{i}_{attr}": getattr(unit, attr).detach().float()
              .cpu().numpy()
              for i, unit in enumerate(workflow.forwards)
              for attr in unit.EXPORT_PARAMS if hasattr(unit, attr)}
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


def params_from_jax(manifest: dict, params: dict) -> dict[str, torch.Tensor]:
    """Carry a reference parameter set across: ``layer{i}_{attr}`` →
    float32 CPU tensors.

    ``params`` is what the reference holds — a bundle's numpy arrays
    or live ``jax.Array`` leaves (anything ``np.asarray`` reads).
    Parameters stay float32 even in bf16 bundles, as the reference
    keeps them; a non-float parameter is refused, and so is a key
    that no layer of ``manifest`` owns."""
    n_layers = len(manifest["layers"])
    owned = {f"layer{i}_{attr}"
             for i, spec in enumerate(manifest["layers"])
             for attr in layer_type(spec["type"]).EXPORT_PARAMS}
    out: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key not in owned:
            raise ValueError(f"parameter '{key}' belongs to no layer of "
                             f"this {n_layers}-layer manifest")
        arr = np.asarray(value)
        if arr.dtype.kind not in "fV":  # 'V': ml_dtypes bfloat16
            raise ValueError(f"parameter '{key}' has non-float dtype "
                             f"{arr.dtype}")
        out[key] = torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32)))
    return out


class ExportedModel(Logger):
    """A servable forward chain loaded from an exported bundle.

    ``model(x)`` maps a numpy batch of samples of ``input_shape`` to
    the final layer's output as float32 numpy (a softmax head gives
    class probabilities).  Inputs are rounded to the manifest dtype —
    the precision mode the net trained under.

    ``device``: ``None`` → the current CUDA device (raises without a
    GPU); ``"cpu"`` runs the same arithmetic through the kernels'
    plain versions."""

    def __init__(self, manifest: dict, params: dict, device=None,
                 max_batch: int = DEFAULT_MAX_BATCH) -> None:
        super().__init__()
        if manifest.get("format") != FORMAT_NAME:
            raise ValueError("not a znicz-tpu forward bundle")
        if manifest.get("version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"bundle version {manifest['version']} is newer than "
                f"this framework ({FORMAT_VERSION})")
        if manifest.get("quant"):
            raise ValueError("int8-quantized bundles are not ported yet")
        self.manifest = manifest
        self.input_shape = tuple(manifest["input_shape"])
        self.device = resolve_device(device)
        self.dtype = torch_dtype(manifest.get("dtype", "float32"))
        self.max_batch = int(max_batch)
        self._params = params_from_jax(manifest, params)
        self.forwards = self._build_chain()
        #: bucket size → resident device input buffer (LRU-free: the
        #: ladder bounds the count at log2(max_batch) + 1)
        self._programs: dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()
        #: programs made resident (one per warmed bucket)
        self.programs_built = 0

    @classmethod
    def load(cls, path: str, device=None, **kwargs) -> "ExportedModel":
        manifest, params = read_bundle(path)
        return cls(manifest, params, device=device, **kwargs)

    @property
    def kind(self) -> str:
        """``"lm"`` (a token-first causal chain) or ``"scorer"``; a
        bundle without the key derives it from its layers."""
        kind = self.manifest.get("kind")
        if kind is None:
            kind = "lm" if self.sequence is not None else "scorer"
        return kind

    @property
    def sequence(self) -> dict | None:
        """An LM bundle's decode metadata (``train_t``, ``vocab``,
        ``dim``, the per-layer cache entries), None for a scorer; derived
        from the layers for a bundle written without ``kind``."""
        seq = self.manifest.get("sequence")
        if seq is None and "kind" not in self.manifest:
            seq = _sequence_meta(self.manifest["layers"], self.input_shape)
        return seq

    # ------------------------------------------------------------------
    def _build_chain(self) -> torch.nn.ModuleList:
        """The units of the manifest's layers, each on the one before's
        output shape, their parameters loaded; a tied layer paired with
        the layer it names, as ``StandardWorkflow.link_forwards`` pairs
        it (a deconv tied with ``tied_weights`` holds its conv's weights
        tensor itself; the bundle's copy of them is not read)."""
        units = []
        shape = self.input_shape
        layers = self.manifest["layers"]
        for i, spec in enumerate(layers):
            cls = layer_type(spec["type"])
            tied = spec.get("tied_to")
            cfg = dict(spec.get("config", {}))
            if tied is not None:
                cfg = tied_config(cls, cfg, layers[tied].get("config", {}))
            unit = cls(shape, self.dtype, **cfg)
            if tied is not None:
                tie(unit, units[tied], spec["type"],
                    spec.get("tied_weights"))
                unit.check_input_shape()
            unit.load_params({attr: self._params[f"layer{i}_{attr}"]
                              for attr in unit.param_shapes()
                              if f"layer{i}_{attr}" in self._params})
            if hasattr(unit, "forward_mode"):
                unit.forward_mode = "eval"  # dropout = identity
            units.append(unit)
            shape = unit.output_shape
        return torch.nn.ModuleList(units).to(self.device).eval()

    # ------------------------------------------------------------------
    def forward_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Run the chain on a device batch already in the manifest dtype
        (a depooling also reads its pooling's input)."""
        inputs = []
        with torch.inference_mode():
            for unit, spec in zip(self.forwards, self.manifest["layers"]):
                inputs.append(x)
                if isinstance(unit, Depooling):
                    x = unit(x, inputs[spec["tied_to"]])
                else:
                    x = unit(x)
        return x

    def program_for(self, size: int):
        """The program serving a PADDED batch of exactly ``size`` rows:
        ``fn(x_host) -> device output``, where ``x_host`` is a CPU
        tensor of the manifest dtype and shape ``(size, *input_shape)``.
        Made resident on first use.  A program owns one device input
        buffer, so one caller at a time runs it (the engine's
        scheduler thread is the sole caller)."""
        with self._lock:
            buf = self._programs.get(size)
            if buf is None:
                buf = self._programs[size] = torch.empty(
                    (size,) + self.input_shape, dtype=self.dtype,
                    device=self.device)
                self.programs_built += 1

        def run(x_host: torch.Tensor) -> torch.Tensor:
            buf.copy_(x_host, non_blocking=True)
            return self.forward_padded(buf)

        return run

    def warmup(self, max_batch: int | None = None) -> int:
        """Run every ladder bucket up to ``max_batch`` (default: this
        model's cap) once on zeros, so serve time pays no first-launch
        cost.  Returns the number of programs made resident."""
        if max_batch is not None:
            self.max_batch = max(self.max_batch, int(max_batch))
        before = self.programs_built
        for size in ladder(max_batch or self.max_batch):
            fn = self.program_for(size)
            fn(torch.zeros((size,) + self.input_shape,
                           dtype=self.dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.programs_built - before

    def _as_input(self, x) -> torch.Tensor:
        """A host batch rounded to the manifest dtype, shape-checked."""
        t = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(
            self.dtype)
        if tuple(t.shape[1:]) != self.input_shape:
            raise ValueError(f"input sample shape {tuple(t.shape[1:])} "
                             f"!= exported {self.input_shape}")
        return t.contiguous()

    def __call__(self, x) -> np.ndarray:
        x = self._as_input(x)
        batch = x.shape[0]
        size = bucket_for(batch)
        if size != batch:
            # padded rows compute on zeros and are sliced off
            padded = torch.zeros((size,) + self.input_shape,
                                 dtype=x.dtype)
            padded[:batch] = x
            x = padded
        out = self.program_for(size)(x)
        return out[:batch].float().cpu().numpy()

    def predict_classes(self, x) -> np.ndarray:
        return np.argmax(self(x), axis=1)
