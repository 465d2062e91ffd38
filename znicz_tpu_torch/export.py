"""Exported forward chains: load a bundle and serve it (port of
``znicz_tpu/export.py``).

The bundle format is the reference's, read unchanged: one ``.npz``
holding a JSON ``manifest`` (layer types + constructor configs + input
geometry + the dtype the net trained under) beside the parameter
arrays, keyed ``layer{i}_{attr}``.  :class:`ExportedModel` rebuilds
the forward chain from the manifest's layer table
(:func:`znicz_tpu_torch.models.layers.layer_type`) as ``nn.Module``
units on one device, in the trained precision mode, or, on
``device="numpy"``, on the numpy oracle (every unit's ``numpy_run``, f32
replies, as the reference's ``NumpyDevice`` serves).

Programs: batch sizes round up to the power-of-two bucket ladder
(:mod:`znicz_tpu_torch.serving.buckets`), as in the reference, and a
request runs the chain at its bucket's padded size.  A program is the
chain bound to one bucket and one resident device input buffer.  On the
card it is a CUDA graph, the port of the reference's AOT program: the
chain is captured once per bucket (at :meth:`ExportedModel.warmup`, or
on the bucket's first dispatch above the warmed ladder), after an eager
warm-up on a side stream, and every later dispatch is a copy into the
buffer and one replay.  The graphs share one memory pool, so the ladder
holds one set of activations, not one a bucket; that is safe because
every caller copies a reply to the host before the next dispatch.  A
replay runs no Python, so the kernels' launch counters take what the
capture counted once a replay (:mod:`znicz_tpu_torch.ops.launch_counts`).
On the CPU and on the oracle the chain runs eagerly; there is no switch
(:attr:`ExportedModel.graphed`).  A failed capture raises, naming the
bucket.

Residency, as in the reference: the programs are an LRU of at most
:attr:`ExportedModel._program_capacity` buckets (the ladder up to
``max_batch``), so a bucket above the ladder evicts the least recently
used one, and a model may join a fleet's shared ladder budget
(:meth:`ExportedModel.attach_program_budget`), which charges each new
program :meth:`ExportedModel.program_nbytes` and may call
:meth:`ExportedModel.drop_program` on it.  Dropping a bucket releases
its CUDA graph and the graph's output under the model's lock with the
collector off (a graph is never left to a reference cycle, whose
collection could land inside another capture); the next request for
the bucket captures it again.  The budget is charged after the caller
lets go of the model's lock (:meth:`ExportedModel.settle_budget`),
because an eviction takes another model's lock.

Hot swap (:meth:`ExportedModel.swap_weights`) replaces the parameters
without a new capture, in the reference's three phases: validate
(:class:`SwapIncompatible`, the incumbent untouched), stage the new
weights on the device off the dispatch path, then publish them between
two dispatches as one device-to-device ``copy_`` into the tensors the
graphs read.  A parameter rebound to a new tensor instead would leave
the graphs reading the old one, so a replay that finds one rebound
raises.  Parameters are deduplicated by identity: a deconv tied with
``tied_weights`` holds its conv's tensor, and one copy writes both.

int8 bundles (:mod:`znicz_tpu_torch.serving.quantize`, the manifest's
``quant`` record) keep their int8 tensors and per-channel scales
resident; the chain dequantizes them on load, as the reference's
programs do: the weight is ``q·scale`` rounded to the manifest dtype.

:func:`export_forward` writes a trained port workflow in the same
format, so the bundle serves through this module and through the
reference's.  A token-first causal chain (an ``embedding`` first, every
attention causal, something to cache: an attention or an LSTM) is an
``"lm"`` bundle with the reference's ``sequence`` block (what a
decoder reads); any other chain a ``"scorer"``.  Both serve one-shot
here (an LM's reply is the head's distribution over the next token),
and an LM generates through
:class:`~znicz_tpu_torch.serving.decode.DecodeEngine`.

:func:`attach_decode_meta` stamps the decode plane's defaults (page
geometry, a drafter) into an LM bundle, which
:class:`~znicz_tpu_torch.serving.decode.DecodeModel` reads through
:attr:`ExportedModel.decode_meta` beside the host parameters, the int8
keys and the units.

A layer's ``tied_to`` (a conv autoencoder's decoder) is written into
the manifest with ``tied_weights`` as the reference writes it, and the
chain is rebuilt with its ties: a deconv tied with ``tied_weights``
holds its conv's weights tensor itself, not a copy.

Parameters stay float32 in every precision mode, but for an int8
bundle's dequantized weights.  Replication over several GPUs belongs to
ROADMAP A9.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import threading
import time
from collections import Counter, OrderedDict

import numpy as np
import torch
from torch import nn

from znicz_tpu_torch.backends import NumpyDevice, resolve_device, torch_dtype
from znicz_tpu_torch.models.layers import layer_type, tie, tied_config
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.ops.depooling import Depooling
from znicz_tpu_torch.serving import quantize as _quantize
from znicz_tpu_torch.serving.buckets import bucket_for, ladder
from znicz_tpu_torch.utils.logger import Logger

FORMAT_NAME = "znicz-tpu-forward"
FORMAT_VERSION = 1
#: default ladder cap for direct ``ExportedModel`` use (the engine
#: passes its own, typically much smaller, ``max_batch``)
DEFAULT_MAX_BATCH = 1024


class SwapIncompatible(RuntimeError):
    """A candidate weight set does not fit the serving chain (layer
    table, parameter shapes or dtypes disagree with the manifest the
    programs were captured for).  Raised before anything is staged or
    published: the incumbent weights are untouched and keep serving."""


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
    temporary file and renamed into place.  Under tensor parallelism the
    parameters are gathered from their blocks first (a collective every
    process joins) and process 0 writes.  Returns the path."""
    from znicz_tpu_torch.parallel.distributed import process_info
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
    # a parameter held in blocks over processes (tensor parallelism) is
    # gathered (every process calls this in lockstep); process 0 writes
    arrays = {f"layer{i}_{attr}": unit.full_tensor(
        attr, getattr(unit, attr)).detach().float().cpu().numpy()
        for i, unit in enumerate(workflow.forwards)
        for attr in unit.EXPORT_PARAMS if hasattr(unit, attr)}
    if process_info()[0] == 0:
        _write_bundle(path, manifest, arrays)
    return path


def _write_bundle(path: str, manifest: dict, arrays: dict) -> None:
    """``arrays`` and the JSON ``manifest`` as one compressed ``.npz``,
    written to a temporary file and renamed into place."""
    arrays = dict(arrays)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def attach_decode_meta(path: str, *, page_tokens: int | None = None,
                       pool_tokens: int | None = None,
                       drafter: str | None = None,
                       spec_draft_k: int | None = None) -> dict:
    """Stamp decode defaults into an LM bundle's manifest (the
    reference's ``attach_decode_meta``): the paged cache's geometry
    (``kv_page_tokens``, ``pool_tokens``) and a speculative drafter (a
    bundle path and ``spec_draft_k``), merged into any ``decode``
    section already there, so a
    :class:`~znicz_tpu_torch.serving.decode.DecodeEngine` built from the
    bundle alone serves with them.  The file is rewritten atomically; a
    published bundle's ``.sha256`` sidecar is rewritten to the new
    digest.  Refuses a scorer bundle.  Returns the section written."""
    manifest, params = read_bundle(path)
    if manifest.get("kind", "lm") != "lm":
        raise ValueError(f"bundle '{path}' is a '{manifest.get('kind')}' "
                         f"— decode metadata belongs on LM bundles")
    meta = dict(manifest.get("decode", {}))
    for key, value in (("kv_page_tokens", page_tokens),
                       ("pool_tokens", pool_tokens),
                       ("drafter", drafter),
                       ("spec_draft_k", spec_draft_k)):
        if value is not None:
            meta[key] = value
    manifest["decode"] = meta
    _write_bundle(path, manifest, {k: np.asarray(v)
                                   for k, v in params.items()})
    sidecar = f"{path}.sha256"
    if os.path.exists(sidecar):
        from znicz_tpu_torch.utils.snapshotter import _sha256_file
        side_tmp = f"{sidecar}.{os.getpid()}.tmp"
        with open(side_tmp, "w") as f:
            f.write(_sha256_file(path) + "\n")
        os.replace(side_tmp, sidecar)
    return meta


def params_from_jax(manifest: dict, params: dict) -> dict[str, torch.Tensor]:
    """Carry a reference parameter set across: ``layer{i}_{attr}`` →
    CPU tensors.

    ``params`` is what the reference holds — a bundle's numpy arrays
    or live ``jax.Array`` leaves (anything ``np.asarray`` reads).
    Float parameters become float32 even in bf16 bundles, as the
    reference keeps them.  The keys the manifest's ``quant`` record
    names stay int8, each beside its ``<key>_scale`` float32 leaf.  A
    non-float parameter the record does not name is refused, and so is
    a key that no layer of ``manifest`` owns."""
    n_layers = len(manifest["layers"])
    owned = {f"layer{i}_{attr}"
             for i, spec in enumerate(manifest["layers"])
             for attr in layer_type(spec["type"]).EXPORT_PARAMS}
    rec = _quantize.is_quantized(manifest)
    qkeys = set((rec or {}).get("weights", []))
    stray = sorted(qkeys - owned)
    if stray:
        raise ValueError(f"the quant record names {stray}, which belong "
                         f"to no layer of this {n_layers}-layer manifest")
    scales = {_quantize.scale_key(k): k for k in qkeys}
    out: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key not in owned and key not in scales:
            raise ValueError(f"parameter '{key}' belongs to no layer of "
                             f"this {n_layers}-layer manifest")
        arr = np.asarray(value)
        if key in qkeys:
            if arr.dtype != np.int8:
                raise ValueError(f"parameter '{key}' is int8 by the quant "
                                 f"record but has dtype {arr.dtype}")
            out[key] = torch.from_numpy(np.array(arr, copy=True))
            continue
        if arr.dtype.kind not in "fV":  # 'V': ml_dtypes bfloat16
            raise ValueError(f"parameter '{key}' has non-float dtype "
                             f"{arr.dtype}")
        out[key] = torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32)))
    missing = sorted(scales.keys() - out.keys())
    if qkeys & out.keys() and missing:
        raise ValueError(f"int8 parameters without their scales: "
                         f"{missing}")
    return out


class _Program:
    """One bucket: its resident device input buffer and, on the card,
    its CUDA graph, the graph's output, the launches its capture
    counted and the addresses of the parameters it reads."""

    __slots__ = ("size", "buf", "graph", "out", "launches", "fixed")

    def __init__(self, size: int, buf) -> None:
        self.size = size
        self.buf = buf
        self.graph = None
        self.out = None
        self.launches: list = []
        self.fixed: list = []


class _Staged:
    """A validated candidate weight set, on the serving device: the new
    tensors by key (an int8 key's ``(q, scale)`` pair), and what the
    host-side bundle dict takes when it is published."""

    __slots__ = ("tensors", "host", "seconds")

    def __init__(self, tensors: list, host: dict, seconds: float) -> None:
        self.tensors = tensors
        self.host = host
        self.seconds = seconds


def _device_guard(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card; nothing for the host, whose
    chain is captured only under a stand-in for the CUDA graph API."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _is_oracle(device) -> bool:
    return isinstance(device, NumpyDevice) or (
        isinstance(device, str) and device == "numpy")


class ExportedModel(Logger):
    """A servable forward chain loaded from an exported bundle.

    ``model(x)`` maps a numpy batch of samples of ``input_shape`` to
    the final layer's output as float32 numpy (a softmax head gives
    class probabilities), a host copy.  Inputs are rounded to the
    manifest dtype — the precision mode the net trained under — but on
    the oracle, which serves float32 as the reference's does.

    ``device``: ``None`` → the current CUDA device (raises without a
    GPU); ``"cpu"`` runs the same arithmetic through the kernels'
    plain versions; ``"numpy"`` (or a
    :class:`~znicz_tpu_torch.backends.NumpyDevice`) the numpy oracle."""

    def __init__(self, manifest: dict, params: dict, device=None,
                 max_batch: int = DEFAULT_MAX_BATCH) -> None:
        super().__init__()
        if manifest.get("format") != FORMAT_NAME:
            raise ValueError("not a znicz-tpu forward bundle")
        if manifest.get("version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"bundle version {manifest['version']} is newer than "
                f"this framework ({FORMAT_VERSION})")
        self.manifest = manifest
        self.input_shape = tuple(manifest["input_shape"])
        #: True on the numpy oracle: every unit's ``numpy_run``
        self.host_only = _is_oracle(device)
        self.device = (torch.device("cpu") if self.host_only
                       else resolve_device(device))
        self.dtype = torch_dtype(manifest.get("dtype", "float32"))
        #: what a request is rounded to: the manifest dtype, f32 on the
        #: oracle
        self.serve_dtype = torch.float32 if self.host_only else self.dtype
        self.max_batch = int(max_batch)
        self._quant = _quantize.is_quantized(manifest)
        self._qkeys = frozenset((self._quant or {}).get("weights", []))
        tensors = params_from_jax(manifest, params)
        #: the bundle's arrays on the host as published (int8 keys and
        #: their scales as they are): what the shadow oracle and
        #: :meth:`weights_nbytes` read, refreshed by each swap
        self._params = {k: t.numpy() for k, t in tensors.items()}
        self.forwards = self._build_chain(tensors)
        #: resident int8 weights on the device: key → (q, scale)
        self._qtensors: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        #: unit index → {attr: key} of the weights it dequantizes
        self._qattrs: dict[int, dict[str, str]] = {}
        if self._qkeys and not self.host_only:
            self._make_int8_resident(tensors)
        #: ``(key, unit, attr)`` of every parameter, deduplicated by
        #: identity (a tied deconv's weights are its conv's)
        self._pairs = self._param_pairs()
        #: bucket size → its program, least recently used first (the
        #: ladder bounds the count)
        self._programs: "OrderedDict[int, _Program]" = OrderedDict()
        #: bucket size → dispatches that found its program resident
        self.program_hits: Counter = Counter()
        #: the fleet's shared ladder budget this model charges, if any
        self._shared_budget = None
        self._budget_key = ""
        self._budget_priority = 0
        #: budget calls waiting for the model's lock to be let go
        self._budget_ops: list[tuple] = []
        #: held by every dispatch (through the host copy of its reply),
        #: every capture and every publish: a publish never lands
        #: inside a dispatch
        self._lock = threading.RLock()
        self._pool = None
        #: the stream of this model's device its warm-ups and captures
        #: run on
        self._side = None
        #: programs made resident (one per warmed bucket)
        self.programs_built = 0
        self.weights_version = 0

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

    @property
    def decode_meta(self) -> dict:
        """The manifest's ``decode`` section (:func:`attach_decode_meta`),
        empty when the bundle has none."""
        return dict(self.manifest.get("decode", {}))

    @property
    def graphed(self) -> bool:
        """True when a bucket's dispatch replays its CUDA graph: on the
        card."""
        return self.device.type == "cuda"

    @property
    def captures(self) -> int:
        """Resident buckets whose graph is captured."""
        return sum(p.graph is not None for p in self._programs.values())

    @property
    def _program_capacity(self) -> int:
        """Resident programs at most: the ladder up to ``max_batch``."""
        return len(ladder(self.max_batch))

    # ------------------------------------------------------------------
    def _dequantize(self, q: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
        """``q·scale`` rounded to the manifest dtype, held in f32 (the
        reference's ``(q.astype(f32) * s).astype(dtype)``)."""
        return (q.float() * scale).to(self.dtype).float()

    def _build_chain(self, tensors: dict) -> torch.nn.ModuleList:
        """The units of the manifest's layers, each on the one before's
        output shape, their parameters loaded (an int8 key's as its
        dequantized weight); a tied layer paired with the layer it
        names, as ``StandardWorkflow.link_forwards`` pairs it (a deconv
        tied with ``tied_weights`` holds its conv's weights tensor
        itself; the bundle's copy of them is not read).  The oracle's
        units compute in f32, as the reference's ``NumpyDevice``."""
        units = []
        shape = self.input_shape
        layers = self.manifest["layers"]
        compute = torch.float32 if self.host_only else self.dtype
        for i, spec in enumerate(layers):
            cls = layer_type(spec["type"])
            tied = spec.get("tied_to")
            cfg = dict(spec.get("config", {}))
            if tied is not None:
                cfg = tied_config(cls, cfg, layers[tied].get("config", {}))
            unit = cls(shape, compute, **cfg)
            if tied is not None:
                tie(unit, units[tied], spec["type"],
                    spec.get("tied_weights"))
                unit.check_input_shape()
            values = {}
            for attr in unit.param_shapes():
                key = f"layer{i}_{attr}"
                if key in self._qkeys and key in tensors:
                    values[attr] = self._dequantize(
                        tensors[key], tensors[_quantize.scale_key(key)])
                elif key in tensors:
                    values[attr] = tensors[key]
            unit.load_params(values)
            if hasattr(unit, "forward_mode"):
                unit.forward_mode = "eval"  # dropout = identity
            units.append(unit)
            shape = unit.output_shape
        return torch.nn.ModuleList(units).to(self.device).eval()

    def _param_pairs(self) -> list[tuple[str, object, str]]:
        seen: set[int] = set()
        out = []
        for i, unit in enumerate(self.forwards):
            for attr in unit.param_shapes():
                tensor = getattr(unit, attr)
                if id(tensor) not in seen:
                    seen.add(id(tensor))
                    out.append((f"layer{i}_{attr}", unit, attr))
        return out

    def _make_int8_resident(self, tensors: dict) -> None:
        """Each int8 weight and its scales onto the device; the unit's
        f32 parameter gives way to a shape-only placeholder, which the
        dequantized weight replaces in each forward."""
        for i, unit in enumerate(self.forwards):
            for attr in unit.param_shapes():
                key = f"layer{i}_{attr}"
                if key not in self._qkeys:
                    continue
                self._qtensors[key] = (
                    tensors[key].to(self.device),
                    tensors[_quantize.scale_key(key)].to(self.device))
                shape = getattr(unit, attr).shape
                setattr(unit, attr, nn.Parameter(
                    torch.empty(shape, device="meta"), requires_grad=False))
                self._qattrs.setdefault(i, {})[attr] = key

    def _bound_tensors(self) -> list[tuple[str, torch.Tensor]]:
        """Every tensor a program reads as a parameter, by key (an int8
        key's ``q`` and its scales)."""
        out = []
        for key, unit, attr in self._pairs:
            if key in self._qtensors:
                q, s = self._qtensors[key]
                out += [(key, q), (_quantize.scale_key(key), s)]
            else:
                out.append((key, getattr(unit, attr)))
        return out

    def resident_weight_bytes(self) -> int:
        """Bytes of the parameters the programs read on the device: an
        int8 weight's ``q`` and scales, every other parameter in f32."""
        return int(sum(t.numel() * t.element_size()
                       for _, t in self._bound_tensors()))

    def weights_nbytes(self) -> int:
        """Parameter bytes of the bundle as published (an int8 bundle's
        ``q`` tensors and scale vectors as they are)."""
        return int(sum(np.asarray(v).nbytes for v in self._params.values()))

    # ------------------------------------------------------------------
    def forward_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Run the chain on a device batch already in the manifest dtype
        (a depooling also reads its pooling's input; an int8 weight is
        dequantized as its unit runs)."""
        inputs = []
        with torch.inference_mode():
            for i, (unit, spec) in enumerate(
                    zip(self.forwards, self.manifest["layers"])):
                inputs.append(x)
                args = ((x, inputs[spec["tied_to"]])
                        if isinstance(unit, Depooling) else (x,))
                quant = self._qattrs.get(i)
                if quant:
                    weights = {attr: self._dequantize(*self._qtensors[key])
                               for attr, key in quant.items()}
                    x = torch.func.functional_call(unit, weights, args)
                else:
                    x = unit(*args)
        return x

    def _oracle_forward(self, x: np.ndarray) -> np.ndarray:
        """The chain on the numpy oracle: each unit's ``numpy_run`` on
        the one before's output (f32)."""
        for unit in self.forwards:
            unit.input = x
            unit.numpy_run()
            x = np.asarray(unit.output, dtype=np.float32)
        return np.array(x, copy=True)

    def program_for(self, size: int):
        """The program serving a PADDED batch of exactly ``size`` rows:
        ``fn(x_host) -> output``, where ``x_host`` is a CPU tensor of
        :attr:`serve_dtype` and shape ``(size, *input_shape)``; the
        output is a device tensor that the next dispatch overwrites, so
        the caller copies it to the host first, holding
        :attr:`_lock` (the engine's scheduler thread does), and then
        calls :meth:`settle_budget`.  Made resident on first use (the
        least recently used bucket leaves past the ladder); on the card
        the first dispatch captures the bucket's graph."""
        with self._lock:
            prog = self._resident(size)
        return functools.partial(self._run_program, prog)

    def _resident(self, size: int) -> _Program:
        """The resident program of bucket ``size``, made resident on a
        miss; called holding :attr:`_lock`.  The calls it owes a shared
        budget wait in :attr:`_budget_ops`."""
        owed = self._budget_ops if self._shared_budget is not None \
            else []
        prog = self._programs.get(size)
        if prog is not None:
            self._programs.move_to_end(size)
            self.program_hits[size] += 1
            owed.append(("touch", size))
            return prog
        buf = None if self.host_only else torch.zeros(
            (size,) + self.input_shape, dtype=self.serve_dtype,
            device=self.device)
        prog = self._programs[size] = _Program(size, buf)
        self.programs_built += 1
        owed.append(("charge", size))
        while len(self._programs) > self._program_capacity:
            gone, old = self._programs.popitem(last=False)
            self._release(old)
            owed.append(("forget", gone))
            self.debug("evicted the program of bucket %d (LRU, cap %d)",
                       gone, self._program_capacity)
        return prog

    def _release(self, prog: _Program) -> None:
        """Free a program's graph, its output and its input buffer, with
        the collector off (called holding :attr:`_lock`, so never inside
        this model's captures)."""
        collecting = gc.isenabled()
        gc.disable()
        try:
            reset = getattr(prog.graph, "reset", None)
            if reset is not None:
                reset()
            prog.graph = prog.out = prog.buf = None
            prog.launches, prog.fixed = [], []
        finally:
            if collecting:
                gc.enable()

    def attach_program_budget(self, budget, key: str,
                              priority: int = 0) -> None:
        """Join a fleet's shared ladder budget: every program this model
        makes resident is charged to ``budget`` under ``key`` at the
        tenant ``priority`` (smaller is more important), and the budget
        may call :meth:`drop_program` on any model it holds."""
        self._shared_budget = budget
        self._budget_key = str(key)
        self._budget_priority = int(priority)
        budget.register(key, self, priority)

    def program_nbytes(self, size: int) -> int:
        """The reference's estimate of one program's working set, which
        the shared budget charges: the padded input batch's bytes times
        the chain's depth plus one (the parameters are shared across
        buckets and left out)."""
        sample = int(np.prod(self.input_shape or (1,)))
        itemsize = torch.empty((), dtype=self.serve_dtype).element_size()
        return size * sample * itemsize * (len(self.forwards) + 1)

    def drop_program(self, size: int) -> bool:
        """Evict bucket ``size``'s program (shared-budget pressure): its
        graph and output are released under :attr:`_lock`, so a
        dispatch holding the lock finishes on it first, and the next
        request for the bucket captures it again.  True when a resident
        program was dropped."""
        with self._lock:
            prog = self._programs.pop(size, None)
            if prog is None:
                return False
            self._release(prog)
        self.debug("dropped the program of bucket %d (shared ladder "
                   "budget)", size)
        return True

    def settle_budget(self) -> None:
        """Pass the budget calls the last dispatches owe to the shared
        budget; called without holding :attr:`_lock`, since a charge's
        evictions take the victims' locks."""
        with self._lock:
            ops, self._budget_ops = self._budget_ops, []
        budget = self._shared_budget
        if budget is None:
            return
        for op, size in ops:
            if op == "charge":
                budget.charge(self._budget_key, size,
                              self.program_nbytes(size))
            elif op == "touch":
                budget.touch(self._budget_key, size)
            else:
                budget.forget(self._budget_key, size)

    def _run_program(self, prog: _Program,
                     x_host: torch.Tensor) -> torch.Tensor:
        with self._lock:
            if self._programs.get(prog.size) is not prog:
                prog = self._resident(prog.size)  # dropped meanwhile
            if self.host_only:
                return torch.from_numpy(
                    self._oracle_forward(x_host.float().numpy()))
            prog.buf.copy_(x_host, non_blocking=True)
            if not self.graphed:
                return self.forward_padded(prog.buf)
            if prog.graph is None:
                return self._capture(prog)
            return self._replay(prog)

    def _graph_pool(self):
        """The memory pool every bucket's graph shares (made on this
        model's device: called under its guard)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture(self, prog: _Program) -> torch.Tensor:
        """The chain at ``prog``'s bucket eagerly on this model's side
        stream (the warm-up, whose output is this dispatch's reply), then
        captured on that stream into the bucket's graph over the resident
        input buffer, with the collector off (a graph it destroyed
        mid-capture would invalidate the capture) and in thread-local
        mode (another thread staging a swap's weights meanwhile is no
        part of it).  All of it under the model's device guard, the
        stream given to ``torch.cuda.graph``: its default capture stream
        is made once for the process, on whatever device was current,
        and a replica on another card would capture on it (C24)."""
        dev = self.device
        name = self.manifest.get("workflow", "model")
        with _device_guard(dev):
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            side = self._side
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = self.forward_padded(prog.buf)
            torch.cuda.current_stream(dev).wait_stream(side)
            if warm.is_cuda:
                warm.record_stream(torch.cuda.current_stream(dev))
            before = launch_counts.snapshot()
            graph = torch.cuda.CUDAGraph()
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _tracing.TRACER.span(f"capture:{name}:b{prog.size}",
                                          cat="capture"):
                    with torch.cuda.graph(graph, pool=self._graph_pool(),
                                          stream=side,
                                          capture_error_mode="thread_local"):
                        out = self.forward_padded(prog.buf)
                launches = launch_counts.delta(before)
            except Exception as exc:
                raise RuntimeError(
                    f"'{name}': the CUDA-graph capture of bucket "
                    f"{prog.size} failed: {exc}") from exc
            finally:
                if collecting:
                    gc.enable()
                launch_counts.restore(before)  # the capture launched nothing
        prog.graph, prog.out, prog.launches = graph, out, launches
        prog.fixed = [(key, t.data_ptr()) for key, t in self._bound_tensors()]
        _metrics.graph_captures(f"serving:{name}").inc()
        self.debug("captured bucket %d", prog.size)
        return warm

    def _replay(self, prog: _Program) -> torch.Tensor:
        for (key, ptr), (_, tensor) in zip(prog.fixed,
                                           self._bound_tensors()):
            if tensor.data_ptr() != ptr:
                raise RuntimeError(
                    f"bucket {prog.size}: parameter {key} was rebound "
                    f"after the capture, whose graph reads the tensor it "
                    f"held then; write it in place (copy_) instead")
        with _device_guard(self.device):
            prog.graph.replay()
        launch_counts.add(prog.launches)
        return prog.out

    def warmup(self, max_batch: int | None = None) -> int:
        """Make every ladder bucket up to ``max_batch`` (default: this
        model's cap) resident and run it once on zeros (on the card:
        capture its graph), so serve time pays no first-launch cost and
        no capture.  Returns the number of programs made resident."""
        if max_batch is not None:
            self.max_batch = max(self.max_batch, int(max_batch))
        before = self.programs_built
        for size in ladder(max_batch or self.max_batch):
            with self._lock:
                self.program_for(size)(torch.zeros(
                    (size,) + self.input_shape, dtype=self.serve_dtype))
            self.settle_budget()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.programs_built - before

    # ------------------------------------------------------------------
    # weight hot-swap
    # ------------------------------------------------------------------
    def check_compatible(self, manifest: dict | None,
                         params: dict) -> list[tuple[str, object, str]]:
        """Validate a candidate against the chain the programs were
        captured for; raises :class:`SwapIncompatible` (incumbent
        untouched) on any mismatch.  Returns the ``(key, unit, attr)``
        parameters the swap replaces."""
        if manifest is not None:
            mine = [layer["type"] for layer in self.manifest["layers"]]
            theirs = [layer["type"] for layer in
                      manifest.get("layers", [])]
            if mine != theirs:
                raise SwapIncompatible(
                    f"candidate layer table {theirs} != serving chain "
                    f"{mine}")
            if tuple(manifest.get("input_shape", self.input_shape)) \
                    != self.input_shape:
                raise SwapIncompatible(
                    f"candidate input shape "
                    f"{tuple(manifest['input_shape'])} != exported "
                    f"{self.input_shape}")
            cand = manifest.get("dtype", "float32")
            if torch_dtype(cand) != self.dtype:
                raise SwapIncompatible(
                    f"candidate dtype {cand} != trained "
                    f"{self.manifest.get('dtype', 'float32')} — the "
                    f"programs are pinned to the trained precision mode")
        for key, unit, attr in self._pairs:
            arr = params.get(key)
            if arr is None:
                raise SwapIncompatible(
                    f"candidate is missing parameter '{key}'")
            shape = tuple(getattr(unit, attr).shape)
            if tuple(np.shape(arr)) != shape:
                raise SwapIncompatible(
                    f"{key}: candidate shape {tuple(np.shape(arr))} != "
                    f"served {shape}")
        return self._pairs

    def stage_weights(self, params: dict,
                      manifest: dict | None = None) -> _Staged:
        """The first two phases of a swap: validate ``params`` (and
        ``manifest``) against the chain, then upload the new weights to
        the serving device on a side stream and wait for them — off the
        dispatch path, touching nothing a program reads.  An int8 chain
        takes only an int8 candidate quantizing the same keys; an int8
        candidate into an f32 chain stages its dequantized f32 values."""
        t0 = time.perf_counter()
        cand_rec = _quantize.is_quantized(manifest)
        if self._qkeys:
            if cand_rec is None:
                raise SwapIncompatible(
                    "candidate is f32 but the serving chain dequantizes "
                    "int8 weights on load — republish the candidate "
                    "with quantize='int8'")
            if set(cand_rec.get("weights", [])) != set(self._qkeys):
                raise SwapIncompatible(
                    f"candidate quantizes "
                    f"{sorted(cand_rec.get('weights', []))} != served "
                    f"{sorted(self._qkeys)}")
            dq = _quantize.dequantize_params(manifest, params)
        elif cand_rec is not None:
            params = dq = _quantize.dequantize_params(manifest, params)
            cand_rec = None
        else:
            dq = params
        pairs = self.check_compatible(manifest, dq)
        dev = self.device
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        tensors, host = [], {}
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            for key, _unit, _attr in pairs:
                if key in self._qkeys and cand_rec is not None \
                        and not self.host_only:
                    sk = _quantize.scale_key(key)
                    q = np.ascontiguousarray(np.asarray(params[key],
                                                        np.int8))
                    s = np.ascontiguousarray(np.asarray(params[sk],
                                                        np.float32))
                    tensors.append((key, (torch.from_numpy(q).to(dev),
                                          torch.from_numpy(s).to(dev))))
                    host[key], host[sk] = q.copy(), s.copy()
                    continue
                new = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(dq[key], dtype=np.float32)))
                if key in self._qkeys:
                    # the oracle of an int8 chain holds the dequantized
                    # weight rounded to the manifest dtype
                    new = new.to(self.dtype).float()
                    sk = _quantize.scale_key(key)
                    host[key] = np.asarray(params[key], np.int8).copy()
                    host[sk] = np.asarray(params[sk], np.float32).copy()
                else:
                    host[key] = new.numpy().copy()
                tensors.append((key, new.to(dev)))
        if cuda:
            side.synchronize()
        return _Staged(tensors, host, time.perf_counter() - t0)

    def publish(self, staged: _Staged) -> float:
        """The third phase: the staged weights copied in place into the
        tensors the programs read, between two dispatches (under
        :attr:`_lock`, on the calling thread's current stream, waited
        for), then the host-side bundle dict.  Returns the pause in
        seconds."""
        by_key = {key: (unit, attr) for key, unit, attr in self._pairs}
        with self._lock:
            t0 = time.perf_counter()
            with torch.no_grad():
                for key, new in staged.tensors:
                    if key in self._qtensors:
                        q, s = self._qtensors[key]
                        q.copy_(new[0])
                        s.copy_(new[1])
                    else:
                        unit, attr = by_key[key]
                        getattr(unit, attr).copy_(new)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            pause = time.perf_counter() - t0
            self._params.update(staged.host)
            self.weights_version += 1
        return pause

    def swap_weights(self, params: dict,
                     manifest: dict | None = None) -> int:
        """Replace the trained parameters of a live model with no new
        capture: :meth:`stage_weights`, then :meth:`publish`.  ``params``
        maps the export keys (``layer<i>_<attr>``) to host arrays (a
        published bundle's array dict).  Returns the new
        :attr:`weights_version`."""
        self.publish(self.stage_weights(params, manifest))
        return self.weights_version

    # ------------------------------------------------------------------
    def _as_input(self, x) -> torch.Tensor:
        """A host batch rounded to :attr:`serve_dtype`, shape-checked."""
        t = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(
            self.serve_dtype)
        if tuple(t.shape[1:]) != self.input_shape:
            raise ValueError(f"input sample shape {tuple(t.shape[1:])} "
                             f"!= exported {self.input_shape}")
        return t.contiguous()

    def __call__(self, x) -> np.ndarray:
        x = self._as_input(x)
        batch = x.shape[0]
        if self.host_only:
            with self._lock:
                return self._oracle_forward(x.numpy())
        size = bucket_for(batch)
        if size != batch:
            # padded rows compute on zeros and are sliced off
            padded = torch.zeros((size,) + self.input_shape,
                                 dtype=x.dtype)
            padded[:batch] = x
            x = padded
        with self._lock:
            out = self.program_for(size)(x)
            reply = out[:batch].float().cpu().numpy()
        self.settle_budget()
        return reply

    def predict_classes(self, x) -> np.ndarray:
        return np.argmax(self(x), axis=1)
