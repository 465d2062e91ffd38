"""Forward and gradient-descent unit bases (counterpart of
``znicz_tpu/ops/nn_units.py`` and the precision rules of
``znicz_tpu/accelerated_units.py``).

A forward unit here is both an
:class:`~znicz_tpu_torch.accelerated_units.AcceleratedUnit` (a node of
the workflow's graph, with the reference's attribute names: ``input``,
``output``, ``weights``, ``bias``; a backward unit's ``err_output`` and
``err_input``) and an ``nn.Module`` over a batch of samples of one
input shape, in one compute dtype.  A unit built by a workflow learns
its input shape and dtype at ``initialize`` (from the unit its
``input`` is linked to, deferring until that one is initialized, as the
reference's units do); one built with them runs on its own, called as
a module (``unit(x)``, ``gd.run(x, err, y)``).  Any of the named
attributes is reachable as a :class:`~znicz_tpu_torch.memory.Vector`
through :meth:`AcceleratedUnit.vector` (the same storage).  Its
parameters carry the bundle's
names (``weights``, ``bias``, …) and stay float32 in every precision
mode, as in the reference.  They come either from a bundle
(:meth:`Forward.load_params`) or from the reference's initial fills
(:meth:`Forward.init_params`, drawn from :mod:`znicz_tpu_torch.utils.prng`
in the reference's order, so one seed gives the same weights in both
packages).

Two precision rules carry over from the reference's XLA path:

- :meth:`AcceleratedUnit.mxu_dot` — in bf16 mode the product's operands are
  rounded to bf16 and the result is f32 (the reference's ``jnp.dot``
  with ``preferred_element_type=float32``).  Here that is an f32
  product of bf16-rounded operands; with TF32 off
  (:mod:`znicz_tpu_torch.backends`) it is exact up to summation order.
  Autograd through it rounds the cotangent of each operand to bf16,
  where ``jax.vjp`` of the reference's ``mxu_dot`` does.
- :attr:`AcceleratedUnit.act_store_dtype` — activations and errors between
  layers are stored in bf16 in bf16 mode and in f32 otherwise, or with
  ``root.common.engine.bf16_activations = False``.

:class:`GradientDescentBase` is the reference's update rule, cut to what
the training paths run (learning rates, L1/L2 decay, momentum,
gradient-norm clipping), microbatch gradient accumulation
(``root.common.engine.grad_accum``, :meth:`GradientDescentBase.apply_param`)
and, on a device with a mesh, the data-parallel fold: each process's
gradient (of its rows, already divided by the global batch) is summed
over the data axis where the reference calls ``maybe_pmean``, and with
ZeRO-1 (``root.common.engine.zero1``, on by default for a data axis of
2 or more) reduce-scattered instead, each process updating its slice
of the parameter and of its momentum, which it stores sharded and
zero-padded, then all-gathering the parameter.  With the anomaly guard
linked (``StandardWorkflow``'s default) every update is guarded as in
the reference: ``ok = running flag AND isfinite(Σ g²)`` of the tensor's
logical gradient, a skipped tensor keeping its parameter and momentum
bit for bit, and each tensor's SDC fingerprints folded into the guard's
vector (:meth:`GradientDescentBase.apply_param`).  Momentum is stored in bf16
in bf16 mode with its math in f32, as in the reference, unless
``root.common.engine.bf16_optimizer_state = False``; with
``root.common.engine.bf16_grad_comms`` on (off by default), ZeRO-1
reduce-scatters each weight gradient in bf16 and updates the upcast
shard.  With
``engine.fp8_matmul`` on, each parameter's gradient takes a round-trip
through e4m3 after the accumulation mean and before the update, as in
the reference.

On the numpy oracle (:class:`~znicz_tpu_torch.backends.NumpyDevice`) a
forward's :meth:`Forward.numpy_run` is ``output = numpy_forward(input)``
and a backward's :meth:`GradientDescentBase.numpy_run` is
``err_input = numpy_backprop(x, err_output, y)`` with the update of
:meth:`GradientDescentBase.numpy_apply_param` (the reference's
``_apply_weights_np``/``_apply_bias_np``): numpy arrays between units,
and the parameters and momentum updated in place through
``Tensor.numpy()`` views, so a snapshot reads them as on any device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products
from znicz_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               current_accum_phase,
                                               precision_dtypes)
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.ops.fp8 import fp8_enabled, fp8_round_trip
from znicz_tpu_torch.ops.fused_kernels import BlockMap, block_shape
from znicz_tpu_torch.parallel import partition
from znicz_tpu_torch.parallel.axis import (DATA_AXIS, MODEL_AXIS,
                                           all_gather_flat, all_reduce,
                                           maybe_psum, reduce_scatter_flat)
from znicz_tpu_torch.resilience import integrity as _integrity
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.prng import SeedChain

#: microbatches a weighted backward unit accumulates a step for
#: (``StandardWorkflow.run_accumulated``); 1: fused batches
register_defaults("common", {"engine": {"grad_accum": 1}})

__all__ = ["Forward", "GradientDescentBase", "Stochastic",
           "WeightlessGradientUnit", "as_numpy", "gd_for", "stored_f32",
           "to_host"]


def as_numpy(value) -> np.ndarray | None:
    """An oracle operand as a numpy array: an array as it is, a CPU
    tensor as a view of its storage (no copy, no torch operation)."""
    if value is None or isinstance(value, np.ndarray):
        return value
    return value.detach().numpy()


def to_host(value) -> np.ndarray | None:
    """A value read back to the host as numpy: a Vector mapped for
    reading, a tensor on any device copied (bf16 as f32), an array as it
    is; None for None."""
    if isinstance(value, Vector):
        value.map_read()
        return np.asarray(value.mem)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return None if value is None else np.asarray(value)


def stored_f32(value: np.ndarray | None) -> np.ndarray | None:
    """An oracle result as the reference stores it: in an f32 array
    (its numpy math promotes to f64 in places, e.g. through
    ``np.sqrt`` of an integer)."""
    if value is None:
        return None
    return np.asarray(value, dtype=np.float32)


class ModuleUnit(AcceleratedUnit, nn.Module):
    """An accelerated unit that is an ``nn.Module``: its snapshot state
    is its own parameters and buffers (f32 host copies), and a snapshot
    that lacks one raises.  Called with ``nn.Module``'s arguments
    (``destination``, ``prefix``, ``keep_vars``), :meth:`state_dict` is
    ``nn.Module``'s, so a module tree holding the unit keeps working.

    A tensor that this process holds only a shard of (a model-axis
    parameter, a ZeRO-1 momentum) has its placement in
    :attr:`placements`; the snapshot holds the logical tensor, gathered
    from the shards (a collective, so the caller must allow one), and a
    load cuts this process's shard from it, so a snapshot resumes on
    any layout."""

    def place(self, name: str, placement, logical_shape) -> None:
        """Resolve the placement of the tensor ``name`` through the
        workflow's partition table (or directly, with
        ``engine.partition_rules`` off) and keep it in
        :attr:`placements`."""
        resolved = partition.declare(self, None, placement, slot=name,
                                     logical_shape=logical_shape)
        table = partition.table_for(self.workflow)
        if table is not None:
            table.leaves[resolved.path] = resolved
            table._publish()
        self.placements[name] = resolved

    @property
    def placements(self) -> dict:
        """Tensor name → its resolved placement, for the tensors this
        process holds a shard of."""
        return self.__dict__.setdefault("_placements", {})

    def _sharded(self, name: str):
        mesh = None if self.device is None else self.device.mesh
        resolved = self.placements.get(name)
        return resolved if partition.is_sharded(resolved, mesh) else None

    def full_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The logical value of own tensor ``name`` (``t``): gathered from
        the shards where this process holds one (a collective)."""
        resolved = self._sharded(name)
        if resolved is None:
            return t
        return partition.gather_full(t.detach(), resolved, self.device.mesh)

    def state_dict(self, *args, allow_collective: bool = False, **kwargs):
        if args or kwargs:
            return nn.Module.state_dict(self, *args, **kwargs)
        out = {}
        for name, t in self.own_tensors():
            if self._sharded(name) is not None and not allow_collective:
                raise RuntimeError(
                    f"{self.name}.{name} is sharded over processes: its "
                    f"snapshot gathers it, a collective every process "
                    f"must join (state_dict(allow_collective=True))")
            out[name] = self.full_tensor(name, t).detach().to(
                "cpu", torch.float32, copy=True).numpy()
        return out

    def own_tensors(self) -> list[tuple[str, torch.Tensor]]:
        return [*self.named_parameters(recurse=False),
                *self.named_buffers(recurse=False)]

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Each parameter and buffer from ``state`` (f32 or bf16 numpy,
        rounded to the tensor's dtype, written in place; a sharded one
        cut to this process's shard first)."""
        for name, t in self.own_tensors():
            if name not in state:
                raise KeyError(f"state has no '{self.name}.{name}'")
            value = torch.from_numpy(np.asarray(state[name]).astype(
                np.float32))
            resolved = self._sharded(name)
            if resolved is not None:
                if tuple(value.shape) != tuple(resolved.logical_shape):
                    raise ValueError(
                        f"{self.name}.{name}: state shape "
                        f"{tuple(value.shape)} != "
                        f"{tuple(resolved.logical_shape)}")
                value = partition.local_slice(value, resolved,
                                              self.device.mesh)
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{self.name}.{name}: state shape "
                                 f"{tuple(value.shape)} != {tuple(t.shape)}")
            t.copy_(value)


class Forward(ModuleUnit):
    """Base forward unit over a batch of samples of ``input_shape``."""

    WRITES = ("output",)
    #: parameter attributes an exported bundle carries for this unit
    EXPORT_PARAMS: tuple = ("weights", "bias")
    #: manifest config keys that only shape the random initial fill
    INIT_ONLY = frozenset(("weights_filling", "weights_stddev",
                           "bias_filling", "bias_stddev"))
    #: the initial weight fill when the config names none
    WEIGHTS_FILLING = "uniform"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, include_bias: bool = True, *,
                 workflow=None, name: str | None = None,
                 **init_config) -> None:
        unknown = set(init_config) - self.INIT_ONLY
        if unknown:
            raise TypeError(f"{type(self).__name__}: unsupported config "
                            f"{sorted(unknown)}")
        super().__init__(workflow, name=name)
        self.input_shape = (None if input_shape is None
                            else tuple(int(n) for n in input_shape))
        self.compute_dtype = compute_dtype or torch.float32
        self.include_bias = bool(include_bias)
        self.weights_filling = init_config.get("weights_filling",
                                               self.WEIGHTS_FILLING)
        self.weights_stddev = init_config.get("weights_stddev")
        self.bias_filling = init_config.get("bias_filling", "uniform")
        self.bias_stddev = init_config.get("bias_stddev")

    #: True when the output is this process's block of the features
    #: (a column-parallel layer's), which the stochastic units' maps read
    output_feature_block = False

    def check_input_shape(self) -> None:
        """Raise when :attr:`input_shape` does not suit the unit (called
        once the shape is known)."""

    # -- the unit ---------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Learn the input shape from the unit ``input`` is linked to (a
        forward's ``output_shape``, the loader's ``sample_shape``; the
        AttributeError of one not yet initialized defers this unit), the
        dtype from the device, then fill the parameters."""
        super().initialize(device=device, **kwargs)
        link = self._linked_attrs.get("input")
        if link is not None:
            source = link.source
            if not source.is_initialized:
                raise AttributeError(f"{self}: input source {source} not "
                                     f"initialized yet")
            self.input_shape = tuple(
                source.output_shape if isinstance(source, Forward)
                else source.sample_shape)
        self.compute_dtype = self.device.compute_dtype
        self.check_input_shape()
        self.init_params(self.torch_device)

    def device_run(self) -> None:
        self.output = self(self.input)

    def numpy_run(self) -> None:
        self.output = stored_f32(self.numpy_forward(as_numpy(self.input)))

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        """The oracle's forward of a batch (numpy only)."""
        raise NotImplementedError(f"{type(self).__name__}.numpy_forward")

    def np_param(self, name: str) -> np.ndarray | None:
        """A parameter as a numpy view (writes reach the tensor)."""
        return as_numpy(getattr(self, name, None))

    # -- geometry and parameters ------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Shape of every parameter this unit needs, by attribute."""
        raise NotImplementedError

    @property
    def output_shape(self) -> tuple:
        """Per-sample output shape."""
        return self.input_shape

    def load_params(self, arrays: dict[str, torch.Tensor]) -> None:
        """Adopt a parameter set (``attr → tensor``) as float32 copies.
        A missing or mis-shaped parameter raises: serving a random or
        truncated substitute would be silently wrong."""
        for attr, shape in self.param_shapes().items():
            value = arrays.get(attr)
            if value is None:
                raise ValueError(f"{type(self).__name__}: parameter "
                                 f"'{attr}' missing from the bundle")
            if tuple(value.shape) != tuple(shape):
                raise ValueError(
                    f"{type(self).__name__} {attr}: bundle shape "
                    f"{tuple(value.shape)} != expected {tuple(shape)}")
            setattr(self, attr, nn.Parameter(
                value.detach().to(torch.float32).clone(),
                requires_grad=False))

    def fill_array(self, shape, filling: str, stddev: float | None,
                   fan_in: int) -> np.ndarray:
        """One initial fill from the default generator (the reference's
        ``Forward.fill_array``, copied)."""
        gen = prng.get()
        if stddev is None:
            stddev = 1.0 / max(1.0, np.sqrt(fan_in))
        if filling == "uniform":
            return gen.fill_uniform(shape, -stddev, stddev,
                                    dtype=np.float32)
        if filling == "gaussian":
            return gen.fill_normal(shape, 0.0, stddev, dtype=np.float32)
        if filling == "constant":
            return np.full(shape, stddev, dtype=np.float32)
        if filling == "he":
            return gen.fill_normal(shape, 0.0,
                                   float(np.sqrt(2.0 / max(1, fan_in))),
                                   dtype=np.float32)
        if filling == "xavier":
            return gen.fill_normal(shape, 0.0,
                                   float(np.sqrt(1.0 / max(1, fan_in))),
                                   dtype=np.float32)
        raise ValueError(f"unknown filling '{filling}'")

    def initial_params(self) -> dict[str, np.ndarray]:
        """The unit's initial parameters, drawn in the order the
        reference's ``initialize`` draws them."""
        raise NotImplementedError

    def init_params(self, device) -> None:
        """Fill the parameters as the reference does and place them on
        ``device``."""
        self.load_params({k: torch.from_numpy(v)
                          for k, v in self.initial_params().items()})
        self.to(device)

    @property
    def output_store_dtype(self) -> torch.dtype:
        return self.act_store_dtype


def block_map(device, x: torch.Tensor, columns: bool = False
              ) -> BlockMap | None:
    """Where ``x``, this process's part of a batch-major tensor, lies in
    the global tensor read as ``(rows, features)``
    (:func:`~znicz_tpu_torch.ops.fused_kernels.block_shape`), or None
    when it is the whole.  Its rows are block :attr:`~znicz_tpu_torch.
    backends.Device.data_rank` of the data axis; with ``columns`` (the
    output of a column-parallel layer) its features are block
    ``model``-rank of the model axis.  The other axes leave a unit's
    input whole (the ring gathers time at the attention's output).  The
    map is a constant of the process, so a captured graph keeps it."""
    mesh = None if device is None else device.mesh
    if mesh is None:
        return None
    rows, cols = block_shape(x)
    row0 = device.data_rank * rows
    n_model = mesh.size(MODEL_AXIS)
    col0, c_glob = 0, cols
    if columns and n_model > 1:
        col0, c_glob = mesh.index(MODEL_AXIS) * cols, cols * n_model
    if not (row0 or col0) and c_glob == cols:
        return None
    return BlockMap(row0, col0, c_glob)


class Stochastic:
    """Mixin of a forward that draws a seed a train step (dropout,
    stochastic pooling, the RBM's sampling) from its :class:`SeedChain`:
    a seed on the device that the step advances, rooted in one draw from
    the default generator.  ``forward_mode`` is part of the region key;
    the chain's next seed is part of the snapshot (``seed_chain``).

    On a mesh each process draws its part of the one draw of the global
    tensor (:meth:`block_map`): the element's index in the global tensor
    picks its bits.  Every process roots its chain in the same draw, as
    every process seeds the default generator alike and makes the same
    draws from it in the same order (the loader's shuffle seed, the
    weight fills, the chains' roots), so the seeds agree."""

    def init_stochastic(self) -> None:
        self.forward_mode = "train"
        #: this step's seed, a 0-d int64 tensor (None in eval mode)
        self.seed = None
        self.__dict__["seed_chain"] = SeedChain()

    def next_seed(self, device):
        """This train step's seed (the chain advanced on the device)."""
        self.seed = self.seed_chain.next(device)
        return self.seed

    def region_key(self) -> tuple:
        return (self.forward_mode,)

    @property
    def output_feature_block(self) -> bool:
        """True when the output is this process's block of the features
        (an elementwise draw keeps its input's placement)."""
        link = self._linked_attrs.get("input")
        return link is not None and bool(
            getattr(link.source, "output_feature_block", False))

    def block_map(self, x: torch.Tensor) -> BlockMap | None:
        """The map of ``x``, this step's input (:func:`block_map`)."""
        return block_map(self.device, x, self.output_feature_block)

    def sync_host_state(self) -> None:
        if self.forward_mode == "train":
            self.seed_chain.sync(self.torch_device)

    def state_dict(self, *args, allow_collective: bool = False, **kwargs):
        out = super().state_dict(*args, **kwargs)
        if args or kwargs:
            return out
        value = self.seed_chain.get_value()
        if value is not None:
            out["seed_chain"] = value
        return out

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if "seed_chain" in state:
            self.seed_chain.set_value(int(state["seed_chain"]))


#: forward class → its backward class, filled from each backward
#: class's ``MATCHES`` (the reference's ``MatchingObject`` registry)
_GD_FOR_FORWARD: dict[type, type] = {}


def gd_for(forward_cls: type) -> type:
    """The backward class paired with ``forward_cls`` (walks the MRO, so
    a subclass inherits its parent's pairing unless it has its own)."""
    for klass in forward_cls.__mro__:
        gd = _GD_FOR_FORWARD.get(klass)
        if gd is not None:
            return gd
    raise KeyError(f"no gradient unit registered for {forward_cls.__name__}")


class GradientDescentBase(ModuleUnit):
    """Base backward unit: the reference's update rule for each
    parameter tensor of its forward unit.

    .. code-block:: text

        ĝ   = dL/dW · min(1, gradient_clip / ‖dL/dW‖₂)      (clip > 0)
        g   = ĝ + weights_decay·((1−l1_vs_l2)·W + ½·l1_vs_l2·sign(W))
        acc = gradient_moment·acc − learning_rate·g
        W  += acc

    A subclass's :meth:`backprop` computes ``err_input`` (when the
    previous unit wants it) and its parameter gradients from the weights
    as they were before this step, then updates the parameters in place
    through :meth:`apply_param`.  As a unit it reads ``input``,
    ``output`` and ``err_output`` and writes ``err_input``; called with
    tensors, :meth:`run` returns the error instead.
    """

    #: forward classes this backward unit belongs to
    MATCHES: tuple = ()
    NEEDS_AUTOGRAD = True
    WRITES = ("err_input",)

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        for fwd_cls in cls.__dict__.get("MATCHES", ()):
            _GD_FOR_FORWARD[fwd_cls] = cls

    def __init__(self, forward_unit: Forward, learning_rate: float = 0.01,
                 learning_rate_bias: float | None = None,
                 weights_decay: float = 0.0,
                 weights_decay_bias: float = 0.0,
                 l1_vs_l2: float = 0.0,
                 gradient_moment: float = 0.0,
                 gradient_moment_bias: float | None = None,
                 gradient_clip: float = 0.0,
                 need_err_input: bool = True, *, workflow=None,
                 name: str | None = None) -> None:
        super().__init__(workflow, name=name)
        # a plain attribute, not a submodule: the forward owns its
        # parameters
        self.__dict__["forward_unit"] = forward_unit
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate if learning_rate_bias is None
                                   else learning_rate_bias)
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = (gradient_moment
                                     if gradient_moment_bias is None
                                     else gradient_moment_bias)
        self.gradient_clip = gradient_clip
        self.need_err_input = need_err_input
        self.err_input: torch.Tensor | None = None
        #: ``[lr, lr_bias]`` on the device (f32), None until a
        #: learning-rate schedule claims it (:meth:`claim_lr_state`); the
        #: update then reads the rates from it, so a captured step takes
        #: the rate the schedule wrote before each replay
        self.register_buffer("lr_state", None)
        #: the anomaly guard's tensors (linked by ``StandardWorkflow``):
        #: ``anomaly_flag`` its ``step_flags``, ``sdc_fingerprint`` the
        #: f32[5] the folds go into, ``sdc_inject`` the drill leaf; None
        #: (a unit on its own) is the unguarded update
        self.anomaly_flag = None
        self.sdc_fingerprint = None
        self.sdc_inject = None
        #: ``<forward>.<attribute>`` → (forward, attribute) of every
        #: parameter the fingerprint folds, in fold order (the host
        #: recompute and the shadow audit read the same set)
        self.__dict__["_fp_folded"] = {}
        if forward_unit.input_shape is not None:
            self.bind_forward()

    def bind_forward(self) -> None:
        """Allocate what the forward's parameters decide: the momentum
        buffers (zero), the microbatch accumulation buffers, and whatever
        a subclass keeps beside them."""
        self.alloc_accumulator("accumulated_gradient_weights", "weights",
                               self.gradient_moment)
        self.alloc_accumulator("accumulated_gradient_bias", "bias",
                               self.gradient_moment_bias)
        self.alloc_micro_accum()

    def micro_accum_params(self) -> list[tuple[str, str]]:
        """``(suffix, parameter attribute)`` pairs that microbatch
        accumulation covers; a unit with more parameter pairs
        (attention's output projection) extends this."""
        return [("w", "weights"), ("b", "bias")]

    def alloc_micro_accum(self) -> None:
        """With ``root.common.engine.grad_accum`` > 1: one f32 zero
        buffer ``micro_accum_<suffix>`` a parameter (the reference's
        names), which :meth:`apply_param` finds by the parameter.  A
        weightless unit has none."""
        #: id(parameter) → its microbatch gradient sum
        self.__dict__["_micro_accum"] = {}
        if int(root.common.engine.get("grad_accum", 1) or 1) < 2:
            return
        fwd = self.forward_unit
        if getattr(fwd, "weights", None) is None:
            return
        for suffix, attr in self.micro_accum_params():
            param = getattr(fwd, attr, None)
            if param is None:
                continue
            buf = torch.zeros(param.shape, dtype=torch.float32,
                              device=param.device)
            self.register_buffer(f"micro_accum_{suffix}", buf)
            self._micro_accum[id(param)] = buf
            self.place_as_forward(f"micro_accum_{suffix}", attr)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        if not self.forward_unit.is_initialized:
            raise AttributeError(f"{self}: forward {self.forward_unit} not "
                                 f"initialized yet")
        self.compute_dtype = self.forward_unit.compute_dtype
        self.bind_forward()
        #: ZeRO-1 reduce-scatters the weight gradients in bf16
        #: (``engine.bf16_grad_comms``, off by default, as in the
        #: reference): half the bytes, the shard's math on the upcast
        self._grad_comms_bf16 = bool(self.__dict__.get("_zero1")) and bool(
            root.common.engine.get("bf16_grad_comms", False))

    @torch.no_grad()
    def claim_lr_state(self) -> None:
        """Give the unit its ``lr_state`` (once), holding
        ``[learning_rate, learning_rate_bias]`` on the forward's
        device."""
        if self.lr_state is None:
            self.lr_state = torch.tensor(
                [self.learning_rate, self.learning_rate_bias],
                dtype=torch.float32,
                device=self.forward_unit.weights.device)

    @torch.no_grad()
    def write_lr_state(self, lr: float, lr_bias: float) -> None:
        """Both rates into ``lr_state`` in place, as f32 (the tensor a
        captured step reads keeps its address).  Each slot is a fill
        whose value travels with its launch: no host buffer, no sync."""
        self.lr_state[0] = lr
        self.lr_state[1] = lr_bias

    def _lr(self):
        """The weights' rate: a 0-d device tensor when a schedule holds
        ``lr_state``, else the float."""
        return self.learning_rate if self.lr_state is None \
            else self.lr_state[0]

    def _lr_bias(self):
        return self.learning_rate_bias if self.lr_state is None \
            else self.lr_state[1]

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """As :meth:`ModuleUnit.load_state`, but ``lr_state`` may be
        missing (its schedule writes it again from its own iteration
        count, ``LearningRateAdjust.load_state``), and so may the
        microbatch sums (zero then)."""
        if self.lr_state is not None and "lr_state" not in state:
            state = {**state, "lr_state": self.lr_state.cpu().numpy()}
        # a state taken between optimizer steps holds zero sums; one
        # written without accumulation has none
        state = {**{name: np.zeros(tuple(t.shape), np.float32)
                    for name, t in self.named_buffers(recurse=False)
                    if name.startswith("micro_accum_")}, **state}
        super().load_state(state)

    @property
    def opt_state_dtype(self) -> torch.dtype:
        """Storage dtype of the momentum accumulators: bf16 in bf16
        mode (the math stays f32), else f32.  Opt out:
        ``root.common.engine.bf16_optimizer_state = False`` keeps them
        f32 in bf16 mode, as the reference's."""
        store = precision_dtypes(self.forward_unit.compute_dtype)[1]
        if store == torch.bfloat16 and not bool(
                root.common.engine.get("bf16_optimizer_state", True)):
            return torch.float32
        return store

    @property
    def act_store_dtype(self) -> torch.dtype:
        return self.forward_unit.act_store_dtype

    def alloc_accumulator(self, name: str, param: str,
                          moment: float) -> None:
        """A zero momentum buffer ``name`` for the forward's ``param``
        (None when the parameter or the moment is absent).  With ZeRO-1
        (:meth:`zero1_plan`) the buffer is this process's slice of the
        zero-padded momentum."""
        value = getattr(self.forward_unit, param, None)
        shape = None if value is None else tuple(value.shape)
        plan = self.zero1_plan(param, name if moment else None)
        if plan is not None and shape is not None:
            dim, pad = plan.data_shard_dim, plan.data_shard_pad
            shape = list(shape)
            shape[dim] = (shape[dim] + pad) // self.device.n_data_shards
        elif moment and value is not None:
            self.place_as_forward(name, param)
        self.register_buffer(name, torch.zeros(
            shape, dtype=self.opt_state_dtype, device=value.device)
            if moment and value is not None else None)

    def place_as_forward(self, name: str, param: str) -> None:
        """Place buffer ``name`` as the forward's ``param`` when that is
        a tensor-parallel block (the buffer is then the same block of the
        logical buffer): a snapshot gathers it whole and a load cuts this
        process's block, as for the parameter (C25)."""
        fwd = self.forward_unit
        tp = fwd.placements.get(param) if isinstance(fwd, ModuleUnit) \
            else None
        if tp is None or tp.model_shard_dim is None:
            self.placements.pop(name, None)
            return
        # this unit's own record (not a leaf of the workflow's table,
        # which lists the parameters and ZeRO-1's shards)
        self.placements[name] = partition.materialize(
            partition.model_sharded(tp.model_shard_dim, tp.model_shard_axis),
            f"{self.name}/{name}", tuple(tp.logical_shape), 1)

    def zero1_plan(self, param: str, acc: str | None = None):
        """The ZeRO-1 placement of the forward's ``param`` (its
        momentum ``acc``'s leaf, when it has one), or None when the
        update stays replicated: no mesh, a data axis of 1,
        ``engine.zero1`` off, or nothing to shard."""
        from znicz_tpu_torch.parallel.mesh import zero1_choice
        plans = self.__dict__.setdefault("_zero1", {})
        plans.pop(param, None)
        value = getattr(self.forward_unit, param, None)
        if value is None or not zero1_choice(self.device):
            return None
        fwd = self.forward_unit
        tp = fwd.placements.get(param) if isinstance(fwd, ModuleUnit) \
            else None
        model_dim = None if tp is None else tp.model_shard_dim
        logical = list(value.shape)
        if model_dim is not None:
            logical[model_dim] *= self.device.axis_size(
                tp.model_shard_axis)
        placement = partition.Zero1(model_dim=model_dim)
        if acc is not None:
            self.place(acc, placement, tuple(logical))
            plan = self.placements[acc]
        else:
            plan = partition.materialize(
                placement, f"{self.name}/{param}", tuple(logical),
                self.device.n_data_shards)
        if plan.data_shard_dim is None:
            return None
        plans[param] = plan
        return plan

    def run(self, x: torch.Tensor | None = None,
            err_output: torch.Tensor | None = None,
            y: torch.Tensor | None = None) -> torch.Tensor | None:
        """With no tensors: one firing of the unit.  With them: one
        backward step from the forward's input ``x``, the error at its
        output and the forward's output ``y`` of this step, returning
        ``err_input`` (see :meth:`backprop`)."""
        if x is None and err_output is None:
            return super().run()
        return self.backprop(x, err_output, y)

    def device_run(self) -> None:
        self.err_input = self.backprop(self.input, self.err_output,
                                       self.output)

    def numpy_run(self) -> None:
        self.err_input = stored_f32(self.numpy_backprop(
            as_numpy(self.input), as_numpy(self.err_output),
            as_numpy(self.output)))

    def numpy_backprop(self, x: np.ndarray, err_output: np.ndarray,
                       y: np.ndarray | None = None) -> np.ndarray | None:
        """The oracle's backward step (numpy only): returns
        ``err_input`` or None, and updates the parameters through
        :meth:`numpy_apply_param`."""
        raise NotImplementedError(f"{type(self).__name__}.numpy_backprop")

    def written_values(self) -> list[tuple[str, object]]:
        """``err_input``, then the forward's parameters and the unit's
        momentum and microbatch sums, which its step updates."""
        fwd = self.forward_unit
        out = super().written_values()
        out += [(f"{fwd.name}.{name}", t)
                for name, t in fwd.named_parameters(recurse=False)]
        out += [(name, t) for name, t in self.named_buffers(recurse=False)
                if name != "lr_state"]
        return out

    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        """One backward step; returns ``err_input`` in the activation
        storage dtype, or None when no unit before wants it."""
        raise NotImplementedError

    # -- the update rule --------------------------------------------------
    def _regularized(self, grad, weights, decay: float):
        if not decay:
            return grad
        l1 = self.l1_vs_l2
        reg = (1.0 - l1) * weights
        if l1:
            reg = reg + 0.5 * l1 * torch.sign(weights)
        return grad + decay * reg

    def _clipped(self, grad, groups=()):
        """``grad`` scaled down to the norm ``gradient_clip``, the norm
        that of the logical tensor: its square summed over each process
        group in ``groups`` that holds another block of it."""
        clip = self.gradient_clip
        if not clip:
            return grad
        sq = torch.sum(grad * grad)
        for group in groups:
            sq = all_reduce(sq.reshape(1), group)[0]
        norm = torch.sqrt(sq)
        return grad * torch.clamp(clip / torch.clamp(norm, min=1e-30),
                                  max=1.0)

    def _model_groups(self, param: torch.Tensor) -> tuple:
        """The model-axis group the forward parameter ``param`` (found by
        identity) is split over under tensor parallelism, as a 1-tuple,
        or ``()`` when this process holds all of it."""
        fwd = self.forward_unit
        if not isinstance(fwd, ModuleUnit):
            return ()
        for name in fwd.placements:
            if getattr(fwd, name, None) is param:
                tp = fwd._sharded(name)
                if tp is not None and tp.model_shard_dim is not None:
                    return (self.device.group(tp.model_shard_axis),)
        return ()

    @torch.no_grad()
    def apply_param(self, param: torch.Tensor, grad: torch.Tensor,
                    acc: torch.Tensor | None, decay: float,
                    lr: float | torch.Tensor, moment: float) -> None:
        """Update one parameter tensor in place from its f32 gradient;
        ``lr`` is a float or a 0-d f32 device tensor (the same f32
        multiply).

        In a region step of an accumulated optimizer step
        (:func:`~znicz_tpu_torch.accelerated_units.current_accum_phase`),
        an ``("accum", M)`` microbatch adds its gradient to the
        parameter's f32 sum and returns, leaving the parameter and its
        momentum as they were; the ``("apply", M)`` microbatch takes
        ``(sum + grad) / M``, in that order, through the update below and
        zeroes the sum."""
        phase = current_accum_phase()
        if phase is not None:
            mode, n_micro = phase
            buf = self._micro_accum.get(id(param))
            if buf is None:
                raise RuntimeError(
                    f"{self}: accumulation phase {phase} but no "
                    f"microbatch buffer for this parameter; set "
                    f"root.common.engine.grad_accum before initialize")
            if mode == "accum":
                buf.add_(grad.float())
                return
            grad = (buf + grad.float()) / n_micro
            buf.zero_()
        self._fp_register(param)
        plan = self._zero1_for(param)
        if plan is not None:
            return self._apply_zero1(param, grad, acc, decay, lr, moment,
                                     plan)
        # the data-parallel fold (identity without a data axis): each
        # process's gradient is already divided by the global batch
        grad = maybe_psum(grad.float())
        if fp8_enabled():
            grad = fp8_round_trip(grad)
        where = self._placement_of(param)
        grad, ok = self._guard_check(param, grad, where, where)
        g = self._regularized(
            self._clipped(grad.float(), self._model_groups(param)), param,
            decay)
        if moment:
            # f32 math whatever the accumulator stores; the weight takes
            # the f32 step, the store rounds to opt_state_dtype
            step = moment * acc.float() - lr * g
            if ok is None:
                acc.copy_(step)
            else:
                step = self._guarded_momentum(ok, step, acc)
            param.add_(step)
        else:
            step = lr * g
            if ok is not None:
                # a skipped tensor: x - (+0.0) is x for every x
                torch.where(ok, step, step.new_zeros(()), out=step)
            param.sub_(step)
        self._fold(0, param, where)

    @staticmethod
    def _guarded_momentum(ok, step, acc):
        """The momentum ``acc`` ← ``step`` where ``ok``, kept bit for bit
        where not (its old value read and written back in its own
        dtype), and the step to add to the parameter: ``step``, or
        ``-0.0`` (``x + (-0.0)`` is ``x`` for every ``x``, ``-0.0``
        included).  The first select writes ``acc`` in place, in the
        unguarded copy's place (``step`` rounded to the store's dtype
        first, as the copy rounds it); the second writes ``step`` in
        place, so the guard adds no tensor of the parameter's size but
        the rounded step of a narrower store."""
        torch.where(ok, step.to(acc.dtype), acc, out=acc)
        return torch.where(ok, step, step.new_full((), -0.0), out=step)

    # -- the anomaly guard and the SDC fingerprint ---------------------------
    def _param_attr(self, param: torch.Tensor) -> str:
        """The forward's attribute that holds ``param`` (by identity: a
        tied unit's weights are another unit's tensor)."""
        names = self.__dict__.setdefault("_param_names", {})
        name = names.get(id(param))
        if name is None:
            fwd = self.forward_unit
            for attr in ("weights", "bias", *(
                    n for n, _ in fwd.named_parameters(recurse=False))):
                if getattr(fwd, attr, None) is param:
                    name = names[id(param)] = attr
                    break
            else:
                raise KeyError(f"{self}: a parameter not of {fwd}")
        return name

    def _fp_register(self, param: torch.Tensor) -> str:
        """Record that ``param`` is a tensor the fingerprint covers (with
        the guard or without: the shadow audit's clone enumerates the
        same set) and return its attribute."""
        attr = self._param_attr(param)
        self._fp_folded.setdefault(f"{self.forward_unit.name}.{attr}",
                                   (self.forward_unit, attr))
        return attr

    def _placement_of(self, param: torch.Tensor):
        """``(logical shape, cuts, groups)`` of the forward parameter
        ``param``: its block of the logical tensor under tensor
        parallelism (:func:`~znicz_tpu_torch.resilience.integrity.cuts_of`),
        or the whole tensor; None without the guard."""
        if self.anomaly_flag is None:
            return None
        fwd = self.forward_unit
        resolved = fwd._sharded(self._param_attr(param)) \
            if isinstance(fwd, ModuleUnit) else None
        if resolved is None:
            return tuple(param.shape), (), ()
        cuts, groups = _integrity.cuts_of(resolved, self.device.mesh)
        return tuple(resolved.logical_shape), cuts, groups

    def _fold(self, slot: int, t: torch.Tensor, where) -> None:
        """Add the fingerprint of the logical tensor that ``t`` is (a
        block of, per ``where``) to slot ``slot`` of the guard's
        vector."""
        fpv = self.sdc_fingerprint
        if fpv is None:
            return
        shape, cuts, groups = where
        if not groups:  # the whole tensor: a gather and a fused dot-add
            index, weights = _integrity.device_plan(shape, (), t.device)
            fpv[slot:slot + 1].addmv_(t[index].float().view(1, -1), weights)
            return
        part = _integrity.fingerprint_partial(t, shape, cuts)
        for group in groups:
            part = all_reduce(part.reshape(1), group)[0]
        fpv[slot:slot + 1].add_(part)

    def _guard_check(self, param, grad, where, grad_where):
        """The guard's part of one tensor's update, before the update
        rule: the stored value folded (slot 2), the drill's flip of the
        gradient's element 0 (``weights`` only), the gradient folded
        (slot 1), and the verdict ``running flag AND isfinite(Σ g²)`` of
        the logical gradient (its partial sums summed over the axes that
        split it, so every process takes the same), ANDed into the
        running flag.  ``where`` and ``grad_where`` place the parameter
        and the gradient (:meth:`_placement_of`).  Returns ``(grad,
        ok)``; ``ok`` is None without the guard."""
        if where is None:
            return grad, None
        flags, fpv = self.anomaly_flag, self.sdc_fingerprint
        shape, cuts, groups = grad_where
        if fpv is not None:
            self._fold(2, param, where)
            sdc = self.sdc_inject
            if sdc is not None and self._param_attr(param) == "weights" \
                    and _integrity.holds_origin(cuts):
                origin = (0,) * grad.dim()
                grad = grad.clone()
                grad[origin] = grad[origin] * (1.0 + sdc[1])
        flat = grad.float().reshape(-1)
        sq = torch.dot(flat, flat)
        if not groups:
            self._fold(1, grad, grad_where)
        else:  # the partial sums of the blocks, summed over the axes
            parts = [sq]
            if fpv is not None:
                parts.append(_integrity.fingerprint_partial(grad, shape,
                                                            cuts))
            both = torch.stack(parts)
            for group in groups:
                both = all_reduce(both, group)
            sq = both[0]
            if fpv is not None:
                fpv[1:2].add_(both[1])
        own_ok = torch.isfinite(sq)
        flags[0:1].copy_(torch.where(own_ok, flags[0:1], 0.0))
        return grad, flags[0] > 0.5

    def _zero1_for(self, param: torch.Tensor):
        """The ZeRO-1 plan of the forward parameter ``param`` (found by
        identity), or None."""
        plans = self.__dict__.get("_zero1")
        if not plans:
            return None
        fwd = self.forward_unit
        for name, plan in plans.items():
            if getattr(fwd, name, None) is param:
                return plan
        return None

    @torch.no_grad()
    def _apply_zero1(self, param, grad, acc, decay, lr, moment,
                     plan) -> None:
        """The ZeRO-1 form of the update (the reference's
        ``_apply_param_zero1``, its collectives written out over the data
        axis): the gradient zero-padded along the plan's dim and
        reduce-scattered, this process's slice of the parameter and of
        its momentum updated (the clip's norm summed over the data axis
        first, and over the model axis for a tensor-parallel block),
        the slices all-gathered back into the parameter.  The
        pad rows carry exact zeros through every step."""
        group = self.device.group(DATA_AXIS)
        n = self.device.n_data_shards
        rank = self.device.data_rank
        dim, pad = plan.data_shard_dim, plan.data_shard_pad
        rows = param.shape[dim]
        # the bytes the reduce-scatter moves; the shard's math is f32
        g = grad.to(torch.bfloat16 if self.__dict__.get("_grad_comms_bf16")
                    else torch.float32).movedim(dim, 0)
        if pad:
            g = torch.cat([g, g.new_zeros((pad,) + tuple(g.shape[1:]))])
        block = (rows + pad) // n
        shard = g.new_empty((block,) + tuple(g.shape[1:]))
        reduce_scatter_flat(shard, g, group)
        shard = shard.float()
        if fp8_enabled():
            shard = fp8_round_trip(shard)
        w = param.movedim(dim, 0)
        if pad:
            w = torch.cat([w, w.new_zeros((pad,) + tuple(w.shape[1:]))])
        w_shard = w[rank * block:(rank + 1) * block]
        where = self._placement_of(param)
        if where is not None:
            # this process's block of the logical gradient, in the
            # parameter's layout
            cuts, groups = _integrity.cuts_of(plan, self.device.mesh)
            view, ok = self._guard_check(
                param, shard.movedim(0, dim),
                where, (tuple(plan.logical_shape), cuts, groups))
            shard = view.movedim(dim, 0)
        else:
            ok = None
        shard = self._clipped(shard, (group,) + self._model_groups(param))
        gs = self._regularized(shard, w_shard, decay)
        if moment:
            acc_m = acc.movedim(dim, 0)
            step = moment * acc_m.float() - lr * gs
            if ok is None:
                acc_m.copy_(step)
            else:
                step = self._guarded_momentum(ok, step, acc_m)
            new = w_shard + step
        else:
            step = lr * gs
            if ok is not None:
                torch.where(ok, step, step.new_zeros(()), out=step)
            new = w_shard - step
        whole = new.new_empty((block * n,) + tuple(new.shape[1:]))
        all_gather_flat(whole, new.contiguous(), group)
        param.copy_(whole[:rows].movedim(0, dim))
        if where is not None:
            self._fold(0, param, where)

    # -- the update rule on the numpy oracle (the reference's
    # _apply_weights_np/_apply_bias_np) ----------------------------------
    def _np_clipped(self, grad: np.ndarray) -> np.ndarray:
        clip = self.gradient_clip
        if not clip:
            return grad
        g32 = grad.astype(np.float32)
        norm = np.sqrt(np.sum(g32 * g32))
        return grad * np.minimum(1.0, clip / np.maximum(norm, 1e-30))

    def _np_regularized(self, grad: np.ndarray, weights: np.ndarray,
                        decay: float) -> np.ndarray:
        if not decay:
            return grad
        l1 = self.l1_vs_l2
        reg = (1.0 - l1) * weights
        if l1:
            reg = reg + 0.5 * l1 * np.sign(weights)
        return grad + decay * reg

    def numpy_apply_param(self, param: torch.Tensor, grad: np.ndarray,
                          acc: torch.Tensor | None, decay: float,
                          lr: float, moment: float) -> None:
        """:meth:`apply_param` in numpy, in place in the parameter's and
        the momentum's storage (the accumulation phases as there)."""
        w = as_numpy(param)
        phase = current_accum_phase()
        if phase is not None:
            mode, n_micro = phase
            buf = self._micro_accum.get(id(param))
            if buf is None:
                raise RuntimeError(
                    f"{self}: accumulation phase {phase} but no "
                    f"microbatch buffer for this parameter; set "
                    f"root.common.engine.grad_accum before initialize")
            buf = as_numpy(buf)
            if mode == "accum":
                buf += grad
                return
            grad = (buf + grad) / np.float32(n_micro)
            buf[...] = 0.0
        attr = self._fp_register(param)
        fpv = self.sdc_fingerprint
        if fpv is not None:
            # the reference's _apply_weights_np/_apply_bias_np folds
            fp = as_numpy(fpv)
            fp[2] += _integrity.tensor_fingerprint(w)
            sdc = self.sdc_inject
            if sdc is not None and attr == "weights":
                grad = np.array(grad, copy=True)
                grad.ravel()[0] *= 1.0 + as_numpy(sdc)[1]
            fp[1] += _integrity.tensor_fingerprint(grad)
        flags = self.anomaly_flag
        if flags is not None:
            own = bool(np.isfinite(np.sum(np.square(grad,
                                                    dtype=np.float64))))
            flags = as_numpy(flags)
            ok = own and flags[0] > 0.5
            if not own:
                flags[0] = 0.0
            if not ok:  # skipped: the claimed fold covers the kept value
                if fpv is not None:
                    fp[0] += _integrity.tensor_fingerprint(w)
                return
        g = self._np_regularized(self._np_clipped(grad), w, decay)
        if moment:
            a = as_numpy(acc)
            a *= moment
            a -= lr * g
            w += a
        else:
            w -= lr * g
        if fpv is not None:
            fp[0] += _integrity.tensor_fingerprint(w)

    def _np_rates(self) -> tuple[float, float]:
        """``(lr, lr_bias)`` as the oracle reads them: the host value of
        ``lr_state`` when a schedule holds it (the reference's
        ``float(lr_state.mem[i])``), else the unit's rates."""
        if self.lr_state is None:
            return self.learning_rate, self.learning_rate_bias
        state = as_numpy(self.lr_state)
        return float(state[0]), float(state[1])

    def numpy_apply_weights(self, grad: np.ndarray, param: str = "weights",
                            acc: str = "accumulated_gradient_weights"
                            ) -> None:
        self.numpy_apply_param(getattr(self.forward_unit, param), grad,
                               getattr(self, acc), self.weights_decay,
                               self._np_rates()[0], self.gradient_moment)

    def numpy_apply_bias(self, grad: np.ndarray, param: str = "bias",
                         acc: str = "accumulated_gradient_bias") -> None:
        self.numpy_apply_param(getattr(self.forward_unit, param), grad,
                               getattr(self, acc), self.weights_decay_bias,
                               self._np_rates()[1],
                               self.gradient_moment_bias)

    def apply_weights(self, grad: torch.Tensor, param: str = "weights",
                      acc: str = "accumulated_gradient_weights") -> None:
        self.apply_param(getattr(self.forward_unit, param), grad,
                         getattr(self, acc), self.weights_decay,
                         self._lr(), self.gradient_moment)

    def apply_bias(self, grad: torch.Tensor, param: str = "bias",
                   acc: str = "accumulated_gradient_bias") -> None:
        self.apply_param(getattr(self.forward_unit, param), grad,
                         getattr(self, acc), self.weights_decay_bias,
                         self._lr_bias(), self.gradient_moment_bias)


class WeightlessGradientUnit(GradientDescentBase):
    """Base of the backward units of weightless forwards (activations,
    pooling, dropout, LRN): ``err_output → err_input`` only, no
    learning rate, so no schedule claims them.  A ``learning_rate`` in
    their ``"<-"`` config is dropped, as in the reference."""

    def __init__(self, forward_unit: Forward, *args, **kwargs) -> None:
        kwargs.pop("learning_rate", None)
        super().__init__(forward_unit, *args, **kwargs)
