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
  layers are stored in bf16 in bf16 mode and in f32 otherwise.

:class:`GradientDescentBase` is the reference's update rule, cut to what
the training paths run (learning rates, L1/L2 decay, momentum,
gradient-norm clipping) and microbatch gradient accumulation
(``root.common.engine.grad_accum``, :meth:`GradientDescentBase.apply_param`);
ZeRO-1, the anomaly guard, the SDC fingerprint and fp8 belong to later
slices.  Momentum is stored in bf16 in bf16 mode with its math in f32,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products
from znicz_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               current_accum_phase,
                                               precision_dtypes)
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.prng import SeedChain

#: microbatches a weighted backward unit accumulates a step for
#: (``StandardWorkflow.run_accumulated``); 1: fused batches
register_defaults("common", {"engine": {"grad_accum": 1}})

__all__ = ["Forward", "GradientDescentBase", "Stochastic",
           "WeightlessGradientUnit", "gd_for"]


class ModuleUnit(AcceleratedUnit, nn.Module):
    """An accelerated unit that is an ``nn.Module``: its snapshot state
    is its own parameters and buffers (f32 host copies), and a snapshot
    that lacks one raises.  Called with ``nn.Module``'s arguments
    (``destination``, ``prefix``, ``keep_vars``), :meth:`state_dict` is
    ``nn.Module``'s, so a module tree holding the unit keeps working."""

    def state_dict(self, *args, allow_collective: bool = False, **kwargs):
        if args or kwargs:
            return nn.Module.state_dict(self, *args, **kwargs)
        return {name: t.detach().to("cpu", torch.float32, copy=True).numpy()
                for name, t in self.own_tensors()}

    def own_tensors(self) -> list[tuple[str, torch.Tensor]]:
        return [*self.named_parameters(recurse=False),
                *self.named_buffers(recurse=False)]

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Each parameter and buffer from ``state`` (f32 or bf16 numpy,
        rounded to the tensor's dtype, written in place)."""
        for name, t in self.own_tensors():
            if name not in state:
                raise KeyError(f"state has no '{self.name}.{name}'")
            value = np.asarray(state[name]).astype(np.float32)
            if value.shape != tuple(t.shape):
                raise ValueError(f"{self.name}.{name}: state shape "
                                 f"{value.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(value))


class Forward(ModuleUnit):
    """Base forward unit over a batch of samples of ``input_shape``."""

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


class Stochastic:
    """Mixin of a forward that draws a seed a train step (dropout,
    stochastic pooling) from its :class:`SeedChain`: a seed on the
    device that the step advances, rooted in one draw from the default
    generator.  ``forward_mode`` is part of the region key; the chain's
    next seed is part of the snapshot (``seed_chain``)."""

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

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        if not self.forward_unit.is_initialized:
            raise AttributeError(f"{self}: forward {self.forward_unit} not "
                                 f"initialized yet")
        self.compute_dtype = self.forward_unit.compute_dtype
        self.bind_forward()

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
        mode (the math stays f32), else f32."""
        return precision_dtypes(self.forward_unit.compute_dtype)[1]

    @property
    def act_store_dtype(self) -> torch.dtype:
        return self.forward_unit.act_store_dtype

    def alloc_accumulator(self, name: str, param: str,
                          moment: float) -> None:
        """A zero momentum buffer ``name`` for the forward's ``param``
        (None when the parameter or the moment is absent)."""
        value = getattr(self.forward_unit, param, None)
        self.register_buffer(name, torch.zeros(
            value.shape, dtype=self.opt_state_dtype, device=value.device)
            if moment and value is not None else None)

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

    def _clipped(self, grad):
        clip = self.gradient_clip
        if not clip:
            return grad
        norm = torch.sqrt(torch.sum(grad * grad))
        return grad * torch.clamp(clip / torch.clamp(norm, min=1e-30),
                                  max=1.0)

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
        g = self._regularized(self._clipped(grad.float()), param, decay)
        if moment:
            # f32 math whatever the accumulator stores; the weight takes
            # the f32 step, the store rounds to opt_state_dtype
            step = moment * acc.float() - lr * g
            acc.copy_(step)
            param.add_(step)
        else:
            param.sub_(lr * g)

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
