"""Learning-rate schedules (port of ``znicz_tpu/ops/lr_adjust.py``).

The policies are the reference's (``lr = f(base_lr, iteration)``):
``fixed``, ``step_exp`` (Caffe's "step"), ``exp``, ``inv``, ``poly`` and
``arbitrary_step``, built by :func:`make_policy` from ``None``, a policy,
a ``(name, kwargs)`` pair or a ``{"name": …, **kwargs}`` dict.

:class:`LearningRateAdjust` is a unit after the decision.  Each train
step advances its iteration count and writes each scheduled unit's
rates into that unit's ``lr_state`` (``[lr, lr_bias]``, f32 on the
device), in place.  The update reads the rates from that tensor
(``GradientDescentBase._lr``), so the captured step of a CUDA graph
takes the rate written before each replay and is captured once, however
often the rate changes.  A rate passed as a Python float would be
frozen into the capture; a rebound ``lr_state`` would leave the graph
reading the old tensor, which the region refuses at its next replay.
The bias follows the weights' policy unless it has its own, as in the
reference.  Under ``run_chunked`` the rate is written once a chunk
(piecewise constant within it), as the reference writes it.

A snapshot carries the iteration count (``_n_iterations``); loading it
writes the rates of that iteration again.
"""

from __future__ import annotations

from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.ops.nn_units import GradientDescentBase
from znicz_tpu_torch.units import Unit


class LRPolicyBase:
    """A learning-rate schedule ``lr = f(base_lr, iteration)``."""

    def __call__(self, base_lr: float, itr: int) -> float:
        raise NotImplementedError

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(
            self.__dict__.items()))
        return f"{type(self).__name__}({args})"


class FixedPolicy(LRPolicyBase):
    """A constant rate (the unit's own, or ``lr``)."""

    def __init__(self, lr: float | None = None) -> None:
        self.lr = lr

    def __call__(self, base_lr: float, itr: int) -> float:
        return base_lr if self.lr is None else self.lr


class StepExpPolicy(LRPolicyBase):
    """``lr = base · gamma^⌊itr / step⌋``."""

    def __init__(self, gamma: float, step: int) -> None:
        self.gamma = gamma
        self.step = int(step)

    def __call__(self, base_lr: float, itr: int) -> float:
        return base_lr * self.gamma ** (itr // self.step)


class ExpPolicy(LRPolicyBase):
    """``lr = base · gamma^itr``."""

    def __init__(self, gamma: float) -> None:
        self.gamma = gamma

    def __call__(self, base_lr: float, itr: int) -> float:
        return base_lr * self.gamma ** itr


class InvPolicy(LRPolicyBase):
    """``lr = base · (1 + gamma·itr)^(−power)``."""

    def __init__(self, gamma: float, power: float = 1.0) -> None:
        self.gamma = gamma
        self.power = power

    def __call__(self, base_lr: float, itr: int) -> float:
        return base_lr * (1.0 + self.gamma * itr) ** (-self.power)


class PolyPolicy(LRPolicyBase):
    """``lr = base · max(0, 1 − itr/max_iter)^power``."""

    def __init__(self, max_iter: int, power: float = 1.0) -> None:
        self.max_iter = int(max_iter)
        self.power = power

    def __call__(self, base_lr: float, itr: int) -> float:
        frac = max(0.0, 1.0 - itr / self.max_iter)
        return base_lr * frac ** self.power


class ArbitraryStepPolicy(LRPolicyBase):
    """A piecewise-constant schedule ``[(lr, n_steps), …]``; the last
    rate holds once the list runs out."""

    def __init__(self, lrs_with_lengths: list[tuple[float, int]]) -> None:
        if not lrs_with_lengths:
            raise ValueError("empty schedule")
        self.lrs_with_lengths = [(float(lr), int(n))
                                 for lr, n in lrs_with_lengths]

    def __call__(self, base_lr: float, itr: int) -> float:
        remaining = itr
        for lr, length in self.lrs_with_lengths:
            if remaining < length:
                return lr
            remaining -= length
        return self.lrs_with_lengths[-1][0]


POLICIES = {
    "fixed": FixedPolicy,
    "step_exp": StepExpPolicy,
    "exp": ExpPolicy,
    "inv": InvPolicy,
    "poly": PolyPolicy,
    "arbitrary_step": ArbitraryStepPolicy,
}


def make_policy(spec) -> LRPolicyBase | None:
    """A policy from ``None``, a policy, a ``(name, kwargs)`` pair or a
    ``{"name": …, **kwargs}`` dict."""
    if spec is None or isinstance(spec, LRPolicyBase):
        return spec
    if isinstance(spec, dict):
        spec = dict(spec)
        name = spec.pop("name")
        return POLICIES[name](**spec)
    if isinstance(spec, (tuple, list)):
        name, kwargs = spec
        return POLICIES[name](**kwargs)
    raise TypeError(f"cannot build LR policy from {spec!r}")


class LearningRateAdjust(Unit):
    """Writes the scheduled units' rates once a train step (after the
    decision, before the next step's region)."""

    SNAPSHOT_ATTRS = ("_n_iterations",)

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self._gd_units: list[tuple[GradientDescentBase,
                                   LRPolicyBase | None,
                                   LRPolicyBase | None]] = []
        self._n_iterations = 0
        self.loader = None  # linked by the workflow

    def add_gd_unit(self, gd_unit: GradientDescentBase, lr_policy=None,
                    bias_lr_policy=None) -> None:
        self._gd_units.append((gd_unit, make_policy(lr_policy),
                               make_policy(bias_lr_policy)))

    def initialize(self, **kwargs) -> None:
        """Give each unit with a policy its ``lr_state`` (deferred until
        the unit is initialized) and write the rates of iteration 0."""
        if self.loader is None:
            raise ValueError(f"{self}: loader not set")
        for gd_unit, lr_policy, bias_policy in self._gd_units:
            if lr_policy is None and bias_policy is None:
                continue
            if not gd_unit.is_initialized:
                raise AttributeError(f"{self}: {gd_unit} not initialized "
                                     f"yet")
            gd_unit.claim_lr_state()
        super().initialize(**kwargs)
        self._apply()

    def run(self) -> None:
        if self.loader.minibatch_class != TRAIN:
            return  # only train steps advance the schedule
        self._n_iterations += 1
        self._apply()

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self._apply()

    def _apply(self) -> None:
        for gd_unit, lr_policy, bias_policy in self._gd_units:
            if lr_policy is None and bias_policy is None:
                continue
            gd_unit.write_lr_state(*_rates(gd_unit, lr_policy, bias_policy,
                                           self._n_iterations))


def _rates(gd_unit, lr_policy, bias_policy, itr: int) -> tuple[float, float]:
    """``(lr, lr_bias)`` of ``gd_unit`` at iteration ``itr``."""
    lr, lr_bias = gd_unit.learning_rate, gd_unit.learning_rate_bias
    follow = bias_policy if bias_policy is not None else lr_policy
    return (lr if lr_policy is None else lr_policy(lr, itr),
            lr_bias if follow is None else follow(lr_bias, itr))
