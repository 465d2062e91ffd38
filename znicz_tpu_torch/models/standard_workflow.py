"""StandardWorkflow: declarative model assembly and the training loop
(port of ``znicz_tpu/models/standard_workflow.py``).

The constructor is the reference's: a ``loader_factory``, a ``layers``
list of ``{"type": <name>, "->": {forward kwargs}, "<-": {gradient
kwargs}}`` dicts, ``loss`` (``"softmax"`` or ``"mse"``: the loss picks
the evaluator and the decision), an ``evaluator_config``, a
``decision_config``, a ``snapshotter_config`` and an
``lr_adjuster_config``.  So are the builders (:meth:`link_forwards`,
:meth:`link_evaluator`, :meth:`link_decision`, :meth:`link_gds`,
:meth:`link_loop`, :meth:`link_snapshotter`, :meth:`link_lr_adjuster`),
the unit names, and the graph they build from units joined by control
links and gates:

.. code-block:: text

    start → repeater → loader (host pick) → train_region → decision ─→ repeater
                                                             ├─→ lr_adjuster
                                                             ├─(improved)→ snapshotter
                                                             └─(complete)→ end

``train_region`` is a :class:`~znicz_tpu_torch.accelerated_units.RegionUnit`
over the hot chain (:meth:`hot_chain_units`):

.. code-block:: text

    loader gather → forwards → evaluator → backward units (train only)
                  → side units linked after the last backward unit

On the card it replays a CUDA graph captured once per key (train,
validation, test minibatches); on the CPU it runs the same members
eagerly.  On the numpy oracle (``initialize(device="numpy")``) there is
no region: the hot chain stays in the graph unit by unit, each unit
running its ``numpy_run``, as in the reference.  A train step runs the forwards with gradients enabled (the
attention unit keeps its autograd graph for its backward unit, max
pooling its winners) and the backward units from the last to the
first, each gated on the minibatch class.  Each backward unit reads its
forward's ``input`` and ``output`` and the ``err_output`` the unit after
it wrote, computes its ``err_input`` and gradients from the weights as
they were before the step, then updates them in place.  Stochastic
units take ``forward_mode`` from the loader.

:meth:`step` is one pass round the loop (from the repeater back to it),
:meth:`run` steps until the decision completes or :meth:`stop` is
called, and :meth:`run_chunked` runs up to ``steps_per_dispatch``
steps of one class a region dispatch (``JitRegion.run_chunk``), with
the same trajectory.  :meth:`run_accumulated` takes one optimizer step
over M train minibatches a dispatch (``JitRegion.run_accum``).  ``step(mark)`` runs the region's members eagerly
and calls ``mark(unit_name)`` after each (per-unit timing).

``initialize()`` builds the units in the reference's order — the loader
first (it draws the shuffle seed), then each forward's initial fill —
so one :func:`~znicz_tpu_torch.utils.prng.seed_all` seed gives the same
initial weights and sample order as the reference.  A snapshot
(:meth:`state_dict`) carries every unit's state by the reference's unit
names, so snapshots cross between the packages both ways.

A learning-rate schedule (``lr_adjuster_config``, or an ``lr_policy``
or ``bias_lr_policy`` in a layer's ``"<-"`` dict) is a
:class:`~znicz_tpu_torch.ops.lr_adjust.LearningRateAdjust` after the
decision; it writes each scheduled unit's rates into the device tensor
the captured step reads (``lr_state``), once a train step, or once a
chunk under :meth:`run_chunked`, as in the reference.

:meth:`link_image_saver` writes the misclassified samples of each
epoch as images after the decision.

Not ported with it (later slices): the anomaly guard (A11), the
pipelined training loop (A9), the population engine's
``promote_lr_leaves`` (A13), the plotters and the publisher (A12).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Sequence

import torch

from znicz_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               AcceleratedWorkflow, RegionUnit)
from znicz_tpu_torch.loader.base import TRAIN, Loader
from znicz_tpu_torch.models.layers import layer_type, tie, tied_config
from znicz_tpu_torch.mutable import Bool
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.ops.decision import DecisionGD, DecisionMSE
from znicz_tpu_torch.ops.evaluator import EvaluatorMSE, EvaluatorSoftmax
from znicz_tpu_torch.ops.lr_adjust import LearningRateAdjust
from znicz_tpu_torch.ops.nn_units import WeightlessGradientUnit, gd_for
from znicz_tpu_torch.units import Repeater
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.snapshotter import Snapshotter


class StandardWorkflow(AcceleratedWorkflow):
    """Declarative training workflow.

    Parameters
    ----------
    loader_factory:
        ``callable(workflow) -> Loader`` building the dataset unit.
    layers:
        list of layer dicts (``{"type", "->", "<-"}``).
    loss:
        ``"softmax"`` (classification: ``EvaluatorSoftmax`` and
        ``DecisionGD``, the last layer a ``softmax``) or ``"mse"``
        (regression and autoencoders: ``EvaluatorMSE`` against the
        loader's ``minibatch_data`` and ``DecisionMSE``, over any last
        layer, a ``softmax`` included: its linear backward takes the
        MSE error at the probabilities, as the reference's does).
    evaluator_config:
        kwargs of the evaluator (``compute_confusion=True`` for the
        softmax's confusion matrices).
    decision_config:
        kwargs of the decision.
    snapshotter_config:
        kwargs of :class:`~znicz_tpu_torch.utils.snapshotter.Snapshotter`
        (``None``: no snapshots).
    lr_adjuster_config:
        kwargs of :meth:`link_lr_adjuster` (``None``: no schedule, unless
        a layer names its own policy).
    """

    def __init__(self, workflow=None, name: str | None = None,
                 loader_factory: Callable[["StandardWorkflow"], Loader]
                 | None = None,
                 layers: Sequence[dict] = (),
                 loss: str = "softmax",
                 evaluator_config: dict[str, Any] | None = None,
                 decision_config: dict[str, Any] | None = None,
                 snapshotter_config: dict[str, Any] | None = None,
                 lr_adjuster_config: dict[str, Any] | None = None,
                 **kwargs) -> None:
        if loader_factory is None:
            raise ValueError("loader_factory is required")
        if loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss '{loss}' (softmax or mse)")
        last = layers[-1]["type"] if layers else None
        if loss == "softmax" and last != "softmax":
            raise ValueError("a softmax workflow ends with a 'softmax' "
                             "layer")
        super().__init__(workflow, name=name, **kwargs)
        self.layers_config = list(layers)
        self.loss = loss
        self.compute_dtype = torch.float32
        self.repeater = Repeater(self, name="repeater")
        self.loader = loader_factory(self)
        if not isinstance(self.loader, Loader):
            raise TypeError(f"loader_factory gave {type(self.loader)}")
        self.forwards = torch.nn.ModuleList()
        self.gds = torch.nn.ModuleList()
        self.link_forwards()
        self.link_evaluator(**(evaluator_config or {}))
        self.link_decision(**(decision_config or {}))
        self.link_gds()
        self.link_loop()
        self.lr_adjuster: LearningRateAdjust | None = None
        if lr_adjuster_config is None and any(
                key in spec.get("<-", {}) for spec in self.layers_config
                for key in ("lr_policy", "bias_lr_policy")):
            lr_adjuster_config = {}  # a layer's own policy implies one
        if lr_adjuster_config is not None:
            self.link_lr_adjuster(**lr_adjuster_config)
        # after the adjuster (C9): a snapshot holds the iteration count
        # the step it closes has reached, so a resume goes on at the
        # rate the uninterrupted run takes
        self.snapshotter: Snapshotter | None = None
        if snapshotter_config is not None:
            self.link_snapshotter(**snapshotter_config)
        self._region_unit: RegionUnit | None = None

    # -- builders (the reference's) ----------------------------------------
    def link_forwards(self) -> None:
        """The forward units in order, each reading the one before; a
        layer with ``tied_to`` is paired with that earlier layer (a
        deconv with its conv, whose geometry it takes unless its own
        ``->`` sets it, and whose weights it shares with
        ``tied_weights``; a depooling with its pooling), and any other
        type refuses it, as in the reference."""
        prev = None
        for spec in self.layers_config:
            cls = layer_type(spec["type"])
            tied = spec.get("tied_to")
            cfg = dict(spec.get("->", {}))
            if tied is not None:
                cfg = tied_config(cls, cfg,
                                  self.layers_config[tied].get("->", {}))
            unit = cls(workflow=self, **cfg)
            if tied is not None:
                tie(unit, self.forwards[tied], spec["type"],
                    spec.get("tied_weights"))
            if prev is None:
                unit.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                unit.link_attrs(prev, ("input", "output"))
            if "forward_mode" in unit.__dict__:  # stochastic units track
                unit.link_attrs(self.loader, "forward_mode",
                                two_way=False)  # the minibatch class
            self.forwards.append(unit)
            prev = unit

    def link_evaluator(self, **config) -> None:
        last = self.forwards[-1]
        if self.loss == "softmax":
            ev = EvaluatorSoftmax(self, name="evaluator", **config)
            ev.link_attrs(last, "output", "max_idx")
            ev.link_attrs(self.loader, ("labels", "minibatch_labels"),
                          "minibatch_valid", "minibatch_class")
        else:
            # an autoencoder's target: the normalized input minibatch
            ev = EvaluatorMSE(self, name="evaluator", **config)
            ev.link_attrs(last, "output")
            ev.link_attrs(self.loader, ("target", "minibatch_data"),
                          "minibatch_valid", "minibatch_class")
        self.evaluator = ev

    def link_decision(self, **config) -> None:
        cls = DecisionGD if self.loss == "softmax" else DecisionMSE
        self.decision = cls(self, name="decision", **config)
        self.decision.loader = self.loader
        self.decision.evaluator = self.evaluator

    def link_gds(self) -> None:
        """The backward chain through the forward↔backward pairing
        registry, built from the last layer to the first."""
        gds = []
        next_gd = None
        for i, fwd in enumerate(reversed(self.forwards)):
            spec = self.layers_config[len(self.forwards) - 1 - i]
            gd_kwargs = {k: v for k, v in spec.get("<-", {}).items()
                         if k not in ("lr_policy", "bias_lr_policy")}
            unit = gd_for(type(fwd))(
                fwd, workflow=self,
                need_err_input=(i != len(self.forwards) - 1), **gd_kwargs)
            unit.link_attrs(fwd, "input", "output")
            if next_gd is None:
                unit.link_attrs(self.evaluator, "err_output")
            else:
                unit.link_attrs(next_gd, ("err_output", "err_input"))
            # train minibatches only
            unit.gate_skip = Bool._derived(
                lambda: self.loader.minibatch_class != TRAIN)
            gds.append(unit)
            next_gd = unit
        self.gds.extend(reversed(gds))

    def link_loop(self) -> None:
        """The training loop's control flow."""
        decision = self.decision
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        decision.link_from(self._link_hot_chain(self.loader))
        self.repeater.link_from(decision)
        self.repeater.gate_block = Bool._derived(lambda: decision.complete)
        self.end_point.link_from(decision)
        self.end_point.gate_block = Bool._derived(
            lambda: not decision.complete)

    def _link_hot_chain(self, after):
        """The hot chain unit by unit; :meth:`initialize` puts the region
        in its place."""
        prev = after
        for fwd in self.forwards:
            fwd.link_from(prev)
            prev = fwd
        self.evaluator.link_from(prev)
        prev = self.evaluator
        for gd_unit in reversed(self.gds):
            gd_unit.link_from(prev)
            prev = gd_unit
        return prev

    def _relink_end_point_last(self) -> None:
        """Keep ``end_point`` the decision's last successor, so a side
        unit still fires on the last epoch."""
        if self.decision in self.end_point.links_from:
            self.end_point.unlink_from(self.decision)
            self.end_point.link_from(self.decision)

    def link_snapshotter(self, **config) -> None:
        decision = self.decision
        self.snapshotter = Snapshotter(self, name="snapshotter", **config)
        self.snapshotter.decision = decision
        self.snapshotter.link_from(decision)
        self._relink_end_point_last()
        self.snapshotter.gate_skip = Bool._derived(
            lambda: not decision.improved)

    def link_lr_adjuster(self, lr_policy=None, bias_lr_policy=None) -> None:
        """A :class:`LearningRateAdjust` after the decision over the
        units that have weights; a layer's ``lr_policy`` and
        ``bias_lr_policy`` in its ``"<-"`` dict override the arguments
        here, which are the defaults."""
        adj = LearningRateAdjust(self, name="lr_adjuster")
        adj.loader = self.loader
        for i, gd_unit in enumerate(self.gds):
            if isinstance(gd_unit, WeightlessGradientUnit):
                continue  # no rate to schedule
            spec = self.layers_config[i].get("<-", {})
            adj.add_gd_unit(
                gd_unit, lr_policy=spec.get("lr_policy", lr_policy),
                bias_lr_policy=spec.get("bias_lr_policy", bias_lr_policy))
        adj.link_from(self.decision)
        self._relink_end_point_last()
        self.lr_adjuster = adj

    def link_image_saver(self, **config):
        """Write the misclassified samples of each epoch as images (the
        reference's ``link_image_saver``;
        :class:`~znicz_tpu_torch.ops.image_saver.ImageSaver`):
        classification workflows only.  It runs after the decision,
        every step."""
        from znicz_tpu_torch.ops.image_saver import ImageSaver
        if self.loss != "softmax":
            raise ValueError("image saver needs a classification loss")
        s = ImageSaver(self, name="image_saver", **config)
        s.link_attrs(self.loader, ("input", "minibatch_data"),
                     ("labels", "minibatch_labels"),
                     ("indices", "minibatch_indices"),
                     "minibatch_valid", "minibatch_class", "epoch_number",
                     two_way=False)
        s.link_attrs(self.forwards[-1], "max_idx", two_way=False)
        s.link_from(self.decision)  # after the step's compute
        self._relink_end_point_last()
        self.image_saver = s
        return s

    def hot_chain_units(self) -> list:
        """The per-minibatch hot chain in the region's order, then the
        accelerated side units linked after its last unit (a
        ``ZeroFiller`` after the backward chain), which the region runs
        after it."""
        chain = [self.loader, *self.forwards, self.evaluator,
                 *reversed(self.gds)]
        side = [u for u in chain[-1].links_to
                if u is not self.decision and isinstance(u, AcceleratedUnit)]
        return chain + side

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Resolve the device (``None`` → the current GPU, raising when
        there is none; ``"cpu"`` or ``"numpy"`` only when asked), then
        initialize every unit and put the region in the hot chain's
        place (not on the numpy oracle, whose units run one by one).
        The precision mode is ``root.common.precision_type``, as in the
        reference."""
        super().initialize(device=device, **kwargs)
        self.compute_dtype = self.device.compute_dtype
        if not self.device.is_host_only and self._region_unit is None:
            self._compile_region()

    def _compile_region(self) -> None:
        """Swap the hot chain for one region unit."""
        region = RegionUnit(self, self.hot_chain_units(),
                            name="train_region")
        region.initialize(device=self.device)
        region._initialized = True
        self.decision.unlink_from(self.gds[0] if self.gds
                                  else self.evaluator)
        self.forwards[0].unlink_from(self.loader)
        region.link_from(self.loader)
        self.decision.link_from(region)
        self._region_unit = region

    @property
    def _oracle(self) -> bool:
        """True once initialized on the numpy oracle (no region)."""
        return self.device is not None and self.device.is_host_only

    @property
    def region(self):
        """The training step's :class:`JitRegion` (after initialize)."""
        return None if self._region_unit is None \
            else self._region_unit.region

    # -- running -----------------------------------------------------------------
    def step(self, mark: Callable[[str], None] | None = None) -> None:
        """One pass round the loop: the loader's pick, the region, the
        decision's bookkeeping, the snapshotter when the decision raised
        ``improved``.  ``mark``, when given, makes the region run its
        members eagerly and is called with each member's name just after
        it queued its work (a caller that records a CUDA event there
        times each unit on the device)."""
        region = self.region
        if region is None and not self._oracle:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        self._finished = False
        if region is None:  # the oracle: no region to time
            self._drain(deque(self.repeater.links_to),
                        pause_at=self.repeater, honor_stop=False)
            return
        region.mark = mark
        try:
            self._drain(deque(self.repeater.links_to),
                        pause_at=self.repeater, honor_stop=False)
        finally:
            region.mark = None

    def run(self) -> None:
        """Step until the decision completes or :meth:`stop` is called
        (checked between steps)."""
        queue = self._begin_run()
        self._drain(queue, pause_at=self.repeater)
        with _tracing.TRACER.span(f"workflow:{self.name}", cat="workflow"):
            while not (self._finished or self.stopped
                       or self.decision.complete):
                self.step()
        self.on_workflow_finished()

    def run_chunked(self, steps_per_dispatch: int = 32) -> None:
        """Up to ``steps_per_dispatch`` steps a region dispatch
        (``JitRegion.run_chunk``: a captured step's graph replayed with
        no host work between), with :meth:`run`'s trajectory: the
        loader's device schedule gives each step its minibatch, the seed
        chains and the evaluator's sums advance on the device.  A chunk
        never crosses a class segment or an epoch, so the decision and
        the units after it (the snapshotter) fire where they would.  A
        learning-rate schedule is the exception, as in the reference: it
        writes its rate once a chunk, so the rate is constant within a
        chunk.  With one step a dispatch, a loader whose schedule is not on
        the device, on the numpy oracle, or with a unit linked that needs
        every minibatch (``NEEDS_PER_STEP_MINIBATCHES``: the image saver),
        this is :meth:`run` (the last with a warning, as in the
        reference)."""
        region = self.region
        loader = self.loader
        if self._oracle:
            return self.run()
        if region is None:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        if steps_per_dispatch <= 1 or not loader.device_schedule:
            return self.run()
        per_step = [u.name for u in self.units
                    if getattr(u, "NEEDS_PER_STEP_MINIBATCHES", False)]
        if per_step:
            # such a unit reads every minibatch (the image saver's
            # misclassified samples); a chunk keeps only its last one
            self.warning("run_chunked: %s need per-step minibatches — "
                         "falling back to per-step run()", per_step)
            return self.run()
        decision = self.decision
        adjuster = self.lr_adjuster
        side_units = [u for u in decision.links_to
                      if u not in (self.repeater, self.end_point, adjuster)]
        self._begin_run()
        chunks = 0
        with _tracing.TRACER.span(f"workflow:{self.name}", cat="workflow",
                                  chunk=steps_per_dispatch):
            while not decision.complete and not self.stopped:
                loader.run()  # the host's pick (the gather is the region's)
                cls = loader.minibatch_class
                k = 1
                while (k < steps_per_dispatch and not loader.epoch_ended
                       and loader._schedule[loader._cursor][0] == cls):
                    loader.run()
                    k += 1
                region.run_chunk(k)
                if adjuster is not None and cls == TRAIN:
                    # the rate of the next chunk's first step, held
                    # through that chunk (the reference's granularity)
                    adjuster._n_iterations += k - 1
                    adjuster._fire()
                decision._fire()
                for unit in side_units:
                    if not unit.gate_block and not unit.gate_skip:
                        unit._fire()
                chunks += 1
                if self._max_fires is not None and chunks > self._max_fires:
                    raise RuntimeError(
                        f"workflow '{self.name}' exceeded max_fires="
                        f"{self._max_fires} chunks (runaway loop?)")
        self.on_workflow_finished()

    def run_accumulated(self, microbatches: int | None = None) -> None:
        """Train with microbatch gradient accumulation: every optimizer
        step takes ``M`` consecutive train minibatches (``microbatches``,
        by default ``root.common.engine.grad_accum``) in one region
        dispatch (``JitRegion.run_accum``), so the step's batch is ``M``
        times the loader's minibatch while the activations stay those of
        one minibatch.  Each microbatch's gradient is normalized by its
        own size and the apply phase divides the sum by ``M``, so where
        the arithmetic is exact the update equals a fused batch of
        ``M × minibatch_size`` bit for bit.  Validation and test
        minibatches run unaccumulated, one a dispatch; the learning-rate
        schedule advances once an optimizer step.

        The backward units must have their microbatch buffers: set
        ``root.common.engine.grad_accum`` before :meth:`initialize`.
        The train set must divide into whole accumulated steps, and the
        loader's schedule must be on the device.  The reference's
        anomaly guard, ZeRO-1 and SDC fingerprints compose here once
        they are ported (A9, A11).  ``M == 1`` is :meth:`run`."""
        region = self.region
        loader = self.loader
        if self._oracle:
            raise RuntimeError(
                f"workflow '{self.name}': run_accumulated runs the region's "
                f"accumulation phases, and the numpy oracle has no region")
        if region is None:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        if microbatches is None:
            microbatches = int(root.common.engine.get("grad_accum", 1) or 1)
        n_micro = int(microbatches)
        if n_micro <= 1:
            return self.run()
        if not loader.device_schedule:
            raise RuntimeError(
                f"workflow '{self.name}': run_accumulated needs a loader "
                f"whose schedule is on the device (the microbatches of a "
                f"step run in one dispatch with no host work between)")
        span = loader.max_minibatch_size * n_micro
        n_train = int(loader.class_lengths[TRAIN])
        if n_train % span:
            raise RuntimeError(
                f"workflow '{self.name}': a train set of {n_train} does "
                f"not divide into accumulated steps of "
                f"{loader.max_minibatch_size} × {n_micro} microbatches: a "
                f"short last microbatch would break the fixed step")
        decision = self.decision
        adjuster = self.lr_adjuster
        side_units = [u for u in decision.links_to
                      if u not in (self.repeater, self.end_point, adjuster)]
        _metrics.grad_accum_microbatches(self.name).set(n_micro)
        self._begin_run()
        steps = 0
        with _tracing.TRACER.span(f"workflow:{self.name}", cat="workflow",
                                  accum=n_micro):
            while not decision.complete and not self.stopped:
                loader.run()  # the host's pick (the gather is the region's)
                if loader.minibatch_class == TRAIN:
                    for _ in range(n_micro - 1):
                        loader.run()
                    region.run_accum(n_micro)
                    if adjuster is not None:
                        adjuster._fire()  # one optimizer step, whatever M
                else:
                    region.run()
                decision._fire()
                for unit in side_units:
                    if not unit.gate_block and not unit.gate_skip:
                        unit._fire()
                steps += 1
                if self._max_fires is not None and steps > self._max_fires:
                    raise RuntimeError(
                        f"workflow '{self.name}' exceeded max_fires="
                        f"{self._max_fires} steps (runaway loop?)")
        self.on_workflow_finished()

    # -- state -----------------------------------------------------------------------
    def load_state(self, state: dict) -> None:
        """Carry a state across: the reference's ``Workflow.state_dict()``
        (or this class's own).  Reads each unit's parameters and
        momentum accumulators (f32 or bf16 numpy, rounded to this run's
        storage dtype, written in place; a missing one raises), the
        loader's ``_shuffle_seed``, ``_shuffled``, ``_cursor`` and
        ``epoch_number``, the evaluator's epoch counters, the decision's
        best errors and epochs without improvement, the seed chains, and
        the host generator.  A loader, evaluator or decision key the
        state lacks keeps its value, as in the reference."""
        by_name = state["__units__"]
        for unit in [*self.forwards, *self.gds]:
            if unit.own_tensors() and unit.name not in by_name:
                unit.load_state({})  # raises, naming what is missing
        super().load_state(state)

    #: the name the port's first slices gave :meth:`load_state`
    load_reference_state = load_state

    def export_forward(self, path: str) -> str:
        """Write the trained forward chain as a bundle in the
        reference's format (see :func:`znicz_tpu_torch.export.export_forward`)."""
        from znicz_tpu_torch.export import export_forward
        return export_forward(self, path)
