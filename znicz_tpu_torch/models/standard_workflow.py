"""StandardWorkflow: declarative model assembly and the training loop
(port of ``znicz_tpu/models/standard_workflow.py``).

The constructor is the reference's: a ``loader_factory``, a ``layers``
list of ``{"type": <name>, "->": {forward kwargs}, "<-": {gradient
kwargs}}`` dicts, ``loss="softmax"``, a ``decision_config`` and a
``snapshotter_config``.  So are the attributes ``forwards``, ``gds``,
``loader``, ``evaluator``, ``decision`` and ``snapshotter``, and the
entry points :meth:`initialize`, :meth:`run`, :meth:`stop`,
:meth:`state_dict`, :meth:`load_state` and :meth:`export_forward`.

The reference's topology (start → repeater → loader → hot chain →
decision → snapshotter on improvement → repeater, or end once the
decision completes) is a plain Python loop here, :meth:`run`; its hot
chain, which the reference compiles into one region program, is one
eager :meth:`step`:

.. code-block:: text

    loader gather → forwards → evaluator → backward units (train only)

A train step runs the forwards with gradients enabled (the attention
unit keeps its autograd graph for its backward unit, max pooling its
winners) and the backward units from the last to the first.  Each
backward unit gets its forward's input, the error at its output and
its forward's output of this step (the conv and all2all flavors take
their activation derivative from it); per-step state a forward keeps
(the dropout seed) it reads from its forward unit.  Each computes its
``err_input`` and gradients from the weights as they were before the
step, then updates them in place.  Validation and test minibatches run
the forwards and the evaluator only.  Before the forwards run, every
unit with a ``forward_mode`` gets the loader's ("train" on a train
minibatch, else "eval"), as the reference links it.

``initialize()`` builds the units in the reference's order — the loader
first (it draws the shuffle seed), then each forward's initial fill —
so one :func:`~znicz_tpu_torch.utils.prng.seed_all` seed gives the same
initial weights and sample order as the reference.  Units carry the
reference's default names, so :meth:`load_state` reads the reference's
``Workflow.state_dict()`` as it stands, and the reference reads this
class's: a snapshot carries every unit's state, the decision's and the
evaluator's counters included, so a resumed run goes on as the
uninterrupted one would have.

Not ported with it (later slices): the Veles unit graph, gates and
``Vector`` buffers, the anomaly guard, learning-rate schedules, the
chunked, accumulated and pipelined training loops and the MSE loss.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from znicz_tpu_torch.backends import resolve_device, torch_dtype
from znicz_tpu_torch.loader.base import TRAIN, Loader
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.ops.decision import DecisionGD
from znicz_tpu_torch.ops.evaluator import EvaluatorSoftmax
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger
from znicz_tpu_torch.utils.snapshotter import Snapshotter


class StandardWorkflow(Logger):
    """Declarative training workflow.

    Parameters
    ----------
    loader_factory:
        ``callable(workflow) -> Loader`` building the dataset unit.
    layers:
        list of layer dicts (``{"type", "->", "<-"}``).
    loss:
        ``"softmax"`` (classification; the only loss ported so far).
    decision_config:
        kwargs of :class:`~znicz_tpu_torch.ops.decision.DecisionGD`.
    snapshotter_config:
        kwargs of :class:`~znicz_tpu_torch.utils.snapshotter.Snapshotter`
        (``None``: no snapshots).
    """

    def __init__(self, name: str | None = None,
                 loader_factory: Callable[["StandardWorkflow"], Loader]
                 | None = None,
                 layers: Sequence[dict] = (),
                 loss: str = "softmax",
                 decision_config: dict[str, Any] | None = None,
                 snapshotter_config: dict[str, Any] | None = None) -> None:
        super().__init__()
        if loader_factory is None:
            raise ValueError("loader_factory is required")
        if loss != "softmax":
            raise ValueError(f"loss '{loss}' is not ported yet (ported: "
                             f"softmax)")
        if not layers or layers[-1]["type"] != "softmax":
            raise ValueError("a softmax workflow ends with a 'softmax' "
                             "layer")
        self.name = name or type(self).__name__
        self.layers_config = list(layers)
        self.loss = loss
        self.loader = loader_factory(self)
        if not isinstance(self.loader, Loader):
            raise TypeError(f"loader_factory gave {type(self.loader)}")
        self.decision = DecisionGD(**(decision_config or {}))
        self.forwards = torch.nn.ModuleList()
        self.gds = torch.nn.ModuleList()
        self.evaluator: EvaluatorSoftmax | None = None
        self.device: torch.device | None = None
        self.compute_dtype = torch.float32
        self.snapshotter: Snapshotter | None = None
        if snapshotter_config is not None:
            self.snapshotter = Snapshotter(self, **snapshotter_config)
            self.snapshotter.decision = self.decision
        self._stop_requested = False

    @property
    def is_initialized(self) -> bool:
        return self.evaluator is not None

    # ------------------------------------------------------------------
    def initialize(self, device=None) -> None:
        """Resolve the device (``None`` → the current GPU, raising when
        there is none; ``"cpu"`` only when asked), then build and fill
        every unit.  The precision mode is
        ``root.common.precision_type``, as in the reference."""
        self.device = resolve_device(device)
        self.compute_dtype = torch_dtype(root.common.precision_type)
        self.loader.initialize(self.device, self.compute_dtype)
        names = {self.loader.name}

        def unique(name: str) -> str:
            # the reference's Container.add_ref naming: the class name,
            # then _2, _3, … for repeats
            if name in names:
                i = 2
                while f"{name}_{i}" in names:
                    i += 1
                name = f"{name}_{i}"
            names.add(name)
            return name

        shape = self.loader.sample_shape
        for spec in self.layers_config:
            unit = layer_type(spec["type"])(shape, self.compute_dtype,
                                            **dict(spec.get("->", {})))
            unit.name = unique(type(unit).__name__)
            unit.init_params(self.device)
            self.forwards.append(unit)
            shape = unit.output_shape
        self.evaluator = EvaluatorSoftmax(self.device)
        self.decision.loader = self.loader
        self.decision.evaluator = self.evaluator
        gds = []
        for i, fwd in reversed(list(enumerate(self.forwards))):
            unit = gd_for(type(fwd))(fwd, need_err_input=i > 0,
                                     **self.layers_config[i].get("<-", {}))
            unit.name = unique(type(unit).__name__)
            gds.append(unit)
        self.gds.extend(reversed(gds))

    # ------------------------------------------------------------------
    def step(self, mark: Callable[[str], None] | None = None) -> None:
        """One minibatch: gather, forwards, evaluator, and on a train
        minibatch the backward units; then the decision's bookkeeping.
        ``mark``, when given, is called with each unit's name just after
        the unit has queued its work (a caller that records a CUDA event
        there times each unit on the device)."""
        done = mark or (lambda name: None)
        loader = self.loader
        loader.run()
        done(loader.name)
        train = loader.minibatch_class == TRAIN
        for fwd in self.forwards:
            if hasattr(fwd, "forward_mode"):
                fwd.forward_mode = loader.forward_mode
        acts = [loader.minibatch_data]
        with torch.set_grad_enabled(train):
            for fwd in self.forwards[:-1]:
                acts.append(fwd(acts[-1]))
                done(fwd.name)
            probs, max_idx = self.forwards[-1].classify(acts[-1])
            done(self.forwards[-1].name)
        err = self.evaluator.run(probs, max_idx, loader.minibatch_labels,
                                 loader.minibatch_size,
                                 loader.minibatch_class)
        done(self.evaluator.name)
        if train:
            outs = acts[1:] + [probs]
            for gd, x, y in zip(reversed(self.gds), reversed(acts),
                                reversed(outs)):
                err = gd.run(x, err, y)
                done(gd.name)
        self.decision.run()

    def run(self) -> None:
        """Train until the decision unit completes or :meth:`stop` is
        called; after each step on which the decision raised
        ``improved``, fire the snapshotter."""
        if not self.is_initialized:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        self._stop_requested = False
        while not self.decision.complete and not self._stop_requested:
            self.step()
            if self.snapshotter is not None and self.decision.improved:
                self.snapshotter.run()

    def stop(self) -> None:
        """Make :meth:`run` return at the next step boundary."""
        self._stop_requested = True

    # -- state -------------------------------------------------------------
    def _param_units(self):
        return [*self.forwards, *self.gds]

    def state_dict(self) -> dict:
        """The reference's snapshot layout as plain numpy copies (no view
        of a live tensor): per-unit parameters and momentum (f32), the
        loader's schedule, the evaluator's and decision's counters, and
        the host generator."""
        units: dict = {}
        for unit in self._param_units():
            units[unit.name] = {
                name: t.detach().to("cpu", torch.float32,
                                    copy=True).numpy()
                for name, t in [*unit.named_parameters(recurse=False),
                                *unit.named_buffers(recurse=False)]}
        units[self.loader.name] = self.loader.state_dict()
        units[self.evaluator.name] = self.evaluator.state_dict()
        units[self.decision.name] = self.decision.state_dict()
        return {"__units__": units, "__prng__": prng.get().get_state()}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Carry a state across: the reference's ``Workflow.state_dict()``
        (or this class's own).  Reads each unit's parameters and
        momentum accumulators (f32 or bf16 numpy, rounded to this run's
        storage dtype; a missing one raises), the loader's
        ``_shuffle_seed``, ``_shuffled``, ``_cursor`` and
        ``epoch_number``, the evaluator's epoch counters, the decision's
        best errors and epochs without improvement, and the host
        generator.  A loader, evaluator or decision key the state lacks
        keeps its value, as in the reference."""
        by_name = state["__units__"]
        for unit in self._param_units():
            unit_state = by_name.get(unit.name, {})
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]:
                if name not in unit_state:
                    raise KeyError(f"state has no '{unit.name}.{name}'")
                value = np.asarray(unit_state[name]).astype(np.float32)
                if value.shape != tuple(t.shape):
                    raise ValueError(f"{unit.name}.{name}: state shape "
                                     f"{value.shape} != {tuple(t.shape)}")
                t.copy_(torch.from_numpy(value))
        self.loader.load_state(by_name.get(self.loader.name, {}))
        self.evaluator.load_state(by_name.get(self.evaluator.name, {}))
        self.decision.load_state(by_name.get(self.decision.name, {}))
        if "__prng__" in state:
            prng.get().set_state(state["__prng__"])

    #: the name the port's first slices gave :meth:`load_state`
    load_reference_state = load_state

    def export_forward(self, path: str) -> str:
        """Write the trained forward chain as a bundle in the
        reference's format (see :func:`znicz_tpu_torch.export.export_forward`)."""
        from znicz_tpu_torch.export import export_forward
        return export_forward(self, path)
