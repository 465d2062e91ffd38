"""Small auxiliary units (port of ``znicz_tpu/ops/aux_units.py``):
``MultiHistogram``, ``LabelsPrinter`` and ``ChannelSplitter``.

``MultiHistogram`` and ``LabelsPrinter`` are host units: they read what
they show back from the device when they fire, outside the training
step's graph.  ``ChannelSplitter`` is an accelerated unit that runs in
the step's region, so it keeps the region's contract: each group's
output is a tensor allocated at ``initialize`` (an attribute
``out<i>``, ``output`` aliasing group 0) and the step writes into it
(``torch.index_select(..., out=)``), with the group's channel indices
in a device tensor allocated once.  A captured graph replays on those
addresses; the reference rebinds each output every step
(``vec.devmem = x[..., group]``), which a replay would refuse.  The
gather is a torch op, as it is XLA's in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.plotting_units import Plotter, host_value
from znicz_tpu_torch.units import Unit


class MultiHistogram(Plotter):
    """Per-layer weight histograms, one panel per watched tensor,
    published through the graphics service each firing."""

    def __init__(self, workflow, name: str | None = None,
                 n_bins: int = 30, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.n_bins = int(n_bins)
        self._watched: list[tuple[str, object]] = []
        self.histograms: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def watch(self, label: str, source) -> "MultiHistogram":
        """Watch a Vector or a tensor (read when the unit fires)."""
        self._watched.append((label, source))
        return self

    def watch_workflow_weights(self) -> "MultiHistogram":
        for unit in getattr(self.workflow, "forwards", []):
            if getattr(unit, "weights", None) is not None:
                self.watch(unit.name, unit.weights)
        return self

    def make_payload(self) -> dict | None:
        panels = {}
        for label, source in self._watched:
            values = host_value(source)
            if values is None:
                continue
            counts, edges = np.histogram(values.ravel(), bins=self.n_bins)
            self.histograms[label] = (counts, edges)
            panels[label] = counts.tolist()
        return {"kind": "multi_hist", "panels": panels} \
            if panels else None


class LabelsPrinter(Unit):
    """Logs a minibatch's predicted and true labels, with an optional
    index → name mapping.  Wire it after the forward chain."""

    def __init__(self, workflow, name: str | None = None,
                 label_names: dict[int, str] | None = None,
                 limit: int = 10, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.label_names = dict(label_names or {})
        self.limit = int(limit)
        self.max_idx = None          # link from the softmax forward
        self.labels = None           # link from the loader
        self.minibatch_valid = None
        self.lines: list[str] = []   # the last firing's output

    def _name_of(self, idx: int) -> str:
        return self.label_names.get(idx, str(idx))

    def run(self) -> None:
        pred = host_value(self.max_idx)
        truth = host_value(self.labels)
        count = len(truth)
        valid = host_value(self.minibatch_valid)
        if valid is not None:
            count = min(count, int(valid))
        self.lines = []
        for row in range(min(count, self.limit)):
            p, t = int(pred[row]), int(truth[row])
            mark = " " if p == t else "✗"
            self.lines.append(f"{mark} pred={self._name_of(p)} "
                              f"true={self._name_of(t)}")
        self.info("labels:\n%s", "\n".join(self.lines))


class ChannelSplitter(AcceleratedUnit):
    """Splits the input's channel axis (the last) into per-group outputs
    (separate towers a colour plane).  ``groups`` is a list of
    channel-index lists; the outputs are the attributes ``out<i>``,
    listed by :attr:`outputs`, ``output`` aliasing group 0."""

    def __init__(self, workflow, groups, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.groups = [list(map(int, g)) for g in groups]
        if not self.groups:
            raise ValueError("need at least one channel group")
        self.input = None
        for i in range(len(self.groups)):
            setattr(self, f"out{i}", Vector(name=f"{self.name}.out{i}"))

    @property
    def outputs(self) -> list[Vector]:
        return [getattr(self, f"out{i}") for i in range(len(self.groups))]

    @property
    def output(self) -> Vector:
        return self.out0

    def _input_value(self):
        x = self.input
        return x.devmem if isinstance(x, Vector) else x

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        x = self.input
        if x is None or (isinstance(x, Vector) and not x):
            raise AttributeError(f"{self}: input not linked yet")
        shape = tuple(x.shape)
        c = shape[-1]
        for group in self.groups:
            bad = [ch for ch in group if not 0 <= ch < c]
            if bad:
                raise ValueError(f"{self}: channels {bad} out of "
                                 f"range (input has {c})")
        if isinstance(x, Vector):
            x.initialize(self.device)
        base = shape[:-1]
        if self.device.is_host_only:
            for vec, group in zip(self.outputs, self.groups):
                vec.reset(np.zeros(base + (len(group),), dtype=np.float32))
                vec.initialize(self.device)
            return
        # the outputs in the input's dtype and the indices, at addresses
        # kept for good
        xt = self._input_value()
        dev = self.torch_device
        for i, group in enumerate(self.groups):
            setattr(self, f"out{i}", Vector.adopt(
                torch.zeros(base + (len(group),), dtype=xt.dtype,
                            device=dev), f"{self.name}.out{i}"))
            setattr(self, f"index{i}",
                    torch.tensor(group, dtype=torch.int64, device=dev))

    def numpy_run(self) -> None:
        x = host_value(self.input)
        for vec, group in zip(self.outputs, self.groups):
            vec.map_invalidate()
            vec.mem[...] = x[..., group]

    def device_run(self) -> None:
        x = self._input_value()
        for i, vec in enumerate(self.outputs):
            out = vec.devmem
            torch.index_select(x, x.dim() - 1, getattr(self, f"index{i}"),
                               out=out)
            vec.devmem = out  # the device copy counts (no copy: the same)
