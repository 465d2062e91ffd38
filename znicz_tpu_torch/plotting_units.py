"""Plotter units: workflow nodes that feed the graphics service (port of
``znicz_tpu/plotting_units.py``): ``Plotter``, ``AccumulatingPlotter``,
``MatrixPlotter`` and ``ImagePlotter``, with the reference's unit API.

Every plotter is a host unit on the epoch side chain
(``plotter.link_from(decision)`` with ``gate_skip`` following
``not decision.epoch_ended``; ``StandardWorkflow.link_*_plotter`` wires
them so).  So it fires after the decision, when the training step's
graph has run, and never enters the step's region: it reads the device
tensors it plots back to the host (:func:`host_value`: a
:class:`~znicz_tpu_torch.memory.Vector`'s ``map_read``, a tensor's copy)
and binds nothing the graph reads, so a replay finds every address it
captured and nothing is captured again.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from znicz_tpu_torch import graphics
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.ops.nn_units import to_host
from znicz_tpu_torch.units import Unit


def host_value(src) -> np.ndarray | None:
    """A plotted source on the host: None for None or an empty Vector, a
    Vector or a tensor read back (bf16 as f32), anything else as an
    array."""
    if src is None or (isinstance(src, Vector) and not src):
        return None
    if isinstance(src, (Vector, torch.Tensor)):
        return np.array(to_host(src))
    return np.asarray(src)


class Plotter(Unit):
    """Base plotter: resolves the graphics server, counts steps."""

    def __init__(self, workflow, name: str | None = None,
                 server: "graphics.GraphicsServer | None" = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self._server = server
        self.step = 0

    @property
    def server(self) -> "graphics.GraphicsServer":
        if self._server is None:
            self._server = graphics.get_server()
        return self._server

    def make_payload(self) -> dict | None:
        raise NotImplementedError

    def run(self) -> None:
        payload = self.make_payload()
        if payload is None:
            return
        payload.setdefault("name", self.name)
        payload.setdefault("step", self.step)
        self.server.submit(payload)
        self.step += 1


class AccumulatingPlotter(Plotter):
    """Accumulates scalar series over time and plots them as curves (the
    error curves of each class).

    Add series with :meth:`add_series`: each is a label and a callable
    returning the current scalar (or ``None`` to skip the point this
    firing).
    """

    SNAPSHOT_ATTRS = ("values", "step")

    def __init__(self, workflow, name: str | None = None,
                 ylabel: str = "", **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.ylabel = ylabel
        self._series: list[tuple[str, Callable[[], float | None]]] = []
        self.values: dict[str, list[list[float]]] = {}

    def add_series(self, label: str,
                   fetch: Callable[[], float | None]) -> None:
        self._series.append((label, fetch))
        self.values.setdefault(label, [[], []])

    def make_payload(self) -> dict | None:
        for label, fetch in self._series:
            value = fetch()
            if value is None:
                continue
            xs, ys = self.values.setdefault(label, [[], []])
            xs.append(float(self.step))
            ys.append(float(value))
        if not any(xs for xs, _ in self.values.values()):
            return None
        return {"kind": "curve", "ylabel": self.ylabel,
                "series": {k: [list(xs), list(ys)]
                           for k, (xs, ys) in self.values.items() if xs}}


class MatrixPlotter(Plotter):
    """Plots a matrix (the confusion matrix) as a heatmap with its cell
    values."""

    def __init__(self, workflow, name: str | None = None,
                 fetch: Callable[[], np.ndarray | None] | None = None,
                 labels=None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.fetch = fetch
        self.labels = labels
        self.input = None  # or a Vector, tensor or array attribute

    def _matrix(self) -> np.ndarray | None:
        if self.fetch is not None:
            return self.fetch()
        return host_value(self.input)

    def make_payload(self) -> dict | None:
        m = self._matrix()
        if m is None:
            return None
        return {"kind": "matrix", "data": np.asarray(m),
                "labels": self.labels}


class ImagePlotter(Plotter):
    """Plots one 2-D array (or the first sample of a batch) as an
    image."""

    def __init__(self, workflow, name: str | None = None,
                 fetch: Callable[[], np.ndarray | None] | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.fetch = fetch
        self.input = None

    def make_payload(self) -> dict | None:
        img = self.fetch() if self.fetch is not None \
            else host_value(self.input)
        if img is None:
            return None
        img = np.asarray(img)
        while img.ndim > 2 and img.shape[-1] not in (1, 3):
            img = img[0]
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        return {"kind": "image", "data": img}
