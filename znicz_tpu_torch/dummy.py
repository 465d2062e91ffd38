"""Test fixtures (port of ``znicz_tpu/dummy.py``): ``DummyWorkflow`` and
``DummyUnit`` let any unit initialize and run without a CLI, a launcher
or a training loop."""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.backends import Device
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.units import Unit


class DummyWorkflow(AcceleratedWorkflow):
    """A bare workflow container for unit tests; ``device`` is anything
    :meth:`Device.create` takes (``"cpu"``, ``"numpy"``, a
    ``Device``)."""

    def __init__(self, device=None, **kwargs) -> None:
        super().__init__(None, name="dummy", **kwargs)
        if device is not None:
            self.device = Device.create(device)


class DummyUnit(Unit):
    """A unit that exposes the attributes passed to ``__init__``: a
    ``link_attrs`` source."""

    def __init__(self, workflow=None, **attrs) -> None:
        super().__init__(workflow)
        for name, value in attrs.items():
            setattr(self, name, value)


def vector_of(arr, device, name: str = "fixture") -> Vector:
    """A Vector from a numpy array, initialized on ``device``."""
    vec = Vector(np.asarray(arr), name=name)
    vec.initialize(Device.create(device))
    return vec
