"""Global configuration tree (copy of ``znicz_tpu/utils/config.py``).

A global ``root`` object whose intermediate nodes auto-vivify on
attribute access (``root.common.engine.telemetry = False``), as in the
reference's ``veles/config.py``.  The port keeps the platform subtree
it reads (telemetry, the precision mode, the seed, the directories);
each sample registers its defaults under ``root.<sample>``
(:func:`register_defaults`), where the CLI's ``--root`` overrides and a
config module find them.

``root.common.dirs.datasets`` is the reference's own directory, so both
packages read the same dataset files; ``root.common.dirs.snapshots`` is
the port's (the snapshot format is the reference's, and a file loads
in either package), and so is ``root.common.dirs.images`` (where
``ImageSaver`` writes).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterator


class Config:
    """A node in the attribute tree.  Leaves are ordinary values."""

    __slots__ = ("__dict__", "_path")

    def __init__(self, path: str = "root", **leaves: Any) -> None:
        object.__setattr__(self, "_path", path)
        for name, value in leaves.items():
            setattr(self, name, value)

    @property
    def path(self) -> str:
        return self._path

    def __getattr__(self, name: str) -> "Config":
        # Only called when normal lookup fails: auto-vivify a child node.
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config(f"{self._path}.{name}")
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict):
            node = Config(f"{self._path}.{name}")
            node.update(value)
            value = node
        self.__dict__[name] = value

    def update(self, tree: dict) -> "Config":
        """Recursively merge a plain-dict tree into this node."""
        for name, value in tree.items():
            if isinstance(value, dict):
                existing = self.__dict__.get(name)
                if isinstance(existing, Config):
                    existing.update(value)
                else:
                    setattr(self, name, value)
            else:
                setattr(self, name, value)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        """Read a leaf without vivifying it."""
        return self.__dict__.get(name, default)

    def as_dict(self) -> dict:
        out: dict = {}
        for name, value in self.__dict__.items():
            out[name] = value.as_dict() if isinstance(value, Config) else value
        return out

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self.__dict__.items())

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def __repr__(self) -> str:
        return f"Config({self._path}: {sorted(self.__dict__)})"


def _default_root() -> Config:
    r = Config("root")
    r.common.engine.telemetry = True
    r.common.precision_type = "float32"  # "bfloat16" | "float32"
    r.common.seed = 1234
    r.common.dirs.cache = os.path.expanduser("~/.cache/znicz_tpu_torch")
    r.common.dirs.snapshots = os.path.expanduser(
        "~/.cache/znicz_tpu_torch/snapshots")
    r.common.dirs.datasets = os.path.expanduser(
        "~/.cache/znicz_tpu/datasets")
    r.common.dirs.images = os.path.expanduser(
        "~/.cache/znicz_tpu_torch/images")
    r.common.dirs.plots = os.path.expanduser(
        "~/.cache/znicz_tpu_torch/plots")
    r.common.graphics.render = True       # draw PNGs in the render thread
    r.common.graphics.publish_port = None  # zmq PUB port for live clients
    return r


#: The global configuration tree.
root = _default_root()

#: sample-default subtrees re-applied on reset (name → dict)
_registered_defaults: dict[str, dict] = {}


def _merge_defaults(node: Config, defaults: dict) -> None:
    """Fill missing leaves only: an explicit setting wins over a
    default."""
    for key, value in defaults.items():
        if isinstance(value, dict):
            child = node.__dict__.get(key)
            if child is None:
                child = getattr(node, key)  # vivify an empty subtree
            if isinstance(child, Config):
                _merge_defaults(child, value)
        elif key not in node.__dict__:
            setattr(node, key, copy.deepcopy(value))


def register_defaults(name: str, defaults: dict) -> None:
    """Register a sample's default subtree under ``root.<name>``.

    Samples call this when imported; the defaults survive
    :func:`reset_root`, and never overwrite a leaf already set (by a
    config module or a ``--root`` override), so the order in which a
    sample and its configuration are imported does not matter."""
    _registered_defaults[name] = copy.deepcopy(defaults)
    _merge_defaults(getattr(root, name), defaults)


def reset_root() -> None:
    """Restore ``root`` to the platform and registered sample defaults
    (used by tests)."""
    fresh = _default_root()
    root.__dict__.clear()
    root.__dict__.update(fresh.__dict__)
    for name, defaults in _registered_defaults.items():
        _merge_defaults(getattr(root, name), defaults)
