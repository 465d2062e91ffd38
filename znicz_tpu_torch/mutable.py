"""Shared mutable flags and linkable attributes (port of
``znicz_tpu/mutable.py``, copied: it depends on nothing of JAX or of
the reference's package, and the port keeps its own copy).

Units gate on :class:`Bool` objects that other units mutate, and
derived booleans (``~a``, ``a & b``, ``a | b``) let a gate follow
another flag without copying it.  These are host-side control-plane
objects: they decide which units run between device steps.  A
condition that changes from minibatch to minibatch inside the hot
chain is part of the region's key instead (see
:mod:`znicz_tpu_torch.accelerated_units`).
"""

from __future__ import annotations

from typing import Callable


class Bool:
    """A shared mutable boolean.

    Units hold references to the same ``Bool``, so one unit flipping it
    (``flag << True``) is seen by every gate that watches it.  Deriving
    (``~a``, ``a & b``, ``a | b``) gives a live view that is evaluated
    again on every read.
    """

    __slots__ = ("_value", "_expr", "on_true")

    def __init__(self, value: bool = False) -> None:
        self._value = bool(value)
        self._expr: Callable[[], bool] | None = None
        #: callbacks fired when the flag turns True
        self.on_true: list[Callable[[], None]] = []

    @classmethod
    def _derived(cls, expr: Callable[[], bool]) -> "Bool":
        b = cls()
        b._expr = expr
        return b

    @property
    def value(self) -> bool:
        if self._expr is not None:
            return self._expr()
        return self._value

    @value.setter
    def value(self, v: bool) -> None:
        if self._expr is not None:
            raise ValueError("cannot assign to a derived Bool")
        was = self._value
        self._value = bool(v)
        if self._value and not was:
            for cb in self.on_true:
                cb()

    def __lshift__(self, v: bool) -> "Bool":
        """``flag << True``: assignment in place."""
        self.value = v
        return self

    def __bool__(self) -> bool:
        return self.value

    def __invert__(self) -> "Bool":
        return Bool._derived(lambda: not self.value)

    def __and__(self, other: "Bool") -> "Bool":
        return Bool._derived(lambda: self.value and bool(other))

    def __or__(self, other: "Bool") -> "Bool":
        return Bool._derived(lambda: self.value or bool(other))

    def __repr__(self) -> str:
        kind = "derived" if self._expr is not None else "plain"
        return f"Bool({self.value}, {kind})"


class LinkableAttribute:
    """An attribute aliased from another object.

    ``b.link_attrs(a, ("input", "output"))`` makes ``b.input`` a live
    alias of ``a.output``: reads and writes of ``b.input`` go to ``a``.
    Kept in the owner's ``_linked_attrs`` table and resolved by
    :meth:`znicz_tpu_torch.units.Unit.__getattr__` and ``__setattr__``.
    """

    __slots__ = ("source", "source_name", "two_way")

    def __init__(self, source: object, source_name: str,
                 two_way: bool = True) -> None:
        self.source = source
        self.source_name = source_name
        self.two_way = two_way

    def get(self):
        return getattr(self.source, self.source_name)

    def set(self, value) -> None:
        if not self.two_way:
            raise AttributeError(
                f"attribute is linked one-way from "
                f"{type(self.source).__name__}.{self.source_name}")
        setattr(self.source, self.source_name, value)
