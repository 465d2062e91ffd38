"""Vector: the host↔device buffer pair (port of ``znicz_tpu/memory.py``).

``devmem`` is a tensor on the workflow's device and ``mem`` a host
numpy mirror made on demand.  The map/unmap state machine is the
reference's, as are its names: ``map_read`` fetches the device copy to
the host, ``map_write`` does too and makes the host copy the one that
counts, ``map_invalidate`` does the same without the fetch (the host
will overwrite everything), ``unmap`` makes the device copy current.
Reading ``mem`` while the device copy counts, or ``devmem`` while the
host copy does, raises: the reference's stand-in for a race detector.

One rule is the port's own: **a write keeps the device tensor's
address.**  Once a Vector has a device tensor, ``unmap`` after a host
write and a write through the ``devmem`` setter copy into that tensor
(``copy_``) and never bind a new one.  A captured CUDA graph reads and
writes fixed addresses, so a host write that bound a new tensor would
never reach the graph (see :mod:`znicz_tpu_torch.accelerated_units`).
Only a write of another shape binds a new tensor.

numpy has no bfloat16, so a bf16 tensor's host mirror is float32; a
host write is rounded to bf16 when it reaches the device.

The streaming data plane's delivery keeps that rule too:
:meth:`Vector.accept_device` copies a batch already on the device into
the Vector's tensor (the reference swaps the pointer, which a replay
would refuse), and :class:`StagingRing` is the bounded pool of host
buffers (pinned on the card) its readers fill.

On a host-only device (the numpy oracle,
:class:`~znicz_tpu_torch.backends.NumpyDevice`) the host array is the
buffer, as in the reference: ``unmap`` uploads nothing, ``devmem`` is
the host array, and a write through the ``devmem`` setter goes into it.
"""

from __future__ import annotations

import enum
import queue
from typing import TYPE_CHECKING

import numpy as np
import torch

from znicz_tpu_torch.observe import metrics as _metrics

if TYPE_CHECKING:  # pragma: no cover
    from znicz_tpu_torch.backends import Device


def _count_transfer(direction: str, nbytes: int) -> None:
    """Host↔device bytes through the map/unmap protocol, the one place
    where the transfer volume is known (gated on telemetry)."""
    if _metrics.enabled():
        _metrics.transfer_bytes(direction).inc(nbytes)


class _State(enum.Enum):
    EMPTY = 0     #: no storage yet
    HOST = 1      #: the host copy counts; the device copy is stale
    DEVICE = 2    #: the device copy counts; the host copy is stale
    SYNCED = 3    #: both copies hold the same values


class Vector:
    """A device buffer with a host mirror and explicit sync points."""

    __slots__ = ("_mem", "_devmem", "_state", "_device", "_tracing", "name")

    def __init__(self, mem: np.ndarray | None = None, name: str = "") -> None:
        self._mem: np.ndarray | None = None
        self._devmem: torch.Tensor | None = None
        self._state = _State.EMPTY
        self._device: "Device | None" = None
        #: True while a region captures its graph: a host sync there
        #: would break the capture, so it raises
        self._tracing = False
        self.name = name
        if mem is not None:
            self.reset(mem)

    @classmethod
    def adopt(cls, tensor: torch.Tensor, name: str = "") -> "Vector":
        """A Vector over an existing device tensor (the same storage:
        ``unmap`` after a host write copies into ``tensor``)."""
        from znicz_tpu_torch.backends import Device
        vec = cls(name=name)
        vec._device = Device.create(tensor.device)
        vec._devmem = tensor.detach()
        vec._state = _State.DEVICE
        return vec

    # -- allocation ---------------------------------------------------------
    def reset(self, mem: np.ndarray | None) -> None:
        """(Re)bind the host contents; the device copy is stale.  The
        device tensor is kept, so the next ``unmap`` copies into it."""
        self._check_not_tracing("reset")
        if mem is None:
            self._mem = None
            self._devmem = None
            self._state = _State.EMPTY
            return
        self._mem = np.ascontiguousarray(mem) if np.ndim(mem) else \
            np.array(mem)
        self._state = _State.HOST

    def assign(self, mem: np.ndarray) -> None:
        """A host value that reaches the device at once, in place when the
        shape holds (a snapshot's value on resume)."""
        self.reset(mem)
        if self._device is not None:
            self.unmap()

    def initialize(self, device: "Device") -> None:
        """Attach to a device and upload the host copy (the reference's
        ``Vector.initialize``, from ``AcceleratedUnit.init_vectors``)."""
        self._check_not_tracing("initialize")
        self._device = device
        if device.is_host_only:
            return
        if self._state == _State.HOST:
            self._upload()
            self._state = _State.SYNCED

    # -- the map/unmap protocol -----------------------------------------------
    def map_read(self) -> None:
        """Make the host copy current for reading."""
        self._check_not_tracing("map_read")
        if self._state == _State.EMPTY:
            raise ValueError(f"Vector '{self.name}': map_read on empty buffer")
        if self._state == _State.DEVICE:
            self._mem = self._device.get(self._devmem)
            _count_transfer("d2h", self._mem.nbytes)
            self._state = _State.SYNCED

    def map_write(self) -> None:
        """Make the host copy current and the one that counts."""
        self.map_read()
        self._state = _State.HOST

    def map_invalidate(self) -> None:
        """The host will overwrite everything: skip the fetch."""
        self._check_not_tracing("map_invalidate")
        if self._state == _State.EMPTY:
            raise ValueError(
                f"Vector '{self.name}': map_invalidate on empty buffer")
        if self._mem is None:
            self._mem = np.empty(tuple(self._devmem.shape),
                                 dtype=_host_dtype(self._devmem.dtype))
        self._state = _State.HOST

    def unmap(self) -> None:
        """Make the device copy current (copy the host copy into the
        device tensor when the host wrote it)."""
        self._check_not_tracing("unmap")
        if self._state == _State.EMPTY:
            raise ValueError(f"Vector '{self.name}': unmap on empty buffer")
        if self._device is None or self._device.is_host_only:
            return
        if self._state == _State.HOST:
            self._upload()
        self._state = _State.DEVICE

    def _upload(self) -> None:
        mem = self._mem
        dev = self._devmem
        if dev is not None and tuple(dev.shape) == mem.shape:
            dev.copy_(torch.from_numpy(np.asarray(mem, order="C")))
        else:
            self._devmem = self._device.put(mem)
        _count_transfer("h2d", mem.nbytes)

    # -- storage access ---------------------------------------------------------
    @property
    def mem(self) -> np.ndarray:
        """The host array; the caller holds a map_read or map_write."""
        if self._state == _State.DEVICE:
            raise ValueError(
                f"Vector '{self.name}': host access while the device copy "
                f"counts — call map_read()/map_write() first")
        if self._mem is None:
            raise ValueError(f"Vector '{self.name}': no storage")
        return self._mem

    @mem.setter
    def mem(self, value: np.ndarray) -> None:
        self.reset(value)

    @property
    def devmem(self) -> torch.Tensor:
        """The device tensor (the host array on a host-only device)."""
        if self._host_only:
            return self.mem
        if self._state == _State.HOST and not self._tracing:
            raise ValueError(
                f"Vector '{self.name}': device access while the host copy "
                f"counts — call unmap() first")
        if self._devmem is None:
            raise ValueError(f"Vector '{self.name}': not initialized on a "
                             f"device")
        return self._devmem

    @devmem.setter
    def devmem(self, value: torch.Tensor) -> None:
        """A result of device compute: copied into the device tensor when
        the shape holds (its address is kept; a float value is cast to
        the tensor's dtype), else bound as the device tensor.  On a
        host-only device the value (an array) goes into the host array
        in the same way."""
        if self._host_only:
            mem = self._mem
            if mem is not None and mem.shape == np.shape(value):
                mem[...] = value
            else:
                self._mem = np.array(value)
            self._state = _State.HOST
            return
        dev = self._devmem
        if dev is not None and tuple(dev.shape) == tuple(value.shape) \
                and (dev.dtype == value.dtype
                     or (dev.is_floating_point()
                         and value.is_floating_point())):
            if value is not dev:
                dev.copy_(value)
        else:
            self._devmem = value
        self._state = _State.DEVICE

    def accept_device(self, value) -> None:
        """Take a batch that is already on the device as this step's
        contents: the streaming loaders' delivery.  The batch is copied
        into the Vector's tensor (one device-to-device copy on the
        current stream), so the address a captured graph reads is kept;
        the reference swaps the pointer instead.  Shape and dtype must
        be the declared ones.  On a host-only device ``value`` (an array
        or a CPU tensor) is copied into the host array."""
        self._check_not_tracing("accept_device")
        if self._state == _State.EMPTY:
            raise ValueError(
                f"Vector '{self.name}': accept_device on empty buffer")
        if self._host_only:
            mem = self._mem
            src = value.numpy() if isinstance(value, torch.Tensor) \
                else np.asarray(value)
            if src.shape != mem.shape or src.dtype != mem.dtype:
                raise ValueError(
                    f"Vector '{self.name}': accept_device {src.shape}/"
                    f"{src.dtype} does not match the declared "
                    f"{mem.shape}/{mem.dtype}")
            mem[...] = src
            self._state = _State.HOST
            return
        dev = self._devmem
        if tuple(value.shape) != tuple(dev.shape) \
                or value.dtype != dev.dtype:
            raise ValueError(
                f"Vector '{self.name}': accept_device "
                f"{tuple(value.shape)}/{value.dtype} does not match the "
                f"declared {tuple(dev.shape)}/{dev.dtype}")
        dev.copy_(value, non_blocking=True)
        self._state = _State.DEVICE

    @property
    def _host_only(self) -> bool:
        return self._device is not None and self._device.is_host_only

    @property
    def state_name(self) -> str:
        return self._state.name

    # -- conveniences ------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        if self._devmem is not None:
            return tuple(self._devmem.shape)
        if self._mem is not None:
            return tuple(self._mem.shape)
        raise ValueError(f"Vector '{self.name}': no storage")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self else 0

    @property
    def sample_size(self) -> int:
        """Elements a sample (all dims but the first)."""
        shape = self.shape
        return int(np.prod(shape[1:])) if len(shape) > 1 else 1

    def __bool__(self) -> bool:
        return self._state != _State.EMPTY

    def __len__(self) -> int:
        return self.shape[0] if self else 0

    def __repr__(self) -> str:
        if not self:
            return f"Vector('{self.name}', empty)"
        return f"Vector('{self.name}', {self.shape}, {self._state.name})"

    def _check_not_tracing(self, op: str) -> None:
        if self._tracing:
            raise RuntimeError(
                f"Vector '{self.name}': {op}() inside a region capture — "
                f"a host sync cannot be captured; move the work out of "
                f"the region or keep the state on the device")


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def host_buffer(shape: tuple[int, ...], dtype, pin: bool
                ) -> tuple[torch.Tensor, np.ndarray]:
    """A zeroed host buffer as ``(tensor, numpy view of it)``, in
    page-locked memory when ``pin`` (a copy from it to the card is then
    asynchronous)."""
    t = torch.zeros(shape, dtype=torch.from_numpy(
        np.zeros(0, dtype=dtype)).dtype, pin_memory=pin)
    return t, t.numpy()


class StagingRing:
    """A bounded ring of reusable host staging buffers: the streaming
    loader's slot pool (port of the reference's ``StagingRing``).

    Readers :meth:`acquire` a free slot, fill its buffer and hand the
    index on; whoever is done with the contents (the uploader once its
    copy to the device has completed) :meth:`release`\\ s it.  The bound
    is the back-pressure: a stalled consumer blocks the readers at
    ``acquire``, so the host memory stays ``n_slots × batch bytes``
    however large the dataset.  Every buffer is allocated once, here
    (page-locked when ``pin``: the card's copies from it are then
    asynchronous); the steady state allocates nothing.  Thread-safe.
    """

    def __init__(self, n_slots: int, shape: tuple[int, ...], dtype,
                 pin: bool = False) -> None:
        if n_slots < 1:
            raise ValueError(f"StagingRing needs >= 1 slot, got {n_slots}")
        self.pinned = bool(pin)
        slots = [host_buffer(shape, dtype, pin) for _ in range(n_slots)]
        self._tensors = [t for t, _ in slots]
        self._bufs = [b for _, b in slots]
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(n_slots):
            self._free.put(i)

    @property
    def n_slots(self) -> int:
        return len(self._bufs)

    @property
    def n_free(self) -> int:
        return self._free.qsize()

    @property
    def nbytes(self) -> int:
        """Host bytes the ring holds."""
        return sum(b.nbytes for b in self._bufs)

    def buffer(self, slot: int) -> np.ndarray:
        """The slot's buffer, which the readers fill."""
        return self._bufs[slot]

    def tensor(self, slot: int) -> torch.Tensor:
        """The slot's buffer as the tensor the uploader copies from."""
        return self._tensors[slot]

    def acquire(self, timeout: float | None = None) -> int | None:
        """The next free slot; blocks (up to ``timeout``) while every
        slot is downstream, and gives ``None`` on the timeout so that a
        pipeline thread can check its stop flag instead of hanging."""
        try:
            return self._free.get(timeout=timeout)
        except queue.Empty:
            return None

    def release(self, slot: int) -> None:
        self._free.put(slot)
