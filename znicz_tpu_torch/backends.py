"""Device and dtype resolution (counterpart of ``znicz_tpu/backends.py``).

The reference picks an XLA device (TPU in production) or the numpy
oracle.  The port runs PyTorch on one CUDA device, or on the CPU when
the caller asks for it by name — the CPU is where the tests run the
plain versions of the kernels — or, asked for as ``"numpy"``, runs the
numpy oracle.  A caller that names no device gets the GPU, and an error
when there is none: the port never falls back to the CPU on its own.

:class:`Device` is the counterpart of the reference's ``Device`` on one
device: :meth:`Device.create` gives a :class:`CudaDevice` (the card) or,
asked for by name, a :class:`CpuDevice` or a :class:`NumpyDevice` (the
oracle: every unit's ``numpy_run``, numpy only, f32 whatever
``precision_type`` says); each moves
:class:`~znicz_tpu_torch.memory.Vector` contents with :meth:`Device.put`
and :meth:`Device.get` and waits for queued work with
:meth:`Device.sync`.  Sharding over several cards waits for the
parallel slice (ROADMAP A9).

Numerics stated here, once for the whole package: a float32 matrix
product stays float32 on the card (no TF32), as it is in the
reference, and so does a float32 convolution through cuDNN.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.utils.config import root

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: manifest dtype names → torch dtypes (no ml_dtypes: the card's
#: machine does not have it, and torch carries bfloat16 itself)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a bundle manifest's ``dtype`` string."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype '{name}' (have "
                         f"{sorted(_DTYPES)})") from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises when no GPU is
    present; ``"cpu"`` (or a CPU ``torch.device``) is honoured only
    when asked for; ``"cuda"``/``"cuda:N"`` must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available — pass device='cpu' to "
                "run the plain versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device '{dev}' (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device '{dev}' requested but no CUDA "
                           f"device is available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Device:
    """One device the workflow runs on (the reference's ``Device``).

    ``torch_device`` is the ``torch.device``; :attr:`type` and ``str()``
    are its own, so a caller may read a ``Device`` where
    it read a ``torch.device`` before.  The compute dtype comes from
    ``root.common.precision_type`` and ``precision_level`` from
    ``root.common.precision_level``, as in the reference.  The port runs
    every float32 product in float32 at every level (the numerics
    stated above); the reference's levels pick a ``jax.lax.Precision``
    for the TPU's products, which has no counterpart here, so the level
    is kept and reported, and changes nothing.
    """

    backend = "abstract"
    #: True when there is no device memory apart from the host's (the
    #: numpy oracle): units run ``numpy_run``, a Vector's array is its
    #: buffer
    is_host_only = False

    def __init__(self, device: torch.device) -> None:
        self.torch_device = device
        self.compute_dtype = torch_dtype(
            root.common.get("precision_type", "float32"))
        self.precision_level = int(root.common.get("precision_level", 0))

    @staticmethod
    def create(backend: str | None = None) -> "Device":
        """The device of ``backend``: ``None`` or ``"cuda"`` is the card
        (an error when there is none), ``"cpu"`` the host,
        ``"numpy"`` the numpy oracle, a ``torch.device`` or
        ``"cuda:N"`` that device."""
        if isinstance(backend, Device):
            return backend
        if backend == "numpy":
            return NumpyDevice(torch.device("cpu"))
        dev = resolve_device(None if backend in (None, "cuda") else backend)
        return CudaDevice(dev) if dev.type == "cuda" else CpuDevice(dev)

    @property
    def type(self) -> str:
        return self.torch_device.type

    def __str__(self) -> str:
        return str(self.torch_device)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.torch_device})"

    # -- the transfers Vector makes ---------------------------------------
    def put(self, arr: np.ndarray) -> torch.Tensor:
        """A new device tensor holding a copy of ``arr``."""
        return torch.from_numpy(np.array(arr, copy=True)).to(
            self.torch_device)

    def get(self, tensor: torch.Tensor) -> np.ndarray:
        """A host copy of ``tensor`` (bf16 as float32: numpy has no
        bfloat16)."""
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def sync(self) -> None:
        """Wait for the work queued on the device."""


class CudaDevice(Device):
    """The card."""

    backend = "cuda"

    def sync(self) -> None:
        torch.cuda.synchronize(self.torch_device)


class CpuDevice(Device):
    """The host, asked for by name: the plain versions of the kernels,
    no CUDA graphs."""

    backend = "cpu"


class NumpyDevice(Device):
    """The host oracle (the reference's ``NumpyDevice``): each unit runs
    its ``numpy_run``, copied from the reference's numpy path, with no
    torch operation; state a snapshot carries stays in CPU tensors,
    which the numpy code reads and writes through ``Tensor.numpy()``
    views.  Its compute dtype is f32 whatever ``precision_type`` says,
    as the reference's oracle stores and computes f32."""

    backend = "numpy"
    is_host_only = True

    def __init__(self, device: torch.device) -> None:
        super().__init__(device)
        self.compute_dtype = torch.float32
