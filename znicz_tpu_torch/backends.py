"""Device and dtype resolution (counterpart of ``znicz_tpu/backends.py``).

The reference picks an XLA device (TPU in production) or the numpy
oracle.  The port runs PyTorch on one CUDA device, or on the CPU when
the caller asks for it by name — the CPU is where the tests run the
plain versions of the kernels.  A caller that names no device gets the
GPU, and an error when there is none: the port never falls back to
the CPU on its own.

Numerics stated here, once for the whole package: a float32 matrix
product stays float32 on the card (no TF32), as it is in the
reference, and so does a float32 convolution through cuDNN.
"""

from __future__ import annotations

import torch

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
