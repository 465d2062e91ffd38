"""znicz_tpu_torch — the PyTorch/CUDA port of znicz_tpu for NVIDIA Hopper.

The JAX package ``znicz_tpu`` beside it is the reference: every module
here keeps the reference's module name where that helps a reader find
its counterpart, and the tests hold each one to it on the CPU.  The
port imports ``torch`` and never ``jax`` or ``znicz_tpu``; the
host-only code it needs is copied, not imported.

Every kernel the reference wrote in Pallas for the TPU is a CUDA C++
kernel here (``csrc/``), built with ``nvcc`` for ``sm_90a`` on first
use (:mod:`znicz_tpu_torch.ops._cuda`).  Each kernel's wrapper runs a
plain PyTorch version of the same function for tensors on the CPU
only; a CUDA tensor gets the kernel or an error.

Entry points (:class:`~znicz_tpu_torch.export.ExportedModel`,
:class:`~znicz_tpu_torch.serving.ServingEngine`,
:meth:`StandardWorkflow.initialize
<znicz_tpu_torch.models.standard_workflow.StandardWorkflow.initialize>`)
run on ``cuda`` and raise when no GPU is present, unless the caller
passes ``device="cpu"``.

This package import is deliberately light: it pulls in nothing, not
even torch, until a submodule is imported.
"""

__version__ = "0.1.0"
