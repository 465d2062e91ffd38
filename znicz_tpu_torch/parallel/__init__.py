"""Parallelism: the device mesh, data parallelism with ZeRO-1, tensor
parallelism, the ring, the temporal pipeline and the multi-process
bring-up (port of ``znicz_tpu/parallel``).

The reference runs synchronous SPMD over a ``jax.sharding.Mesh`` in
place of Veles's ZeroMQ master–slave parameter server, and GSPMD inserts
its collectives.  The port runs one process a device
(``torch.distributed``: NCCL on the card, gloo on the CPU) and writes
each collective out where the reference's placement implies it: the
gradient fold over ``data``, Megatron's column→row pair over ``model``,
the ring's rotation over ``seq``, ZeRO-1's reduce-scatter and
all-gather.
"""

from znicz_tpu_torch.parallel.axis import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    current_data_axis,
    data_axis,
    maybe_pmean,
    maybe_psum,
)
from znicz_tpu_torch.parallel.distributed import (  # noqa: F401
    ensure_initialized,
)
from znicz_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_for_stage,
    shard_shape,
    spec_divides,
    zero1_choice,
    zero1_partition,
)
