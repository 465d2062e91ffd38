"""Resilience: deterministic fault injection (port of the part of
``znicz_tpu/resilience`` the ported modules use).

:mod:`znicz_tpu_torch.resilience.faults` is the seeded fault-injection
harness: every injection point is a named site gated on
``root.common.engine.faults`` (off by default, one lookup when off).
The serving deadline/retry/breaker path lives in
:mod:`znicz_tpu_torch.serving`, snapshot retention and digest-checked
loads in :mod:`znicz_tpu_torch.utils.snapshotter`.  The anomaly guard,
the supervisor and the publisher wait for ROADMAP A11.
"""

from znicz_tpu_torch.resilience.faults import (  # noqa: F401
    SITES,
    FaultInjected,
    FaultPlan,
    fire,
)
