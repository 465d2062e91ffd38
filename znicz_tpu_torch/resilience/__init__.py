"""Resilience: deterministic fault injection and the recovery machinery
(port of ``znicz_tpu/resilience``).

- :mod:`~znicz_tpu_torch.resilience.faults`: the seeded fault-injection
  harness; every injection point is a named site gated on
  ``root.common.engine.faults`` (off by default, one lookup when off);
- :mod:`~znicz_tpu_torch.resilience.guard`: the training anomaly guard,
  finite checks and a guarded update inside the training step's CUDA
  graph, the anomaly counts, and the rollback to the last snapshot
  after K anomalous steps in a row;
- :mod:`~znicz_tpu_torch.resilience.integrity`: the SDC sentinel, the
  step fingerprints folded beside the guard, the cross-process vote,
  the shadow audit on the numpy oracle and the quarantine;
- :mod:`~znicz_tpu_torch.resilience.publisher`: the train-to-serve
  handoff, digest-sidecar bundle publication, the serving side's
  :class:`PublicationWatcher` and the :class:`SwapController`'s canary,
  promotion, probation and rollback over the engines' recapture-free
  ``swap_weights``;
- :mod:`~znicz_tpu_torch.resilience.supervisor`: heartbeats, the
  barriered checkpoint on a preemption signal, the hang watchdog and
  the :class:`ElasticSupervisor` that restarts a gang on its survivors
  from the newest good snapshot
  (:mod:`~znicz_tpu_torch.resilience.elastic_worker` is its drill
  worker).

The serving deadline/retry/breaker path lives in
:mod:`znicz_tpu_torch.serving`, snapshot retention and digest-checked
loads in :mod:`znicz_tpu_torch.utils.snapshotter`.
"""

from znicz_tpu_torch.resilience.faults import (  # noqa: F401
    SITES,
    FaultInjected,
    FaultPlan,
    fire,
)
from znicz_tpu_torch.resilience.publisher import (  # noqa: F401
    PublicationWatcher,
    SwapController,
    WeightPublisher,
    classifier_score,
    publish_bundle,
)
from znicz_tpu_torch.resilience.supervisor import (  # noqa: F401
    EXIT_PEER_LOST,
    EXIT_PREEMPTED,
    ElasticSupervisor,
    HeartbeatMonitor,
    HeartbeatWriter,
    PeerLost,
    Preempted,
    WorkerSupervisor,
    newest_good_snapshot,
)
