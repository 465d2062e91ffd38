"""Elastic drill worker: one gang member of a supervised streaming run
(port of ``znicz_tpu/resilience/elastic_worker.py``).

Run as ``python -m znicz_tpu_torch.resilience.elastic_worker <out.json>
<shard_dir>`` under the
:class:`~znicz_tpu_torch.resilience.supervisor.ElasticSupervisor`'s
environment contract (``ZNICZ_COORDINATOR``, ``ZNICZ_NUM_PROCESSES``,
``ZNICZ_PROCESS_ID``, ``ZNICZ_HEARTBEAT_DIR``, ``ZNICZ_RESUME_SNAPSHOT``,
``ZNICZ_ELASTIC_ATTEMPT``).  Each process:

1. boots the :class:`~znicz_tpu_torch.launcher.Launcher` on its card
   (NCCL, one card a process), or on the CPU (gloo) when
   ``ZNICZ_ELASTIC_PLATFORM=cpu`` asks for it: the environment contract
   starts the process group, stages the resume snapshot and attaches the
   :class:`~znicz_tpu_torch.resilience.supervisor.WorkerSupervisor`;
2. trains a small streaming MLP (each process reads its block of the
   rows, ZeRO-1 over the data axis when there are several, a snapshot
   at every epoch's end, under a name of its own);
3. writes a JSON digest: the sha256 of the weights' bytes, the resume
   position, the captures one more step made, the mesh, what the drills
   compare.

Drills ride the fault recipe in ``ZNICZ_ELASTIC_FAULTS`` (the
``host.loss``, ``host.preempt``, ``heartbeat.stall`` and
``checkpoint.signal_corrupt`` sites), which the supervisor exports on
its first attempt only.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys


def build_workflow(shard_dir: str, snapshot_dir: str,
                   minibatch_size: int = 16, max_epochs: int = 6):
    """The streaming 2-layer MLP over the drill's shards (the
    reference's)."""
    from znicz_tpu_torch.loader.streaming import StreamingLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.mutable import Bool

    wf = StandardWorkflow(
        name="elastic_mlp",
        loader_factory=lambda w: StreamingLoader(
            w, shard_dir, minibatch_size=minibatch_size, prefetch_depth=2,
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": 16, "weights_filling": "he"},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax",
             "->": {"output_sample_shape": 4, "weights_filling": "he"},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        ],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 10 ** 6},
        snapshotter_config={"prefix": "elastic",
                            "directory": snapshot_dir,
                            "keep_last": 10})
    wf._max_fires = 10 ** 6
    # a snapshot at every epoch's end, each under a name of its own (a
    # best-error name would overwrite the file a parity run restores)
    decision = wf.decision
    wf.snapshotter.gate_skip = Bool._derived(
        lambda: not decision.epoch_ended)
    wf.snapshotter.snapshot_suffix = (
        lambda: f"ep{int(wf.loader.epoch_number):03d}")
    return wf


def main() -> None:
    out_path = sys.argv[1]
    shard_dir = sys.argv[2]
    snapshot_dir = os.environ.get(
        "ZNICZ_ELASTIC_SNAPSHOT_DIR",
        os.path.join(os.path.dirname(out_path), "snapshots"))
    minibatch = int(os.environ.get("ZNICZ_ELASTIC_BATCH", "16"))
    max_epochs = int(os.environ.get("ZNICZ_ELASTIC_EPOCHS", "6"))
    platform = os.environ.get("ZNICZ_ELASTIC_PLATFORM", "cuda")

    import numpy as np
    import torch

    from znicz_tpu_torch.launcher import Launcher
    from znicz_tpu_torch.observe import metrics as obs_metrics
    from znicz_tpu_torch.parallel.distributed import process_info
    from znicz_tpu_torch.resilience import faults as _faults
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root

    faults_json = os.environ.get("ZNICZ_ELASTIC_FAULTS")
    if faults_json:
        root.common.engine.faults = json.loads(faults_json)
    for env, knob, cast in (
            ("ZNICZ_COLLECTIVE_TIMEOUT_S", "collective_timeout_s", float),
            ("ZNICZ_HEARTBEAT_INTERVAL_S", "heartbeat_interval_s", float),
            ("ZNICZ_HEARTBEAT_TIMEOUT_S", "heartbeat_timeout_s", float),
            ("ZNICZ_PREEMPT_BARRIER_STEPS", "preempt_barrier_steps", int),
            ("ZNICZ_SDC_VOTE_INTERVAL", "sdc_vote_interval", int),
            ("ZNICZ_SDC_SUSPECT_THRESHOLD", "sdc_suspect_threshold", int),
            ("ZNICZ_ZERO1", "zero1", lambda v: bool(int(v)))):
        val = os.environ.get(env)
        if val:
            setattr(root.common.engine, knob, cast(val))

    # the environment contract starts the process group, stages the
    # resume snapshot and attaches the supervisor
    launcher = Launcher(backend="cpu" if platform == "cpu" else None)
    prng.seed_all(1234)

    def run(load, main_fn):  # the sample protocol
        load(build_workflow, shard_dir=shard_dir, snapshot_dir=snapshot_dir,
             minibatch_size=minibatch, max_epochs=max_epochs)
        main_fn()

    wf = launcher.boot(run)  # Preempted (SystemExit 75) propagates

    # -- the digest the drills compare ------------------------------------
    loader = wf.loader
    region_unit = wf._region_unit
    warmed_delta = -1
    if region_unit is not None:
        captures = obs_metrics.graph_captures(region_unit.name)
        before = captures.value
        loader.run()        # in lockstep on every process: one more
        region_unit.run()   # step must capture nothing
        warmed_delta = int(captures.value - before)
    loader.stop()

    sha = hashlib.sha256()
    sums = []
    for fwd in wf.forwards:
        for name in ("weights", "bias"):
            t = getattr(fwd, name, None)
            if t is None:
                continue
            arr = np.ascontiguousarray(
                t.detach().to("cpu", torch.float32).numpy())
            sha.update(arr.tobytes())
            sums.append(float(np.asarray(arr, dtype=np.float64).sum()))
    pidx, pcount = process_info()
    plan = _faults.active()
    guard = wf.anomaly_guard
    fp = None if guard is None else guard.read_sdc_fingerprint()
    mesh = wf.device.mesh
    digest = {
        "process_id": int(pidx),
        "n_processes": int(pcount),
        "faults_injected": dict(plan.counts()) if plan else {},
        "sdc_fingerprint": None if fp is None else [float(v) for v in fp],
        "anomaly_state": None if guard is None else list(guard.read_state()),
        "attempt": int(os.environ.get("ZNICZ_ELASTIC_ATTEMPT", "0")),
        "resumed_from": os.environ.get("ZNICZ_RESUME_SNAPSHOT") or None,
        "weights_sha256": sha.hexdigest(),
        "weight_sums": sums,
        "min_validation_n_err": int(wf.decision.min_validation_n_err),
        "epochs_done": int(loader.epoch_number),
        "warmed_step_captures": warmed_delta,
        "local_batch": int(loader.local_batch),
        "mesh": None if mesh is None else dict(mesh.shape),
        "device": str(wf.device.torch_device),
        "snapshot_destination": (wf.snapshotter.destination
                                 if wf.snapshotter else None),
    }
    with open(out_path, "w") as fh:
        json.dump(digest, fh)
    print(f"elastic worker {digest['process_id']}: OK (mesh="
          f"{digest['mesh']}, sha={digest['weights_sha256'][:12]})",
          flush=True)
    launcher.shutdown()


if __name__ == "__main__":
    main()
