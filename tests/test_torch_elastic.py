"""The port's elastic drills (``znicz_tpu_torch.resilience.elastic_worker``
under ``ElasticSupervisor``) on the CPU: both arms of
``tests/test_elastic.py`` with gangs of two gloo processes.

The preemption arm: process 1 gets a ``host.preempt`` notice at step 23; the whole gang
checkpoints at the announced barrier step (23 + ``preempt_barrier_steps``
= 27: process 0 writes, process 1 fences on the sidecar) and exits
``EXIT_PREEMPTED``; the supervisor restarts the survivor from that
checkpoint, so at most the in-flight step is lost.  The restarted run's
parameters are bit-equal to a one-process gang resumed from the same
checkpoint, and one more step of it captures nothing.  The gangs wait on
exits and heartbeats; their timeouts are far past what a loaded machine
needs.

The kill-and-resume arm: ``host.loss`` kills process 1 at step 25; the
survivor's next collective fails, the supervisor restarts a gang of one
from the newest good snapshot (epoch 2's), and the final parameters are
bit-equal to a one-process gang resumed from the same snapshot.

The gang of three: ``host.loss`` kills process 2 of three at step 25;
the two survivors restart from the newest good snapshot and end
bit-equal to a gang of two resumed from it (``tools/parallel_cards.py``
runs the same drill with four processes on four cards).

The worker takes its card unless ``ZNICZ_ELASTIC_PLATFORM=cpu`` asks
for the CPU (the gangs here ask); with no card it refuses.
"""

import json
import os
import sys

import numpy as np

from znicz_tpu_torch.resilience import supervisor as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: steps a drill epoch: 128 train rows / 16 + 32 validation rows / 16
STEPS_PER_EPOCH = 10


def _write_drill_shards(tmp_path) -> str:
    from znicz_tpu_torch.loader.streaming import write_shards
    rng = np.random.default_rng(21)
    protos = rng.normal(0, 1, (4, 6, 6))
    data = np.concatenate(
        [p + 0.3 * rng.normal(size=(40, 6, 6)) for p in protos])
    data = np.clip((data + 4.0) * 32.0, 0, 255).astype(np.uint8)
    labels = np.repeat(np.arange(4), 40).astype(np.int32)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]
    shard_dir = str(tmp_path / "shards")
    write_shards(shard_dir, data[:128], labels[:128],
                 valid_data=data[128:], valid_labels=labels[128:],
                 rows_per_shard=32)
    return shard_dir


def _supervisor(tmp_path, shard_dir, tag, n_processes, fault_recipe=None,
                initial_snapshot=None, max_restarts=2, batch=16):
    work = str(tmp_path / tag)
    snaps = os.path.join(work, "snaps")

    def argv_for(pid, n, attempt):
        return [sys.executable, "-m",
                "znicz_tpu_torch.resilience.elastic_worker",
                os.path.join(work, f"digest_a{attempt}_p{pid}.json"),
                shard_dir]

    fault_env = {}
    if fault_recipe is not None:
        fault_env["ZNICZ_ELASTIC_FAULTS"] = json.dumps(fault_recipe)
    return sup.ElasticSupervisor(
        argv_for, n_processes=n_processes, work_dir=work,
        snapshot_dir=snaps, snapshot_prefix="elastic",
        heartbeat_timeout_s=600.0, start_grace_s=600.0,
        poll_interval_s=0.1, drain_s=600.0, max_restarts=max_restarts,
        initial_snapshot=initial_snapshot,
        env={"PYTHONPATH": REPO + os.pathsep
             + os.environ.get("PYTHONPATH", ""),
             "OMP_NUM_THREADS": "1",
             "ZNICZ_ELASTIC_PLATFORM": "cpu",
             "ZNICZ_ELASTIC_SNAPSHOT_DIR": snaps,
             "ZNICZ_COLLECTIVE_TIMEOUT_S": "600",
             "ZNICZ_HEARTBEAT_INTERVAL_S": "0.2",
             "ZNICZ_ELASTIC_BATCH": str(batch)},
        fault_env=fault_env)


def _digest(work_dir: str, attempt: int, pid: int = 0) -> dict:
    with open(os.path.join(work_dir, f"digest_a{attempt}_p{pid}.json")) as fh:
        return json.load(fh)


def test_elastic_preemption_checkpoint_loses_at_most_one_step(tmp_path):
    shard_dir = _write_drill_shards(tmp_path)
    drill = _supervisor(
        tmp_path, shard_dir, "preempt", n_processes=2,
        fault_recipe={"host.preempt": {"process": 1, "at": [23]}})
    summary = drill.run()
    assert summary["ok"], summary
    assert summary["restarts"] == 1
    assert summary["losses"] == {"preempt": 1}
    assert summary["final_processes"] == 1
    resume = summary["resume_snapshots"][1]
    # the checkpoint of the barrier step is what the restart resumed
    # from, not an older epoch's snapshot
    assert "preempt_s27" in os.path.basename(resume), resume
    assert summary["resumed_step"] == 27
    elastic = _digest(drill.work_dir, attempt=1)
    assert elastic["n_processes"] == 1
    assert elastic["resumed_from"] == resume
    assert elastic["warmed_step_captures"] == 0
    assert elastic["epochs_done"] == 6
    assert elastic["anomaly_state"] == [0, 0, 0]
    # the gang of two ended in the preemption and wrote no digest
    assert not os.path.exists(os.path.join(drill.work_dir,
                                           "digest_a0_p0.json"))

    ref = _supervisor(tmp_path, shard_dir, "ref", n_processes=1,
                      initial_snapshot=resume, max_restarts=0)
    ref_summary = ref.run()
    assert ref_summary["ok"] and ref_summary["restarts"] == 0
    reference = _digest(ref.work_dir, attempt=0)
    assert reference["resumed_from"] == resume
    assert elastic["weights_sha256"] == reference["weights_sha256"], (
        elastic["weight_sums"], reference["weight_sums"])


def test_elastic_kill_resume_bitwise_parity(tmp_path):
    shard_dir = _write_drill_shards(tmp_path)
    drill = _supervisor(
        tmp_path, shard_dir, "drill", n_processes=2,
        fault_recipe={"host.loss": {"process": 1, "at": [25]}})
    summary = drill.run()
    assert summary["ok"], summary
    assert summary["restarts"] == 1
    assert summary["losses"] == {"loss": 1}
    assert summary["final_processes"] == 1
    resume = summary["resume_snapshots"][1]
    assert resume and os.path.exists(resume), summary
    assert summary["resumed_step"] == 2 * STEPS_PER_EPOCH
    elastic = _digest(drill.work_dir, attempt=1)
    assert elastic["n_processes"] == 1 and elastic["resumed_from"] == resume
    assert elastic["warmed_step_captures"] == 0
    assert elastic["epochs_done"] == 6
    ref = _supervisor(tmp_path, shard_dir, "ref", n_processes=1,
                      initial_snapshot=resume, max_restarts=0)
    assert ref.run()["ok"]
    reference = _digest(ref.work_dir, attempt=0)
    assert elastic["weights_sha256"] == reference["weights_sha256"], (
        elastic["weight_sums"], reference["weight_sums"])
    assert elastic["weight_sums"] == reference["weight_sums"]


def test_gang_of_three_loses_process_two(tmp_path):
    """The shape of the four-card drill on the CPU, one process less: a
    gang of three (minibatch 24, which three and two processes split)
    loses process 2 at step 25; the two survivors restart from the
    newest good snapshot, each binding the device of its new rank, and
    end bit-equal to a gang of two resumed from the same snapshot."""
    shard_dir = _write_drill_shards(tmp_path)
    drill = _supervisor(
        tmp_path, shard_dir, "drill3", n_processes=3, batch=24,
        fault_recipe={"host.loss": {"process": 2, "at": [25]}})
    summary = drill.run()
    assert summary["ok"], summary
    assert summary["restarts"] == 1 and summary["losses"] == {"loss": 1}
    assert summary["final_processes"] == 2
    resume = summary["resume_snapshots"][1]
    assert resume and os.path.exists(resume), summary
    survivors = [_digest(drill.work_dir, 1, pid) for pid in (0, 1)]
    assert [d["process_id"] for d in survivors] == [0, 1]
    assert all(d["n_processes"] == 2 and d["resumed_from"] == resume
               and d["local_batch"] == 12 and d["epochs_done"] == 6
               and d["warmed_step_captures"] == 0 for d in survivors)
    assert survivors[0]["weights_sha256"] == survivors[1]["weights_sha256"]
    ref = _supervisor(tmp_path, shard_dir, "ref2", n_processes=2, batch=24,
                      initial_snapshot=resume, max_restarts=0)
    assert ref.run()["ok"]
    reference = _digest(ref.work_dir, attempt=0)
    assert survivors[0]["weights_sha256"] == reference["weights_sha256"], (
        survivors[0]["weight_sums"], reference["weight_sums"])


def test_elastic_worker_takes_the_card_unless_asked_for_the_cpu(tmp_path):
    """The worker's default platform is the card: with none (CUDA hidden)
    it refuses, writes no digest and does not fall back to the CPU."""
    import subprocess
    shard_dir = _write_drill_shards(tmp_path)
    out = tmp_path / "digest.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZNICZ_")}
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
                "ZNICZ_ELASTIC_SNAPSHOT_DIR": str(tmp_path / "snaps")})
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch.resilience.elastic_worker",
         str(out), shard_dir], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert not out.exists()
