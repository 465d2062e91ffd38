"""The launcher's multi-process modes on the CPU (counterparts of
``tests/test_distributed.py``'s bootstrap and lockstep-snapshot cases).

- The env contract: a one-process world whose ``Launcher(backend="cpu")``
  reads ``ZNICZ_COORDINATOR`` (a port picked free at run time),
  ``ZNICZ_NUM_PROCESSES`` and ``ZNICZ_PROCESS_ID``.
- ``python -m znicz_tpu_torch tests/torch_dist_workflow.py -b cpu
  --listen/--master … --nodes 2 --process-id I``: two processes train
  the blobs MLP data-parallel over gloo and end with the same weights;
  process 0 alone writes the snapshots, which process 1 fences on and
  records; both then resume from the same snapshot and again agree,
  with the run that one process resumes from it (within 1e-5: the fold
  reorders sums).
- ``--n-model 2`` over the same two processes (a data 1 × model 2
  mesh; the workflow's hidden layer a column-parallel and row-parallel
  pair): both end with the same whole weights, within 2⁻⁸ of one
  process's run; process 0 alone writes, and its snapshot holds every
  tensor whole, the momentum of the split layers included (C25), and
  resumes on one process.
- The teardown: the workflow's CUDA graphs released before the group,
  and a region capturing again after the release.
"""

import glob
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOW = os.path.join(REPO, "tests", "torch_dist_workflow.py")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_env_contract_starts_a_gloo_world(tmp_path):
    (got,) = worker.spawn_world(
        "env", 1, tmp_path, extra_env={
            "ZNICZ_COORDINATOR": f"127.0.0.1:{_free_port()}",
            "ZNICZ_NUM_PROCESSES": "1", "ZNICZ_PROCESS_ID": "0"})
    assert got == {"mode": "master", "process_info": (0, 1),
                   "mesh": {"data": 1, "model": 1}, "backend": "gloo"}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _one_process(tmp_path, tag, *args):
    """The command line on one process (no distributed mode); returns
    its dump."""
    out = tmp_path / f"out_{tag}"
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", WORKFLOW, "-b", "cpu",
         "--root", f"dist.snapshots={out}", "--root", f"dist.out={out}",
         *args], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    with open(out / "rank0.pkl", "rb") as f:
        return pickle.load(f)


def _two_processes(tmp_path, tag, *args):
    """Both processes of one command line; returns their dumps."""
    out = tmp_path / f"out_{tag}"
    out.mkdir()
    coordinator = f"127.0.0.1:{_free_port()}"
    env = _env()
    procs = []
    for pid, flag in ((0, "--listen"), (1, "--master")):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "znicz_tpu_torch", WORKFLOW, "-b", "cpu",
             flag, coordinator, "--nodes", "2", "--process-id", str(pid),
             "--root", f"dist.snapshots={tmp_path / 'snapshots'}",
             "--root", f"dist.out={out}", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate(timeout=900)[0] for proc in procs]
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    dumps = []
    for pid in (0, 1):
        with open(out / f"rank{pid}.pkl", "rb") as f:
            dumps.append(pickle.load(f))
    return dumps


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    first = _two_processes(tmp, "first", "--root", "dist.max_epochs=2")
    files = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp / "snapshots" / "*")))
    resumed = _two_processes(tmp, "resumed", "-s", first[0]["destination"],
                             "--root", "dist.max_epochs=4")
    return tmp, first, files, resumed


def test_two_processes_agree_on_weights(cli_runs):
    _, first, _, resumed = cli_runs
    for run in (first, resumed):
        assert [d["count"] for d in run] == [2, 2]
        for a, b in zip(run[0]["params"], run[1]["params"]):
            np.testing.assert_array_equal(a, b)
    assert "mesh={'data': 2, 'model': 1}" in first[0]["device"]


def test_process_zero_alone_writes_and_one_fences(cli_runs):
    _, first, files, _ = cli_runs
    assert first[0]["wrote"] > 0 and first[1]["wrote"] == 0
    assert first[0]["destination"] == first[1]["destination"]
    assert os.path.basename(first[0]["destination"]) in files
    # every snapshot has its sidecar, and no process left a temporary
    snaps = [f for f in files if f.endswith(".pickle.gz")]
    assert snaps and all(f"{f}.sha256" in files for f in snaps)
    assert not [f for f in files if f.endswith(".tmp")]


def test_both_resume_from_the_same_snapshot(cli_runs, tmp_path):
    """The resumed gang continues the snapshot's run: epochs 2 and 3,
    equal to one process resuming from the same file."""
    from znicz_tpu_torch.__main__ import Main
    from znicz_tpu_torch.utils.config import reset_root
    _, first, _, resumed = cli_runs
    assert [d["epoch"] for d in resumed] == [3, 3]
    reset_root()
    try:
        assert Main().run([
            WORKFLOW, "-b", "cpu", "-s", first[0]["destination"],
            "--root", "dist.max_epochs=4",
            "--root", f"dist.snapshots={tmp_path}",
            "--root", f"dist.out={tmp_path}"]) == 0
    finally:
        reset_root()
    with open(tmp_path / "rank0.pkl", "rb") as f:
        single = pickle.load(f)
    assert single["count"] == 1
    for a, b in zip(single["params"], resumed[0]["params"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


TP = ("--root", "dist.model_parallel=True")


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """``--n-model 2`` on two processes, and the same workflow on one."""
    tmp = tmp_path_factory.mktemp("tp")
    two = _two_processes(tmp, "tp", "--n-model", "2", *TP)
    one = _one_process(tmp, "one", *TP)
    return tmp, two, one


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_n_model_two_agrees_with_one_process(tp_runs):
    """Both processes hold the whole column and row layers (gathered
    from their blocks), bit-equal to each other and within 2⁻⁸ of one
    process's run (the row layer's partial products are summed over the
    model axis: another order of the sums)."""
    _, two, one = tp_runs
    assert "mesh={'data': 1, 'model': 2}" in two[0]["device"]
    assert [d["count"] for d in two] == [2, 2]
    shapes = [p.shape for p in one["params"]]
    assert shapes == [(12, 16), (16,), (16, 16), (16,), (16, 3), (3,)]
    for a, b in zip(two[0]["params"], two[1]["params"]):
        np.testing.assert_array_equal(a, b)
    assert [p.shape for p in two[0]["params"]] == shapes
    worst = max(_rel(a, b) for a, b in zip(two[0]["params"],
                                           one["params"]))
    assert worst <= 2.0 ** -8, worst


def test_n_model_two_snapshot_is_whole_and_resumes_on_one_process(
        tp_runs):
    """Process 0 alone writes; every tensor of its snapshot has the
    shape of the one-process run's, the split layers' momentum
    included (C25: it held process 0's block, and a resume on one
    process refused it); the snapshot resumes on one process."""
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    tmp, two, one = tp_runs
    assert two[0]["wrote"] > 0 and two[1]["wrote"] == 0
    assert two[0]["destination"] == two[1]["destination"]

    def shapes(path):
        units = Snapshotter.load(path)["__units__"]
        return {(unit, name): np.shape(value)
                for unit, state in units.items()
                for name, value in state.items()
                if isinstance(value, np.ndarray)}

    got, want = shapes(two[0]["destination"]), shapes(one["destination"])
    assert got == want
    assert got["GDTanh", "accumulated_gradient_weights"] == (16, 16)
    resumed = _one_process(tmp, "resumed", "-s", two[0]["destination"],
                           "--root", "dist.max_epochs=3", *TP)
    assert resumed["epoch"] == 2 and resumed["count"] == 1


def test_the_teardown_releases_graphs_before_the_group(monkeypatch):
    """NCCL does not destroy a communicator while a CUDA graph that
    holds its collectives lives (on four H100s ``destroy_process_group``
    blocked until killed): the launcher's teardown destroys the
    workflow's graphs first, then the group; a standalone launcher
    tears nothing down."""
    from znicz_tpu_torch.launcher import Launcher
    from znicz_tpu_torch.parallel import distributed
    order = []

    class Workflow:
        def release_graphs(self):
            order.append("graphs")

    monkeypatch.setattr(distributed, "shutdown",
                        lambda: order.append("group"))
    standalone = Launcher(backend="cpu")
    standalone.workflow = Workflow()
    standalone.shutdown()
    assert order == []
    launcher = Launcher(backend="cpu")
    launcher.coordinator = "127.0.0.1:1"
    launcher.workflow = Workflow()
    launcher.shutdown()
    assert order == ["graphs", "group"]


def test_release_graphs_drops_every_capture(monkeypatch):
    """``release_graphs`` empties every region's graphs and the
    pipeline's executor, and the next step captures again (a stand-in
    for the CUDA graph API: a capture runs the members, a replay
    nothing)."""
    import contextlib

    import torch

    from znicz_tpu_torch.accelerated_units import JitRegion
    from znicz_tpu_torch.backends import CpuDevice

    class Graph:
        def replay(self):
            pass

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(JitRegion, "graphed",
                        property(lambda self: self.mark is None))
    wf = worker.build_fc(hidden2=None)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    regions = [u.region for u in wf.units
               if isinstance(getattr(u, "region", None), JitRegion)]
    wf.step()
    assert regions and sum(r.captures for r in regions) > 0
    wf._pipeline = object()
    wf.release_graphs()
    assert sum(r.captures for r in regions) == 0
    assert wf._pipeline is None
    wf.step()
    assert sum(r.captures for r in regions) > 0
