#!/usr/bin/env python3
"""Run the port's multi-process paths on several cards of one machine,
one process a card over NCCL, each against one card.

    python3 tools/parallel_cards.py                  # every visible card
    python3 tools/parallel_cards.py --cpu --ranks 4 --seq 64 --dim 32
                                                     # a gloo rehearsal

It spawns one process a rank (this script with ``--rank``), joined
through ``tcp://127.0.0.1`` on a free port.  On ``chip_smoke.py``'s
sequence stack (its ``make_trainer``: attention, 8 heads → layer_norm →
softmax over 8, bf16, B = 16, T = 2048, D = 512 unless told otherwise):

1. data parallelism: 4 graphed train steps over a data axis of every
   rank (B / N rows a rank, ZeRO-1 on), against the same steps on one
   card; then the graphed step timed on N cards and on one;
2. the ring: the stack with ``seq_parallel`` over a ``seq`` axis of
   every rank (each rank projects its T / N rows; K/V pass by NCCL P2P
   inside the captured step), against the same steps on one card, and
   its step timed beside the one-card step.

Then every rank tears down as the launcher does (the workflows' graphs
destroyed, ``distributed.shutdown``) and exits; the parent fails if a
rank has not exited within ``EXIT_S`` seconds of rank 0.  Last, the
launcher itself: ``python -m znicz_tpu_torch`` on one process a rank
(:func:`launcher_run`).  The parent prints the cards' names and power
limits, rank 0 one JSON line of the numbers, the launcher's run one.
The comparisons hold each parameter to ‖N cards − one‖ / ‖one‖ ≤ 2⁻⁸
(the folds reorder sums; bf16 rounds activations).
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

TOL = 2.0 ** -8
STEPS = 4
#: seconds rank 0 may take to report and exit, and the other ranks to
#: exit after it
RUN_S, EXIT_S = 480, 60


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_ms(wf, cuda: bool, steps: int = 10) -> float:
    import torch
    for _ in range(2):
        wf.step()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        wf.step()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def rank_main(args) -> int:
    import numpy as np
    import torch

    import chip_smoke as smoke
    from znicz_tpu_torch.backends import CpuDevice, CudaDevice
    from znicz_tpu_torch.parallel import distributed, make_mesh
    from znicz_tpu_torch.utils.config import root
    kind = "cpu" if args.cpu else "cuda"
    precision = "float32" if args.cpu else "bfloat16"
    # before any device is made: a device takes the precision it sees
    root.common.precision_type = precision
    root.common.engine.zero1 = "auto"
    distributed.ensure_initialized(
        coordinator=f"127.0.0.1:{args.port}", num_processes=args.ranks,
        process_id=args.rank, device_type=kind, timeout_s=300)
    dev = distributed.local_device(kind)
    make = (lambda mesh: CpuDevice(dev, mesh=mesh)) if args.cpu else \
        (lambda mesh: CudaDevice(dev, mesh=mesh))
    rng = np.random.default_rng(smoke.SEED + 21)
    n = STEPS * smoke.BATCH
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, args.seq, args.dim))
                         .astype(np.float32)).to(getattr(torch, precision))
    y = rng.integers(0, smoke.CLASSES, size=n).astype(np.int32)
    out = {"ranks": args.ranks, "device": str(dev)}

    def trained(mesh, seq_parallel=False):
        wf = smoke.make_trainer(x, y, smoke.BATCH, make(mesh), precision,
                                seq_parallel=seq_parallel)
        for _ in range(STEPS):
            wf.step()
        return wf

    dp = trained(make_mesh(device_type=kind))
    got_dp = smoke.params_of(dp)
    out["dp_zero1"] = sorted(dp.gds[0].__dict__.get("_zero1", {}))
    out["dp_step_ms"] = step_ms(dp, not args.cpu)
    ring = trained(make_mesh(n_data=1, n_model=1, n_seq=args.ranks,
                             device_type=kind), seq_parallel=True)
    if ring.forwards[0].ring is None:
        raise AssertionError("seq_parallel did not engage the ring")
    got_ring = smoke.params_of(ring)
    out["ring_step_ms"] = step_ms(ring, not args.cpu)
    ok = True
    if args.rank == 0:
        one = trained(None)
        want = smoke.params_of(one)
        out["one_step_ms"] = step_ms(one, not args.cpu)
        one.release_graphs()
        out["dp_vs_one"] = smoke.params_diff(got_dp, want)[0]
        out["ring_vs_one"] = smoke.params_diff(got_ring, want)[0]
        out["tol"] = TOL
        ok = out["ok"] = out["dp_vs_one"] <= TOL \
            and out["ring_vs_one"] <= TOL
        print(json.dumps(out), flush=True)
    # the launcher's teardown
    t0 = time.perf_counter()
    dp.release_graphs()
    ring.release_graphs()
    distributed.shutdown()
    print(f"rank {args.rank}: torn down in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return 0 if ok else 1


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ranks", type=int, default=None,
                        help="processes (default: every visible card)")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the host (a rehearsal)")
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.ranks is None:
        import torch
        args.ranks = torch.cuda.device_count()
    if not args.cpu:
        from znicz_tpu_torch.ops import _cuda
        _cuda.build_all()  # once, before the ranks load the libraries
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(smi, flush=True)
    argv = [sys.executable, os.path.abspath(__file__), "--ranks",
            str(args.ranks), "--port", str(free_port()), "--seq",
            str(args.seq), "--dim", str(args.dim)] \
        + (["--cpu"] if args.cpu else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = wait_all([subprocess.Popen(argv + ["--rank", str(r)], env=env)
                     for r in range(args.ranks)])
    return max(code, launcher_run(args, env))


def wait_all(procs) -> int:
    """The worst exit code of ``procs``; 1 for a process that has not
    exited within ``RUN_S`` seconds (the first) or ``EXIT_S`` seconds
    of the first (the others), which is killed."""
    code = 0
    try:
        deadline = time.monotonic() + RUN_S
        for r, p in enumerate(procs):
            try:
                code = max(code, p.wait(
                    timeout=max(deadline - time.monotonic(), 1)))
            except subprocess.TimeoutExpired:
                print(f"rank {r} has not exited", file=sys.stderr,
                      flush=True)
                code = max(code, 1)
            if r == 0:
                deadline = time.monotonic() + EXIT_S
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return code


def launcher_run(args, env) -> int:
    """The command line on every rank, ``python -m znicz_tpu_torch
    tests/torch_dist_workflow.py --listen|--master … --nodes N``
    (process 0 writing the snapshots, the others fencing on them): each
    process must exit 0, and end with process 0's weights.  Prints one
    JSON line."""
    import pickle
    import tempfile

    import numpy as np
    out = tempfile.mkdtemp(prefix="parallel_cards_")
    coordinator = f"127.0.0.1:{free_port()}"
    cmd = [sys.executable, "-m", "znicz_tpu_torch",
           os.path.join(HERE, "tests", "torch_dist_workflow.py")] \
        + (["-b", "cpu"] if args.cpu else [])
    env = dict(env, PYTHONPATH=HERE + os.pathsep
               + env.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = []
    for r in range(args.ranks):
        with open(os.path.join(out, f"log{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                cmd + ["--listen" if r == 0 else "--master", coordinator,
                       "--nodes", str(args.ranks), "--process-id", str(r),
                       "--root", f"dist.snapshots={out}",
                       "--root", f"dist.out={out}"],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
    code = wait_all(procs)
    seconds = time.perf_counter() - t0
    dumps = []
    for r in range(args.ranks):
        path = os.path.join(out, f"rank{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                dumps.append(pickle.load(f))
    equal = len(dumps) == args.ranks and all(
        np.array_equal(a, b) for d in dumps[1:]
        for a, b in zip(dumps[0]["params"], d["params"]))
    print(json.dumps({"launcher": {
        "exit_codes": [p.returncode for p in procs],
        "seconds": seconds, "weights_equal": equal,
        "snapshots_written": [d["wrote"] for d in dumps]}}), flush=True)
    if code or not equal:
        with open(os.path.join(out, "log0.txt")) as f:
            print(f.read()[-4000:], file=sys.stderr)
    shutil.rmtree(out, ignore_errors=True)
    return 1 if code or not equal else 0


if __name__ == "__main__":
    sys.exit(main())
