#!/usr/bin/env python3
"""Run the port's multi-process paths on several cards of one machine,
one process a card over NCCL, each against one card.

    python3 tools/parallel_cards.py                  # every visible card
    python3 tools/parallel_cards.py --paths alexnet  # AlexNet's arms only
    python3 tools/parallel_cards.py --cpu --ranks 4 --seq 64 --dim 32
                                                     # a gloo rehearsal

It spawns one process a rank (this script with ``--rank``), joined
through ``tcp://127.0.0.1`` on a free port.  ``--paths`` picks the
paths (comma-separated; all by default).  ``stack``, on
``chip_smoke.py``'s sequence stack (its ``make_trainer``: attention, 8
heads → layer_norm → softmax over 8, bf16, B = 16, T = 2048, D = 512
unless told otherwise):

1. data parallelism: 4 graphed train steps over a data axis of every
   rank (B / N rows a rank, ZeRO-1 on), against the same steps on one
   card; then the graphed step timed on N cards and on one;
2. the ring: the stack with ``seq_parallel`` over a ``seq`` axis of
   every rank (each rank projects its T / N rows; K/V pass by NCCL P2P
   inside the captured step), against the same steps on one card, and
   its step timed beside the one-card step.

``alexnet``, on ``models/samples/alexnet.py`` at full width (bf16, a
global batch of 128, dropout 0.5 on; with ``--cpu`` the narrow AlexNet
of ``tests/torch_parallel_worker.py`` in f32, 32 rows): 4 graphed train
steps with ZeRO-1 on, each arm against the same steps on one card:

3. ``alexnet_dp``: a data axis of every rank (128 / N rows a rank); the
   ranks' dropout masks of every step, stacked in rank order, must be
   the one card's, and every parameter within 2⁻⁸;
4. ``alexnet_bf16_comms``: the same with ``engine.bf16_grad_comms`` on
   (ZeRO-1's reduce-scatter in bf16), held to arm 3 within the
   reference test's band (rtol 0.05, atol 5e-3);
5. ``alexnet_dp_tp``: (data N / 2, model 2), fc6 column-parallel →
   dropout → fc7 row-parallel (the layer config's ``model_parallel``):
   the masks assembled by both coordinates must be the one card's, and
   every parameter within 2⁻⁸;

each arm's graphed step then timed (2 warm-up and 10 timed steps)
beside the one card's, and on the card split in a profiler window of 3
steps (after 2 it skips) into its NCCL kernels' time and the rest.

Then every rank tears down as the launcher does (the workflows' graphs
destroyed, ``distributed.shutdown``) and exits; the parent fails if a
rank has not exited within ``EXIT_S`` seconds of rank 0.  Last, with
``launcher`` among the paths, the launcher itself: ``python -m
znicz_tpu_torch`` on one process a rank (:func:`launcher_run`).  The
parent prints the cards' names and power limits, rank 0 one JSON line
of the numbers, the launcher's run one.  The comparisons hold each
parameter to ‖N cards − one‖ / ‖one‖ ≤ 2⁻⁸ (the folds reorder sums;
bf16 rounds activations).
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
#: the bf16 reduce-scatter against the f32 one (``tests/test_zero1.py``'s
#: band)
BF16_COMMS_TOL = dict(rtol=0.05, atol=5e-3)
STEPS = 4
PATHS = ("stack", "alexnet", "launcher")
#: seconds rank 0 may take to report and exit, and the other ranks to
#: exit after it
RUN_S, EXIT_S = 900, 60


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
    out = {"ranks": args.ranks, "device": str(dev), "tol": TOL}
    paths = args.paths.split(",")

    def trained(mesh, seq_parallel=False):
        wf = smoke.make_trainer(x, y, smoke.BATCH, make(mesh), precision,
                                seq_parallel=seq_parallel)
        for _ in range(STEPS):
            wf.step()
        return wf

    kept, ok = [], True
    if "stack" in paths:
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
        kept += [dp, ring]
        if args.rank == 0:
            one = trained(None)
            want = smoke.params_of(one)
            out["one_step_ms"] = step_ms(one, not args.cpu)
            one.release_graphs()
            out["dp_vs_one"] = smoke.params_diff(got_dp, want)[0]
            out["ring_vs_one"] = smoke.params_diff(got_ring, want)[0]
            ok &= out["dp_vs_one"] <= TOL and out["ring_vs_one"] <= TOL
    if "alexnet" in paths:
        ok &= alexnet_arms(args, kind, make, out)
    if args.rank == 0:
        out["ok"] = bool(ok)
        print(json.dumps(out), flush=True)
    # the launcher's teardown
    t0 = time.perf_counter()
    for wf in kept:
        wf.release_graphs()
    distributed.shutdown()
    print(f"rank {args.rank}: torn down in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return 0 if ok else 1


def alexnet(args, device, model_parallel=False):
    """AlexNet on ``device``, its dropout on, fed ``STEPS`` batches' worth
    of frames and no validation set: the sample at full width (a global
    batch of 128), or with ``--cpu`` the tests' narrow AlexNet (32)."""
    from znicz_tpu_torch.utils import prng
    if args.cpu:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import torch_parallel_worker as worker
        prng.seed_all(worker.STOCHASTIC_SEED)
        wf = worker.build_narrow_alexnet(model_parallel=model_parallel)
        wf.decision.max_epochs = 10 ** 6
    else:
        import chip_smoke as smoke
        from znicz_tpu_torch.models.samples import alexnet as sample
        prng.seed_all(smoke.SEED)
        batch = smoke.ALEX_BATCH
        wf = sample.build(minibatch_size=batch, n_train_samples=STEPS * batch,
                          n_valid_samples=0, model_parallel=model_parallel)
    wf.initialize(device=device)
    return wf


def kernel_split(wf, ranks: bool, steps: int = 3) -> dict:
    """Device time a graphed step in a ``torch.profiler`` window of
    ``steps`` steps, after 2 steps that the profiler skips (every rank
    steady by then): its kernels, the NCCL kernels among them (which
    include waiting for the slowest rank), and the five longest kernels
    (ms a step).  Ranges the host names (the region's) are not
    kernels.  ``ranks``: every rank profiles its step (a barrier first)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    if ranks:
        dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=steps)) as prof:
        for _ in range(2 + steps):
            wf.step()
            # a step's kernels run inside its own profiler step
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type != DeviceType.CUDA}
    kernels = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.key in host:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3 / steps
        kernels[e.key] = kernels.get(e.key, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels_ms": sum(kernels.values()),
            "nccl_ms": sum(v for k, v in kernels.items()
                           if "nccl" in k.lower()),
            "top": [(k[:60], v) for k, v in top]}


def dropout_masks(wf) -> list:
    """The mask each dropout unit applied in the last train step, as
    this process's block of it (regenerated from the step's seed through
    the unit's block map, on the host: a ReLU's zeros do not blur it)."""
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    return [(fk.dropout_apply_plain(torch.ones(tuple(u.output.shape)),
                                    int(u.seed), u.dropout_ratio,
                                    u.mask_block) != 0).numpy()
            for u in wf.forwards if type(u).__name__ == "DropoutForward"]


def logical_params(wf) -> dict:
    """Every forward parameter, whole (a block under tensor parallelism
    gathered: a collective every rank joins)."""
    return {f"{u.name}.{name}": u.full_tensor(name, p).detach().float()
            .cpu().clone() for u in wf.forwards
            for name, p in u.named_parameters(recurse=False)}


def alexnet_arms(args, kind, make, out) -> bool:
    """Paths 3–5 of the module's docstring on this rank; rank 0 trains the
    one card too, assembles the ranks' masks and writes the arms' numbers
    into ``out``.  Returns whether every check held (on rank 0)."""
    import numpy as np
    import torch.distributed as dist
    import chip_smoke as smoke
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.utils.config import root
    cuda = not args.cpu
    arms = {"alexnet_dp": (dict(device_type=kind), False, False),
            "alexnet_bf16_comms": (dict(device_type=kind), True, False),
            "alexnet_dp_tp": (dict(n_data=args.ranks // 2, n_model=2,
                                   device_type=kind), False, True)}
    got = {}
    for arm, (mesh_kw, bf16_comms, tp) in arms.items():
        root.common.engine.bf16_grad_comms = bf16_comms
        mesh = make_mesh(**mesh_kw)
        wf = alexnet(args, make(mesh), model_parallel=tp)
        masks = []
        smoke.reset_counts()
        for _ in range(STEPS):
            wf.step()
            masks.append(dropout_masks(wf))
        b3 = fk.dropout_apply.launches
        params = logical_params(wf)
        ms = step_ms(wf, cuda)
        split = kernel_split(wf, True) if cuda else None
        wf.release_graphs()
        root.common.engine.bf16_grad_comms = False
        coords = (mesh.index("data"), mesh.index("model"))
        every = [None] * args.ranks
        dist.all_gather_object(every, (coords, masks))
        got[arm] = {"params": params, "masks": every, "step_ms": ms,
                    "b3_launches": b3, "split": split,
                    "bf16_comms": any(g.__dict__.get("_grad_comms_bf16")
                                      for g in wf.gds)}
        del wf
    if args.rank != 0:
        return True
    one = alexnet(args, make(None))
    one_masks = []
    for _ in range(STEPS):
        one.step()
        one_masks.append(dropout_masks(one))
    want = logical_params(one)
    out["alexnet_one_step_ms"] = step_ms(one, cuda)
    out["alexnet_one_split"] = kernel_split(one, False) if cuda else None
    one.release_graphs()
    ok = True
    for arm, res in got.items():
        # assemble each step's masks: rows by the data coordinate, the
        # features of a column layer's output by the model coordinate
        same = True
        for step, whole in enumerate(one_masks):
            for unit, want_mask in enumerate(whole):
                grid = {}
                for (d, m), masks in res["masks"]:
                    grid.setdefault(d, {})[m] = masks[step][unit]
                rows = []
                for d in sorted(grid):
                    blocks = [grid[d][m] for m in sorted(grid[d])]
                    wide = np.concatenate(blocks, axis=1)
                    if wide.shape[1] == want_mask.shape[1]:
                        rows.append(wide)
                    else:  # whole features: every model rank the same
                        same &= all(np.array_equal(b, blocks[0])
                                    for b in blocks)
                        rows.append(blocks[0])
                same &= np.array_equal(np.concatenate(rows), want_mask)
        worst, name, equal = smoke.params_diff(res["params"], want)
        out[arm] = {"masks_equal": bool(same), "vs_one": worst,
                    "worst": name, "bit_equal": equal,
                    "step_ms": res["step_ms"], "split": res["split"],
                    "b3_launches": res["b3_launches"],
                    "bf16_comms": bool(res["bf16_comms"])}
        ok &= same and worst <= TOL
    bf16, f32 = got["alexnet_bf16_comms"], got["alexnet_dp"]
    band = all(np.allclose(bf16["params"][k].numpy(), f32["params"][k].numpy(),
                           **BF16_COMMS_TOL) for k in f32["params"])
    out["alexnet_bf16_comms"]["within_band_of_dp"] = bool(band)
    ok &= band and bf16["bf16_comms"] and not f32["bf16_comms"]
    return ok


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
    parser.add_argument("--paths", default=",".join(PATHS),
                        help=f"comma-separated, of {', '.join(PATHS)}")
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
            str(args.seq), "--dim", str(args.dim), "--paths", args.paths] \
        + (["--cpu"] if args.cpu else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = wait_all([subprocess.Popen(argv + ["--rank", str(r)], env=env)
                     for r in range(args.ranks)])
    if "launcher" in args.paths.split(","):
        code = max(code, launcher_run(args, env))
    return code


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
