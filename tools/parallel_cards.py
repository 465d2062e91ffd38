#!/usr/bin/env python3
"""Run the port's multi-process and multi-card paths on several cards
of one machine, one process a card over NCCL (or one process over every
card), each against one card.

    python3 tools/parallel_cards.py                  # every visible card
    python3 tools/parallel_cards.py --paths alexnet  # AlexNet's arms only
    python3 tools/parallel_cards.py --paths serving,launcher_tp,gang
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
znicz_tpu_torch`` on one process a rank (:func:`launcher_run`).  Then
the three paths that no NCCL rank runs:

6. ``serving``: the phase-3 scorer (attention, 8 heads → layer_norm →
   softmax over 8, T = 2048, D = 512, bf16) behind one
   ``ServingEngine(replicate)`` in a process of its own that sees every
   card, one graphed ``ExportedModel`` a card (:func:`serving_arm`);
7. ``launcher_tp``: ``python -m znicz_tpu_torch alexnet … --nodes N
   --n-model 2 --root alexnet.model_parallel=True`` on one process a
   card (a data N / 2 × model 2 mesh, fc6 column- and fc7
   row-parallel), one epoch of 4 steps, against the same command on one
   card, and its snapshot resumed on one card (:func:`launcher_tp_run`);
8. ``gang``: ``ElasticSupervisor`` over ``elastic_worker`` with one
   process a card, the host-loss and the preemption drill of
   ``tests/test_torch_elastic.py`` with N processes, each restart held
   bit for bit to a gang of N − 1 resumed from the same snapshot
   (:func:`gang_run`).

The parent prints the cards' names and power limits, rank 0 one JSON
line of the numbers, each later path one.  The comparisons hold each
parameter to ‖N cards − one‖ / ‖one‖ ≤ 2⁻⁸ (the folds reorder sums;
bf16 rounds activations).  With ``--cpu`` every path runs on the host:
the replicas on the CPU, ``launcher_tp`` on ``tests/torch_dist_workflow.py``
(its column/row pair), the gangs over gloo.
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
PATHS = ("stack", "alexnet", "launcher", "serving", "launcher_tp", "gang")
#: the closed loop's request sizes (phase 3's)
SERVE_ROWS = (1, 3, 16)
#: the elastic drills' minibatch: N and N - 1 processes split it
GANG_BATCH = 24
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
    parser.add_argument("--serving-child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.serving_child:
        return serving_arm(args)
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
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        parser.error(f"unknown paths {sorted(unknown)} (of {PATHS})")
    code = 0
    if "stack" in paths or "alexnet" in paths:
        code = wait_all([subprocess.Popen(argv + ["--rank", str(r)],
                                          env=env)
                         for r in range(args.ranks)])
    if "launcher" in paths:
        code = max(code, launcher_run(args, env))
    if "serving" in paths:
        code = max(code, wait_all([subprocess.Popen(
            argv + ["--serving-child"], env=env)]))
    if "launcher_tp" in paths:
        code = max(code, launcher_tp_run(args, env))
    if "gang" in paths:
        code = max(code, gang_run(args, env))
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


# ----------------------------------------------------------------------
# serving: one engine, one replica a card
# ----------------------------------------------------------------------
def device_kernels_by_card(prof) -> dict:
    """``{card index: {wrapper: kernels the profiler saw}}`` for the
    scorer's three wrappers (B7, B5, B4), by ``chip_smoke``'s names."""
    import re

    import chip_smoke as smoke
    from torch.autograd import DeviceType
    names = ("flash_attention_fwd", "layer_norm_forward", "softmax_argmax")
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if re.search(smoke.DEVICE_KERNELS[name][0], e.name):
                card = out.setdefault(int(e.device_index), {})
                card[name] = card.get(name, 0) + 1
    return out


def serving_arm(args) -> int:
    """Path 6 in a process of its own that sees every card: the scorer
    exported once, one ``ServingEngine`` with a replica a card
    (``resolve_device(True)``; with ``--cpu`` ``--ranks`` replicas on the
    host) against the one-card ``ExportedModel``.

    - Each reply of 1, 3 and 16 rows bit-equal to the one card fed the
      same block at the same bucket (16 rows: four blocks of 4, one a
      card), and a 16-row reply within 2⁻⁸ of the one card's bucket 16;
    - the launches: B7, B5 and B4 counted once a block, and on the card
      seen by the profiler on every card;
    - a hot swap (``stage_weights`` + ``publish`` on every replica) with
      no new capture, the replies then the swapped one card's, bit for
      bit;
    - the closed loop (30 requests of 1/3/16 rows) on the replicas and on
      one card in turns (replicas, one, one, replicas): p50 and rows/s.

    Prints one JSON line; returns 0 when every check held."""
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as smoke
    from znicz_tpu_torch.export import ExportedModel, read_bundle
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk
    from znicz_tpu_torch.serving.buckets import bucket_for
    from znicz_tpu_torch.serving.engine import ServingEngine
    cuda = not args.cpu
    out = {"ok": False}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.npz")
        smoke.write_scorer_bundle(path, seq=args.seq, dim=args.dim,
                                  dtype="bfloat16" if cuda else "float32")
        manifest, params = read_bundle(path)
        swapped = os.path.join(tmp, "swapped.npz")
        smoke.write_bundle(swapped, manifest,
                           smoke.perturbed(params, smoke.SEED + 30))
        devices = ServingEngine.resolve_device(True) if cuda \
            else ["cpu"] * args.ranks
        if not isinstance(devices, list) or len(devices) < 2:
            raise SystemExit(f"serving: {devices} is not two or more "
                             f"devices")
        n = len(devices)
        one = ExportedModel.load(path, device=devices[0], max_batch=16)
        one.warmup()
        rng = np.random.default_rng(smoke.SEED + 31)
        x = rng.normal(0.0, 0.3, size=(16, args.seq, args.dim)) \
            .astype(np.float32)

        def blocks_of(model, rows):
            """``rows`` rows as the replicas take them: blocks of one
            ladder bucket, each through ``model`` at that bucket."""
            size = bucket_for(rows)
            block = bucket_for(-(-size // n))
            return np.concatenate([model(x[r:min(r + block, rows)])
                                   for r in range(0, rows, block)])

        want = {rows: blocks_of(one, rows) for rows in SERVE_ROWS}
        whole16 = one(x[:16])
        eng = ServingEngine(path, max_batch=16, max_delay_ms=1.0,
                            device=devices).start()
        single = ServingEngine(one, max_batch=16, max_delay_ms=1.0).start()
        try:
            captures = [r.captures for r in eng.replicas]
            equal, launches = {}, {}
            wrappers = (fa.flash_attention_fwd, fk.layer_norm_forward,
                        fk.softmax_argmax)
            for rows in SERVE_ROWS:
                before = [w.launches for w in wrappers]
                got = eng(x[:rows], timeout=300)
                launches[rows] = [w.launches - b
                                  for w, b in zip(wrappers, before)]
                equal[rows] = bool(np.array_equal(got, want[rows]))
            block16 = bucket_for(-(-16 // n))
            got16 = eng(x[:16], timeout=300)
            vs16 = float(np.abs(got16 - whole16).max())
            out.update(replicas=n, devices=[str(d) for d in devices],
                       bit_equal_at_equal_buckets=equal,
                       block_of_16=block16, vs_bucket16_max_abs=vs16,
                       launches_b7_b5_b4=launches)
            # a block a replica: B7, B5 and B4 once each a block
            blocks = {rows: -(-bucket_for(rows) // bucket_for(
                -(-bucket_for(rows) // n))) for rows in SERVE_ROWS}
            launch_ok = not cuda or all(
                launches[rows] == [blocks[rows]] * 3 for rows in SERVE_ROWS)
            cards_ok = True
            if cuda:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    eng(x[:16], timeout=300)
                    for d in devices:
                        torch.cuda.synchronize(d)
                by_card = device_kernels_by_card(prof)
                out["profiler_kernels_by_card"] = by_card
                cards_ok = sorted(by_card) == list(range(n)) and all(
                    len(k) == 3 for k in by_card.values())
            # the swap on every replica, no new capture
            eng.swap_weights(swapped)
            one.swap_weights(read_bundle(swapped)[1])
            swap_equal = bool(np.array_equal(eng(x[:16], timeout=300),
                                             blocks_of(one, 16)))
            after = [r.captures for r in eng.replicas]
            versions = [r.weights_version for r in eng.replicas]
            out.update(captures=captures, captures_after_swap=after,
                       weights_versions=versions,
                       swap_bit_equal=swap_equal)
            # the closed loop, replicas and one card in turns
            loops = {"replicas": [], "one": []}
            for turn in ("replicas", "one", "one", "replicas"):
                lat, rate = smoke.closed_loop(
                    eng if turn == "replicas" else single, x)
                loops[turn].append((1e3 * lat[len(lat) // 2], rate))
            out["closed_loop_p50_ms_rows_s"] = loops
        finally:
            eng.shutdown()
            single.shutdown()
    out["ok"] = bool(all(equal.values()) and vs16 <= TOL and launch_ok
                     and cards_ok and swap_equal and after == captures
                     and versions == [1] * n
                     and (not cuda or captures == [5] * n))
    print(json.dumps({"serving": out}), flush=True)
    return 0 if out["ok"] else 1


# ----------------------------------------------------------------------
# launcher_tp: the command line with --n-model 2
# ----------------------------------------------------------------------
#: runs ``python -m znicz_tpu_torch`` with the rest of its arguments and,
#: at exit, writes the first argument's JSON: the snapshots this process
#: wrote and the hand-written kernels' launches
CLI_PROBE = """
import atexit, json, runpy, sys
out = sys.argv.pop(1)


def report():
    from znicz_tpu_torch.observe import metrics
    from znicz_tpu_torch.ops import fused_kernels as fk
    with open(out, "w") as f:
        json.dump({"snapshot_writes": metrics.snapshot_seconds("save").count,
                   "launches": {fn.__name__: fn.launches for fn in (
                       fk.lrn_forward, fk.lrn_backward, fk.dropout_apply,
                       fk.softmax_argmax)}}, f)


atexit.register(report)
sys.argv[0] = "znicz_tpu_torch"
runpy.run_module("znicz_tpu_torch", run_name="__main__", alter_sys=True)
"""


def tp_command(args, snaps: str, *extra: str) -> list:
    """The command line of path 7 after ``python -m znicz_tpu_torch``:
    AlexNet at full width, 4 steps and a validation step, its snapshots
    into ``snaps`` (with ``--cpu`` the tests' workflow with its
    column/row pair)."""
    if args.cpu:
        return [os.path.join(HERE, "tests", "torch_dist_workflow.py"),
                "-b", "cpu", "--root", "dist.model_parallel=True",
                "--root", f"dist.snapshots={snaps}",
                "--root", f"dist.out={snaps}", *extra]
    import chip_smoke as smoke
    return ["alexnet", "--root", "alexnet.model_parallel=True",
            "--root", f"alexnet.n_train_samples={STEPS * smoke.ALEX_BATCH}",
            "--root", f"alexnet.n_valid_samples={smoke.ALEX_BATCH}",
            "--root", "alexnet.max_epochs=1",
            "--root", "alexnet.snapshotter_config={'prefix': 'alexnet', "
                      f"'directory': '{snaps}', 'keep_last': 0}}", *extra]


def run_cli(argvs: list, out: str, env) -> tuple:
    """One process an argument list (through :data:`CLI_PROBE`), logs and
    reports under ``out``; returns (worst exit code, reports, seconds)."""
    t0 = time.perf_counter()
    procs = []
    for i, argv in enumerate(argvs):
        with open(os.path.join(out, f"log{i}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CLI_PROBE,
                 os.path.join(out, f"report{i}.json"), *argv],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
    code = wait_all(procs)
    reports = []
    for i in range(len(argvs)):
        path = os.path.join(out, f"report{i}.json")
        reports.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    if code:
        for i in range(len(argvs)):
            with open(os.path.join(out, f"log{i}.txt")) as f:
                print(f"--- process {i}:\n{f.read()[-3000:]}",
                      file=sys.stderr)
    return code, reports, time.perf_counter() - t0


def launcher_tp_run(args, env) -> int:
    """Path 7: ``--nodes N --n-model 2`` on one process a card, every
    process exiting 0; process 0 alone writing the snapshot, which holds
    every tensor whole (the one card's shapes); the weights within 2⁻⁸
    of the same command on one card; the snapshot resumed on one card.
    Prints one JSON line."""
    import tempfile

    import numpy as np
    from znicz_tpu_torch.resilience.supervisor import newest_good_snapshot
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    env = dict(env, PYTHONPATH=HERE + os.pathsep
               + env.get("PYTHONPATH", ""))
    out = {"ok": False}
    with tempfile.TemporaryDirectory(prefix="parallel_cards_tp_") as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("tp", "one", "resumed")}
        for d in dirs.values():
            os.makedirs(d)
        coordinator = f"127.0.0.1:{free_port()}"
        code, reports, seconds = run_cli(
            [tp_command(args, dirs["tp"], "--listen" if r == 0
                        else "--master", coordinator, "--nodes",
                        str(args.ranks), "--process-id", str(r),
                        "--n-model", "2") for r in range(args.ranks)],
            dirs["tp"], env)
        code_one, _, one_s = run_cli(
            [tp_command(args, dirs["one"])], dirs["one"], env)
        got_path, want_path = (newest_good_snapshot(dirs["tp"]),
                               newest_good_snapshot(dirs["one"]))
        out.update(exit_code=code, one_exit_code=code_one,
                   seconds=seconds, one_seconds=one_s,
                   snapshot_writes=[r and r["snapshot_writes"]
                                    for r in reports],
                   launches=[r and r["launches"] for r in reports])
        if code or code_one or not got_path or not want_path:
            print(json.dumps({"launcher_tp": out}), flush=True)
            return 1
        got = Snapshotter.load(got_path)["__units__"]
        want = Snapshotter.load(want_path)["__units__"]
        shapes = {(u, k): np.shape(v) for u, st in want.items()
                  for k, v in st.items() if isinstance(v, np.ndarray)}
        whole = shapes == {(u, k): np.shape(v) for u, st in got.items()
                           for k, v in st.items()
                           if isinstance(v, np.ndarray)}
        rel = {}
        for unit, st in want.items():
            for name in ("weights", "bias"):
                if isinstance(st.get(name), np.ndarray):
                    w = st[name].astype(np.float64)
                    g = np.asarray(got[unit][name], np.float64)
                    rel[f"{unit}.{name}"] = float(
                        np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                                    1e-30))
        code_res, _, res_s = run_cli(
            [tp_command(args, dirs["resumed"], "-s", got_path, "--root",
                        "dist.max_epochs=3" if args.cpu
                        else "alexnet.max_epochs=2")], dirs["resumed"], env)
        worst = max(rel, key=rel.get)
        writes = out["snapshot_writes"]
        out.update(whole_shapes=whole, vs_one_worst=(worst, rel[worst]),
                   resumed_exit_code=code_res, resumed_seconds=res_s,
                   parameters=len(rel))
        launched = args.cpu or all(all(v > 0 for v in r["launches"].values())
                                   for r in reports)
        out["ok"] = bool(whole and rel[worst] <= TOL and not code_res
                         and writes[0] > 0 and not any(writes[1:])
                         and launched)
    print(json.dumps({"launcher_tp": out}), flush=True)
    return 0 if out["ok"] else 1


# ----------------------------------------------------------------------
# gang: an elastic gang, one process a card
# ----------------------------------------------------------------------
def gang(args, tmp: str, shard_dir: str, tag: str, n: int, faults=None,
         initial=None, max_restarts: int = 1):
    """A supervised gang of ``n`` ``elastic_worker`` processes (one card
    each, or gloo with ``--cpu``), its spawns timed."""
    from znicz_tpu_torch.resilience import supervisor as sup
    work = os.path.join(tmp, tag)
    snaps = os.path.join(work, "snaps")

    def argv_for(pid, count, attempt):
        return [sys.executable, "-m",
                "znicz_tpu_torch.resilience.elastic_worker",
                os.path.join(work, f"digest_a{attempt}_p{pid}.json"),
                shard_dir]

    g = sup.ElasticSupervisor(
        argv_for, n_processes=n, work_dir=work, snapshot_dir=snaps,
        snapshot_prefix="elastic", heartbeat_timeout_s=120.0,
        start_grace_s=300.0, poll_interval_s=0.1, drain_s=120.0,
        max_restarts=max_restarts, initial_snapshot=initial,
        env={"PYTHONPATH": HERE + os.pathsep
             + os.environ.get("PYTHONPATH", ""),
             "OMP_NUM_THREADS": "1",
             "ZNICZ_ELASTIC_PLATFORM": "cpu" if args.cpu else "cuda",
             "ZNICZ_ELASTIC_SNAPSHOT_DIR": snaps,
             "ZNICZ_ELASTIC_BATCH": str(GANG_BATCH),
             "ZNICZ_COLLECTIVE_TIMEOUT_S": "600",
             "ZNICZ_HEARTBEAT_INTERVAL_S": "0.2"},
        fault_env=({"ZNICZ_ELASTIC_FAULTS": json.dumps(faults)}
                   if faults else None))
    g.spawned = []
    spawn = g._spawn

    def timed_spawn(*a, **kw):
        g.spawned.append(time.perf_counter())
        return spawn(*a, **kw)

    g._spawn = timed_spawn
    return g


def digests(g, attempt: int, n: int) -> list:
    out = []
    for pid in range(n):
        path = os.path.join(g.work_dir, f"digest_a{attempt}_p{pid}.json")
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def gang_drill(args, tmp: str, shard_dir: str, arm: str, faults) -> dict:
    """One drill: a gang of N that loses process N − 1, restarted on
    N − 1 survivors, then a gang of N − 1 resumed from the restart's
    snapshot; the restarted weights must equal the reference's to the
    bit, on every survivor, and one more step must capture nothing."""
    n = args.ranks
    drill = gang(args, tmp, shard_dir, arm, n, faults)
    t0 = time.perf_counter()
    summary = drill.run()
    end = time.perf_counter()
    resume = summary.get("resume_snapshots", [None, None])[-1]
    ref = gang(args, tmp, shard_dir, f"{arm}_ref", n - 1, initial=resume,
               max_restarts=0)
    ref_summary = ref.run()
    ref_end = time.perf_counter()
    got = digests(drill, 1, n - 1) if summary.get("ok") else []
    want = digests(ref, 0, n - 1) if ref_summary.get("ok") else []
    res = {"losses": summary.get("losses"),
           "restarts": summary.get("restarts"),
           "final_processes": summary.get("final_processes"),
           "resume": os.path.basename(resume or ""),
           "resumed_step": summary.get("resumed_step"),
           "seconds": end - t0,
           "restart_spawn_to_exit_s": (end - drill.spawned[-1]
                                       if len(drill.spawned) > 1 else None),
           "reference_spawn_to_exit_s": ref_end - ref.spawned[0],
           "devices": [d["device"] for d in got],
           "warmed_step_captures": [d["warmed_step_captures"]
                                    for d in got],
           "weights_sha256": sorted({d["weights_sha256"][:12]
                                     for d in got}),
           "reference_sha256": sorted({d["weights_sha256"][:12]
                                       for d in want})}
    want_loss = "loss" if "host.loss" in faults else "preempt"
    res["ok"] = bool(
        summary.get("ok") and ref_summary.get("ok")
        and summary.get("restarts") == 1
        and res["losses"] == {want_loss: 1}
        and res["final_processes"] == n - 1 and len(got) == n - 1
        and all(d["resumed_from"] == resume and d["n_processes"] == n - 1
                for d in got)
        and res["warmed_step_captures"] == [0] * (n - 1)
        and len(res["weights_sha256"]) == 1
        and res["weights_sha256"] == res["reference_sha256"]
        and (args.cpu or sorted(res["devices"])
             == [f"cuda:{i}" for i in range(n - 1)])
        and (want_loss != "preempt" or "preempt_s" in res["resume"]))
    return res


def gang_run(args, env) -> int:
    """Path 8: both drills of ``tests/test_torch_elastic.py`` with N
    processes, one card each: ``host.loss`` on process N − 1 at step 25
    (the survivors blocked in its collective are stopped by the
    supervisor, which restarts N − 1 from the newest good snapshot) and
    ``host.preempt`` on process N − 1 at step 23 (a checkpoint at the
    barrier, then the restart).  Prints one JSON line."""
    import tempfile
    if args.ranks < 2 or GANG_BATCH % args.ranks \
            or GANG_BATCH % (args.ranks - 1):
        raise SystemExit(f"gang: {args.ranks} processes do not split a "
                         f"minibatch of {GANG_BATCH} before and after a "
                         f"loss")
    out = {}
    import chip_smoke as smoke
    with tempfile.TemporaryDirectory(prefix="parallel_cards_gang_") as tmp:
        shard_dir = smoke.drill_shards(tmp)
        last = args.ranks - 1
        out["host_loss"] = gang_drill(
            args, tmp, shard_dir, "loss",
            {"host.loss": {"process": last, "at": [25]}})
        out["preemption"] = gang_drill(
            args, tmp, shard_dir, "preempt",
            {"host.preempt": {"process": last, "at": [23]}})
    ok = all(arm["ok"] for arm in out.values())
    out["ok"] = ok
    print(json.dumps({"gang": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
