"""One rank of a spawned gloo world for the port's parallel tests.

Run as ``python tests/torch_parallel_worker.py <mode> <rank> <world>
<init file> <out file>``: it joins the world through a ``file://``
store (no port), runs every check of ``<mode>``, and pickles their
results into ``<out file>``; ``tests/test_torch_parallel.py`` compares
them with the reference.  It imports only numpy, torch and the port, so
the children never import the test modules (and their JAX imports).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

N_CLASSES, DIM = 3, 12


def make_blobs(n_per_class, n_classes, dim, spread=0.35, seed=7):
    """The reference tests' gaussian blobs (``tests/conftest.py``)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, size=(n_classes, dim))
    data = np.concatenate([
        centers[c] + spread * rng.normal(size=(n_per_class, dim))
        for c in range(n_classes)]).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), n_per_class).astype(np.int32)
    order = rng.permutation(len(data))
    return data[order], labels[order]


def build_fc(hidden=16, hidden2=8, gd_extra=None, minibatch_size=24,
             max_epochs=1, model_parallel=False, name="fc"):
    """The reference tests' three-layer net (``test_zero1.build_fc``;
    ``test_parallel.build`` with ``hidden2=None``, ``build_tp`` with
    ``hidden2=12``)."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    data, labels = make_blobs(40, N_CLASSES, DIM)
    gd = {"learning_rate": 0.1, "gradient_moment": 0.9, **(gd_extra or {})}
    col = "column" if model_parallel else None
    row = "row" if model_parallel else None
    layers = [{"type": "all2all_tanh",
               "->": {"output_sample_shape": hidden,
                      **({"model_parallel": col} if col else {})},
               "<-": gd}]
    if hidden2 is not None:
        layers.append({"type": "all2all_tanh",
                       "->": {"output_sample_shape": hidden2,
                              **({"model_parallel": row} if row else {})},
                       "<-": gd})
    layers.append({"type": "softmax",
                   "->": {"output_sample_shape": N_CLASSES}, "<-": gd})
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=minibatch_size),
        layers=layers, decision_config={"max_epochs": max_epochs})
    wf._max_fires = 100_000
    return wf


def params(wf) -> list:
    """Every forward's logical parameters (gathered from their blocks)."""
    out = []
    for fwd in wf.forwards:
        for name in fwd.EXPORT_PARAMS:
            t = getattr(fwd, name, None)
            if t is not None:
                out.append(fwd.full_tensor(name, t).detach().float()
                           .numpy().copy())
    return out


def cpu_device(mesh):
    from znicz_tpu_torch.backends import CpuDevice
    return CpuDevice(torch.device("cpu"), mesh=mesh)


def train(mesh, zero1=False, seed=1234, precision="float32", **kw):
    """One run of :func:`build_fc` on this rank's CPU device over
    ``mesh`` (the device made after the precision is set)."""
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.engine.zero1 = zero1
    root.common.precision_type = precision
    prng.seed_all(seed)
    wf = build_fc(**kw)
    wf.initialize(device=cpu_device(mesh))
    wf.run()
    root.common.precision_type = "float32"
    return wf


def mode_dp(rank, world):
    """Data parallelism over every rank: the reference's
    ``test_parallel`` cases, with the update replicated and ZeRO-1."""
    from znicz_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device_type="cpu")
    dev = cpu_device(mesh)
    out = {}
    for arm, zero1 in (("replicated", False), ("zero1", "auto")):
        wf = train(mesh, zero1=zero1, hidden2=None)
        out[arm] = {"params": params(wf),
                    "err": wf.decision.min_validation_n_err,
                    "local_rows": int(wf.loader.minibatch_data.shape[0]),
                    "zero1": sorted(wf.gds[0].__dict__.get("_zero1", {}))}
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.engine.zero1 = "auto"
    prng.seed_all(1234)
    wf = build_fc(hidden2=None, max_epochs=2)
    wf.initialize(device=dev)
    wf.run_chunked(4)
    out["chunked"] = params(wf)
    root.common.engine.grad_accum = 2
    prng.seed_all(1234)
    wf = build_fc(hidden2=None)
    wf.initialize(device=dev)
    wf.run_accumulated(2)
    root.common.engine.grad_accum = 1
    out["accumulated"] = params(wf)
    wf = build_fc(minibatch_size=21, hidden2=None)
    wf.initialize(device=dev)
    out["clamped"] = wf.loader.max_minibatch_size
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    tiny = StandardWorkflow(
        name="tiny",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=np.zeros((3, 6), np.float32),
            train_labels=np.zeros(3, np.int32), minibatch_size=3),
        layers=[{"type": "softmax", "->": {"output_sample_shape": 2}}],
        decision_config={"max_epochs": 1})
    try:
        tiny.initialize(device=dev)
        out["unshardable"] = None
    except ValueError as exc:
        out["unshardable"] = str(exc)
    from znicz_tpu_torch.parallel import process_shard
    part = np.array([rank + 2.0 ** -40, -1e300 * (rank == 0), 3.0],
                    np.float64)
    out["process_shard"] = {
        "info": process_shard.process_info(),
        "sum": process_shard.allgather_sum(part),
        "bcast": process_shard.broadcast_from_zero(
            np.arange(3, dtype=np.float64) * np.pi + rank),
        "merged": process_shard.merge_round_robin(
            [10.0 * i + rank for i in range(len(range(rank, 10, world)))],
            rank, world, 10)}
    data, labels = make_blobs(40, N_CLASSES, DIM)
    dropout = StandardWorkflow(
        name="dropout",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data, train_labels=labels, minibatch_size=24),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
                {"type": "dropout", "->": {"dropout_ratio": 0.5}},
                {"type": "softmax", "->": {"output_sample_shape": 3}}],
        decision_config={"max_epochs": 1})
    try:
        dropout.initialize(device=dev)
        out["dropout"] = None
    except ValueError as exc:
        out["dropout"] = str(exc)
    return out


ZERO1_ARMS = {
    "momentum_l2": ({"weights_decay": 0.01}, {}),
    "no_momentum": ({"gradient_moment": 0.0, "weights_decay": 0.01}, {}),
    "l1": ({"weights_decay": 0.01, "l1_vs_l2": 0.7}, {}),
    "clipping": ({"gradient_clip": 0.05, "weights_decay": 0.01}, {}),
    "bf16_state": ({"weights_decay": 0.01}, {"precision": "bfloat16"}),
    "padding": ({}, {"hidden": 13, "hidden2": 7}),
}


def mode_zero1(rank, world):
    """ZeRO-1 against the replicated update on the same mesh, in each of
    the reference's arms; then a ZeRO-1 snapshot taken after one epoch
    and the second epoch it resumes into."""
    from znicz_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device_type="cpu")
    out = {}
    for arm, (gd, kw) in ZERO1_ARMS.items():
        rep = train(mesh, zero1=False, gd_extra=gd, **kw)
        z1 = train(mesh, zero1="auto", gd_extra=gd, **kw)
        plans, accs = [], []
        for unit in z1.gds:
            plan = unit.__dict__.get("_zero1", {}).get("weights")
            plans.append(None if plan is None else
                         (plan.data_shard_dim, plan.data_shard_pad))
            acc = unit.accumulated_gradient_weights
            accs.append(None if acc is None
                        else acc.detach().float().numpy().copy())
        out[arm] = {"replicated": params(rep), "zero1": params(z1),
                    "plans": plans, "accs": accs,
                    "dtype": str(z1.forwards[0].compute_dtype)}
    z1 = train(mesh, zero1="auto", gd_extra={"weights_decay": 0.01})
    state = z1.state_dict(allow_collective=True)
    z1.decision.max_epochs = 2
    z1.decision.complete = False
    z1.run()
    out["snapshot"] = {"state": state, "after": params(z1)}
    out["roundtrip"] = roundtrip(mesh)
    return out


def roundtrip(mesh):
    """A padded ZeRO-1 leaf cut to this rank's shard and gathered back."""
    from znicz_tpu_torch.parallel import partition
    res = partition.materialize(partition.Zero1(), "gd/acc", (10, 6),
                                mesh.size("data"))
    full = torch.arange(60, dtype=torch.float32).reshape(10, 6)
    local = partition.local_slice(full, res, mesh)
    back = partition.gather_full(local, res, mesh)
    return {"pad": res.data_shard_pad, "local": tuple(local.shape),
            "back": back.numpy()}


def mode_tp(rank, world):
    """Tensor parallelism over a 2 × 2 (data, model) mesh: column + row
    against replicated, the local blocks, the export, the refusal of an
    indivisible width, and ZeRO-1 composed with it."""
    from znicz_tpu_torch.export import export_forward
    from znicz_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_data=2, n_model=2, device_type="cpu")
    dev = cpu_device(mesh)
    out_dir = os.environ["ZNICZ_TEST_OUT"]
    out = {}
    for arm, tp in (("replicated", False), ("tp", True)):
        wf = train(mesh, seed=77, hidden2=12, model_parallel=tp)
        out[arm] = {"params": params(wf),
                    "err": wf.decision.min_validation_n_err}
        col, row = wf.forwards[0], wf.forwards[1]
        out[arm]["local"] = {
            "col_weights": tuple(col.weights.shape),
            "col_output": tuple(col.output.shape),
            "row_weights": tuple(row.weights.shape),
            "row_output": tuple(row.output.shape)}
        out[arm]["bundle"] = export_forward(
            wf, os.path.join(out_dir, f"model_{arm}.npz"))
        out[arm]["placements"] = {
            path: (r.spec, r.model_shard_dim)
            for path, r in wf.partition.leaves.items()}
    # the clip's norm is the logical tensor's: summed over the blocks
    clip = {"gradient_clip": 0.05, "weights_decay": 0.01}
    out["clipped"] = {
        arm: params(train(mesh, seed=77, hidden2=12, model_parallel=tp,
                          zero1=zero1, gd_extra=clip))
        for arm, tp, zero1 in (("replicated", False, False),
                               ("tp", True, False),
                               ("tp_zero1", True, "auto"))}
    from znicz_tpu_torch.utils.config import root
    root.common.engine.partition_rules = False
    legacy = train(mesh, seed=77, hidden2=12, model_parallel=True)
    root.common.engine.partition_rules = True
    out["legacy_arm"] = {
        "params": params(legacy),
        "placements": {f"{u.name}/{k}": (r.spec, r.model_shard_dim)
                       for u in legacy.forwards
                       for k, r in u.placements.items()},
        "table": len(legacy.partition.leaves)}
    try:
        build = build_fc(hidden=17, model_parallel=True)
        build.initialize(device=dev)
        out["indivisible"] = None
    except ValueError as exc:
        out["indivisible"] = str(exc)
    # the ring on the model axis (no seq axis), beside data parallelism
    out["ring_on_model_axis"] = ring_unit_step(mesh)
    rep = train(mesh, zero1=False, gd_extra={"weights_decay": 0.01},
                model_parallel=True)
    z1 = train(mesh, zero1="auto", gd_extra={"weights_decay": 0.01},
               model_parallel=True)
    plan = z1.gds[0].__dict__.get("_zero1", {}).get("weights")
    out["dp_tp_zero1"] = {
        "replicated": params(rep), "zero1": params(z1),
        "plan": (plan.data_shard_dim, plan.model_shard_dim),
        "acc_local": tuple(z1.gds[0].accumulated_gradient_weights.shape)}
    # the snapshot gathers both axes' blocks; loaded back onto the mesh
    # (each process cutting its blocks) it goes on as the run does
    state = z1.state_dict(allow_collective=True)
    for wf in (z1, None):
        if wf is None:
            root.common.engine.zero1 = "auto"
            wf = build_fc(gd_extra={"weights_decay": 0.01},
                          model_parallel=True)
            wf.initialize(device=dev)
            wf.load_state(state)
        wf.decision.max_epochs = 2
        wf.decision.complete = False
        wf.run()
        out["dp_tp_zero1"].setdefault("after", []).append(params(wf))
    out["dp_tp_zero1"]["state"] = state
    return out


RING_SHAPE = (2, 64, 2, 8)


def ring_inputs(causal_seed=0):
    rng = np.random.default_rng(5)
    q, k, v, ct = (rng.normal(0, 1, RING_SHAPE).astype(np.float32)
                   for _ in range(4))
    return q, k, v, ct


def mode_ring(rank, world):
    """``ProcessRing`` over the ``seq`` axis: each rank's output and
    gradients of its time block, causal and not."""
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.parallel.ring_attention import (
        ProcessRing, sequence_sharded_attention)
    mesh = make_mesh(n_data=1, n_model=1, n_seq=world, device_type="cpu")
    ring = ProcessRing(mesh.group("seq"))
    q, k, v, ct = ring_inputs()
    t = RING_SHAPE[1] // world
    sl = slice(rank * t, (rank + 1) * t)
    out = {"rank_in_ring": ring.rank}
    for causal in (False, True):
        ql, kl, vl = (torch.from_numpy(a[:, sl].copy()).requires_grad_(True)
                      for a in (q, k, v))
        o = sequence_sharded_attention(ring, ql, kl, vl, causal=causal)
        grads = torch.autograd.grad(o, (ql, kl, vl),
                                    torch.from_numpy(ct[:, sl].copy()))
        out[causal] = [o.detach().numpy()] + [g.numpy() for g in grads]
    out["unit"] = ring_unit_step(mesh)
    return out


def ring_unit_step(mesh):
    """The attention unit with ``seq_parallel`` on ``mesh``: an epoch of
    a tiny sequence classifier (with ``mesh=None``, on one CPU device,
    where the option changes nothing)."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    rng = np.random.default_rng(9)
    x = rng.normal(0, 0.3, size=(32, 8, 8)).astype(np.float32)
    y = rng.integers(0, 3, size=32).astype(np.int32)
    prng.seed_all(17)
    gd = {"learning_rate": 0.05, "gradient_moment": 0.5}
    wf = StandardWorkflow(
        name="ring_unit",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=8),
        layers=[{"type": "attention",
                 "->": {"n_heads": 2, "causal": True,
                        "seq_parallel": True}, "<-": gd},
                {"type": "layer_norm", "->": {}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": gd}],
        decision_config={"max_epochs": 1})
    wf._max_fires = 100_000
    wf.initialize(device=cpu_device(mesh))
    assert (wf.forwards[0].ring is None) == (mesh is None)
    wf.run()
    return params(wf)


def mode_env(rank, world):
    """The env contract: a Launcher built with no flags reads
    ``ZNICZ_*`` and starts the group."""
    from znicz_tpu_torch.launcher import Launcher
    from znicz_tpu_torch.parallel import distributed
    launcher = Launcher(backend="cpu")
    dev = launcher.make_device()
    return {"mode": launcher.mode, "process_info":
            distributed.process_info(), "mesh": dict(dev.mesh.shape),
            "backend": torch.distributed.get_backend()}


def mode_guard(rank, world):
    """The anomaly guard over 2 ranks: a NaN in one rank's block of a
    gradient under ZeRO-1 (after the reduce-scatter) and under tensor
    parallelism (one model block), the fingerprints of the sharded
    tensors beside the logical tensors, and ``run_accumulated(2)`` under
    ZeRO-1 with ``train.nonfinite_grad`` at the second optimizer step."""
    import torch.distributed as dist
    from znicz_tpu_torch.parallel import make_mesh
    from znicz_tpu_torch.parallel.axis import data_axis
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    out = {"fingerprints": {}}
    for arm, (n_data, n_model) in (("zero1", (world, 1)),
                                   ("tp", (1, world))):
        mesh = make_mesh(n_data=n_data, n_model=n_model, device_type="cpu")
        root.common.engine.zero1 = "auto" if arm == "zero1" else False
        prng.seed_all(1234)
        wf = build_fc(hidden2=12, model_parallel=arm == "tp")
        wf.initialize(device=cpu_device(mesh))
        gd = wf.gds[0]
        fwd = gd.forward_unit
        guard = wf.anomaly_guard
        tensors = (fwd.weights, fwd.bias, gd.accumulated_gradient_weights,
                   gd.accumulated_gradient_bias)

        def bits():
            return [t.detach().clone() for t in tensors]

        rng = np.random.default_rng(rank + 5)
        gw = torch.from_numpy(rng.normal(size=tuple(fwd.weights.shape))
                              .astype(np.float32))
        gb = torch.from_numpy(rng.normal(size=tuple(fwd.bias.shape))
                              .astype(np.float32))
        bad = gw.clone()
        if arm == "zero1":
            # the last row along the shard dim: after the reduce-scatter
            # only the last rank's shard holds it
            dim = gd._zero1_for(fwd.weights).data_shard_dim
            if rank == 0:
                bad.select(dim, bad.shape[dim] - 1).fill_(float("nan"))
        elif rank == world - 1:
            bad[0, 0] = float("nan")  # this model block only
        group = wf.device.group("data")
        before = bits()
        guard.step_flags.fill_(1.0)
        with data_axis(group):
            gd.apply_weights(bad)
            gd.apply_bias(gb)
        after = bits()
        flags = guard.step_flags.tolist()
        guard.step_flags.fill_(1.0)
        guard.sdc_fingerprint.zero_()
        w_before = fwd.full_tensor("weights", fwd.weights).detach().clone()
        with data_axis(group):
            gd.apply_weights(gw)
        w_after = fwd.full_tensor("weights", fwd.weights).detach().clone()
        if arm == "zero1":
            logical = gw.clone()
            dist.all_reduce(logical, group=group)
        else:
            logical = fwd.full_tensor("weights", gw)
        fp = guard.sdc_fingerprint.tolist()
        out[arm] = {
            "skipped_unchanged": all(torch.equal(a, b)
                                     for a, b in zip(before, after)),
            "finite_moved": not torch.equal(w_before, w_after),
            "flags": flags}
        for slot, name, value in ((2, "param_before", w_before),
                                  (1, "grad", logical),
                                  (0, "param_after", w_after)):
            out["fingerprints"][f"{arm}.{name}"] = (
                fp[slot], value.numpy().copy())
    mesh = make_mesh(device_type="cpu")
    root.common.engine.zero1 = "auto"
    root.common.engine.grad_accum = 2
    root.common.engine.faults = {"train.nonfinite_grad": {"at": [2]}}
    prng.seed_all(1234)
    wf = build_fc(hidden2=None)
    wf.initialize(device=cpu_device(mesh))
    wf.run_accumulated(2)
    out["accumulated"] = {
        "state": list(wf.anomaly_guard.read_state()),
        "params": params(wf),
        "fingerprint": wf.anomaly_guard.read_sdc_fingerprint().tolist()}
    return out


MODES = {"dp": mode_dp, "zero1": mode_zero1, "tp": mode_tp,
         "ring": mode_ring, "env": mode_env, "guard": mode_guard}


def spawn_world(mode: str, world: int, tmp_dir: str,
                timeout_s: float = 900.0, extra_env: dict | None = None
                ) -> list:
    """Run ``mode`` in a world of ``world`` gloo processes (this script,
    one process a rank, joined through a ``file://`` store under
    ``tmp_dir``) and return each rank's result; raises naming the rank
    and its traceback when one failed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["ZNICZ_TEST_OUT"] = str(tmp_dir)
    env.update(extra_env or {})
    store = os.path.join(str(tmp_dir), f"{mode}.store")
    outs = [os.path.join(str(tmp_dir), f"{mode}.{r}.pkl")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(world), store, outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout_s)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        if not os.path.exists(outs[r]):
            raise RuntimeError(f"{mode} rank {r} wrote no result "
                               f"(exit {proc.returncode}):\n{log[-4000:]}")
        with open(outs[r], "rb") as f:
            got = pickle.load(f)
        if not got["ok"]:
            raise RuntimeError(f"{mode} rank {r} failed:\n{got['error']}")
        results.append(got["result"])
    return results


def main() -> int:
    mode, rank, world, init_file, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from znicz_tpu_torch.parallel import distributed
    from znicz_tpu_torch.utils.config import root
    root.common.dirs.snapshots = os.environ.get("ZNICZ_TEST_OUT", ".")
    try:
        if mode != "env":
            distributed.ensure_initialized(
                num_processes=world, process_id=rank, device_type="cpu",
                init_method=f"file://{init_file}")
        result = {"ok": True, "result": MODES[mode](rank, world)}
    except Exception:  # reported to the test, which fails naming it
        result = {"ok": False, "error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)
    distributed.shutdown()
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
