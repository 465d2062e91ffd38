"""Pipeline parallelism over the workflow's chain of units (port of
``znicz_tpu/parallel/pipeline.py``): the forward and backward chain
split into K contiguous stages, scheduled 1F1B (or GPipe) over the M
gradient-accumulation microbatches of an optimizer step.

The schedule builders (:func:`split_stages`, :func:`build_schedule`,
:func:`bubble_fraction`) are the reference's, copied.

:class:`PipelineExecutor` is the reference's **temporal** executor, in
one process: each stage owns a forward region (its forward units, stage
0 led by the loader, whose gather advances the device schedule's cursor
once a microbatch) and a backward region (its backward units in reverse
order, the last stage led by the evaluator) over the same unit objects
as the workflow's ``train_region``.  Backward ops ride the accumulation
phases: microbatch ``m < M − 1`` runs ``("accum", M)`` (gradients summed
into the microbatch buffers, no parameter written), the last runs
``("apply", M)``, so the trained trajectory is ``run_accumulated``'s.
The anomaly guard (and any side unit linked after the backward chain)
trails stage 0's backward, as in the reference: the last op of the
step, the apply phase's, commits the step's verdict after every stage
has applied its update.

Microbatch context: 1F1B interleaves microbatches, so what a step binds
per microbatch (each unit's outputs, errors, the minibatch, the
attention unit's kept autograd graph) is versioned per in-flight
microbatch: before an op, the attributes its microbatch's earlier ops
bound are bound again; after it, those it bound are saved under the
microbatch.  Parameters, momentum, the microbatch sums, the schedule
cursor and the evaluator's sums are written in place and shared, as in
the fused step.

On the card every op is a CUDA graph, one for each ``(F|B, stage,
microbatch)``: its first run is a warm-up on a side stream and a
capture, as :class:`~znicz_tpu_torch.accelerated_units.JitRegion`
captures, and every later optimizer step replays it.  Each microbatch
keeps two sets of bindings: the warm-up's values (what the next op's
warm-up reads, so the first step computes on real data) and the
capture's tensors (what the next op's capture reads, so the replays
chain through the graphs' own memory).  A graph for each microbatch
holds M microbatches of activations, not the ≤ K of the reference's
buffer reuse.  On the CPU the ops run eagerly through the same code.

The bubble is the reference's model: each op's time (CUDA events on the
card, the host clock elsewhere) laid onto the schedule's ticks, a
tick's span its slowest op, the bubble ``Σ_stages (makespan − busy)``.
"""

from __future__ import annotations

import gc
import re
import time

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import JitRegion, _Phase
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.parallel.partition import Stage
from znicz_tpu_torch.utils.logger import Logger


def split_stages(n_layers: int, n_stages: int) -> list[list[int]]:
    """Contiguous balanced split of ``n_layers`` forward indices into
    ``n_stages`` groups (earlier stages take the remainder, as
    ``np.array_split``)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"cannot split {n_layers} layers into {n_stages} stages")
    return [list(chunk) for chunk in
            np.array_split(np.arange(n_layers), n_stages)]


def _local_1f1b(n_stages: int, n_micro: int, stage: int) -> list[tuple]:
    """Stage-local 1F1B: ``min(K−s−1, M)`` warm-up forwards, then F and
    B alternate until the forwards run out, then the backwards drain."""
    warmup = min(n_stages - stage - 1, n_micro)
    ops: list[tuple] = [("F", stage, m) for m in range(warmup)]
    f, b = warmup, 0
    while f < n_micro:
        ops.append(("F", stage, f))
        f += 1
        ops.append(("B", stage, b))
        b += 1
    while b < n_micro:
        ops.append(("B", stage, b))
        b += 1
    return ops


def _local_gpipe(n_stages: int, n_micro: int, stage: int) -> list[tuple]:
    """Stage-local GPipe: every forward, then every backward."""
    return ([("F", stage, m) for m in range(n_micro)]
            + [("B", stage, m) for m in range(n_micro)])


_LOCAL = {"1f1b": _local_1f1b, "gpipe": _local_gpipe}


def build_schedule(n_stages: int, n_micro: int,
                   kind: str = "1f1b") -> list[list[tuple]]:
    """The per-stage local sequences merged into parallel ticks: every
    stage fires its next op once its dependencies are done (``F(s, m)``
    needs ``F(s−1, m)``; ``B(s, m)`` needs ``F(s, m)`` and
    ``B(s+1, m)``); inside a tick backward-bearing stages go first,
    stage-descending."""
    try:
        local = _LOCAL[kind]
    except KeyError:
        raise ValueError(f"unknown pipeline schedule '{kind}' "
                         f"(have: {sorted(_LOCAL)})") from None
    seqs = [local(n_stages, n_micro, s) for s in range(n_stages)]
    ptr = [0] * n_stages
    done: set[tuple] = set()
    ticks: list[list[tuple]] = []
    total = sum(len(s) for s in seqs)
    while len(done) < total:
        fired: list[tuple] = []
        for s in range(n_stages):
            if ptr[s] >= len(seqs[s]):
                continue
            kind_, st, m = op = seqs[s][ptr[s]]
            if kind_ == "F":
                ready = st == 0 or ("F", st - 1, m) in done
            else:
                ready = (("F", st, m) in done
                         and (st == n_stages - 1
                              or ("B", st + 1, m) in done))
            if ready:
                fired.append(op)
        if not fired:
            raise RuntimeError(
                f"pipeline schedule '{kind}' deadlocked at "
                f"{sum(ptr)}/{total} ops — malformed local sequences")
        for op in fired:
            ptr[op[1]] += 1
            done.add(op)
        ticks.append(sorted(fired, key=lambda o: (o[0] == "F", -o[1])))
    return ticks


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The steady-state bubble fraction (K−1)/(M+K−1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _transient(value) -> bool:
    """A value a step binds per microbatch: a tensor, a tuple holding
    one (the attention unit's kept graph), or None (a consumed one)."""
    if value is None or isinstance(value, torch.Tensor):
        return True
    return isinstance(value, tuple) and any(
        isinstance(v, torch.Tensor) for v in value)


class PipelineExecutor(Logger):
    """The temporal pipeline over an initialized ``StandardWorkflow``:
    per-stage forward and backward regions, the merged schedule, the
    microbatch contexts.  :meth:`run_step` takes M train microbatches
    that the caller's loader picks have staged (``run_accum``'s
    contract) and commits one optimizer step."""

    def __init__(self, workflow, n_stages: int, n_micro: int,
                 schedule: str = "1f1b") -> None:
        super().__init__()
        if n_micro < 2:
            raise ValueError(
                "pipeline execution rides the gradient-accumulation "
                "phases: engine.grad_accum (microbatches) must be ≥ 2")
        self.workflow = workflow
        self.n_stages = int(n_stages)
        self.n_micro = int(n_micro)
        self.schedule_kind = schedule
        self.stages = split_stages(len(workflow.forwards), self.n_stages)
        device = workflow.device
        chain = workflow.hot_chain_units()
        n_core = 2 + len(workflow.forwards) + len(workflow.gds)
        # the guard and the units linked after the backward chain
        side = chain[n_core:]
        self.fwd_regions, self.bwd_regions = [], []
        for s, idxs in enumerate(self.stages):
            f_units = [workflow.forwards[i] for i in idxs]
            if s == 0:
                f_units = [workflow.loader] + f_units
            b_units = [workflow.gds[i] for i in reversed(idxs)]
            if s == self.n_stages - 1:
                b_units = [workflow.evaluator] + b_units
            if s == 0:
                b_units = b_units + side
            self.fwd_regions.append(JitRegion(
                f"{workflow.name}_pp_f{s}", f_units, device))
            # the stage's backward region differentiates what this one
            # keeps (the attention unit's graph)
            self.fwd_regions[-1].force_grad = True
            self.bwd_regions.append(JitRegion(
                f"{workflow.name}_pp_b{s}", b_units, device))
        self.units = chain
        self.ticks = build_schedule(self.n_stages, self.n_micro, schedule)
        self._declare_stage_rules()
        #: microbatch → {(id(unit), attr): (unit, value)}: what its ops
        #: bound, as their eager runs (or warm-ups) bound it
        self._ctx: dict[int, dict] = {}
        #: the same for the captured graphs' tensors (the card)
        self._static: dict[int, dict] = {}
        #: (F|B, stage, microbatch) → (graph, launches its capture counted)
        self._graphs: dict[tuple, tuple] = {}
        self.last_makespan = 0.0
        self.last_bubble_seconds = 0.0
        _metrics.pipeline_stages(workflow.name).set(self.n_stages)
        _metrics.grad_accum_microbatches(workflow.name).set(self.n_micro)

    @property
    def graphed(self) -> bool:
        return self.workflow.device.type == "cuda"

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def _declare_stage_rules(self) -> None:
        """Each stage's units as ``Stage(k)`` tags in the workflow's
        partition table, and the leaves already bound tagged."""
        table = getattr(self.workflow, "partition", None)
        if table is None:
            return
        patterns = []
        for s, idxs in enumerate(self.stages):
            units = [self.workflow.forwards[i] for i in idxs] \
                + [self.workflow.gds[i] for i in idxs]
            for unit in units:
                pat = rf"^{re.escape(unit.name)}/"
                table.declare(pat, Stage(s))
                patterns.append((re.compile(pat), s))
        for path, resolved in table.leaves.items():
            for pat, s in patterns:
                if pat.search(path):
                    resolved.stage = s
                    break

    # -- microbatch context ----------------------------------------------
    def _bindings(self) -> dict:
        out = {}
        for unit in self.units:
            for name, value in unit.__dict__.items():
                if _transient(value):
                    out[id(unit), name] = (unit, name, value)
        return out

    @staticmethod
    def _changed(before: dict, after: dict) -> dict:
        return {key: (unit, name, value)
                for key, (unit, name, value) in after.items()
                if key not in before or before[key][2] is not value}

    @staticmethod
    def _bind(ctx: dict | None) -> None:
        for unit, name, value in (ctx or {}).values():
            unit.__dict__[name] = value

    # -- execution ---------------------------------------------------------
    def _op(self, op: tuple):
        kind, s, m = op
        if kind == "F":
            region, phase = self.fwd_regions[s], None
        else:
            region = self.bwd_regions[s]
            phase = ("apply" if m == self.n_micro - 1 else "accum",
                     self.n_micro)
        key, skips, _ = region._prepare()
        with _Phase(phase):
            if not self.graphed:
                self._bind(self._ctx.get(m))
                before = self._bindings()
                region._run_eager(skips)
                self._ctx.setdefault(m, {}).update(
                    self._changed(before, self._bindings()))
            elif op in self._graphs:
                self._bind(self._static.get(m))
                graph, launches = self._graphs[op]
                graph.replay()
                launch_counts.add(launches, 1)
            else:
                self._capture(op, region, skips, m)

    def _capture(self, op, region, skips, m) -> None:
        """The op's warm-up (eagerly on a side stream, over microbatch
        ``m``'s warm-up bindings) and its capture (over its captured
        bindings); the step goes on with the warm-up's values."""
        dev = region.device.torch_device
        self._bind(self._ctx.get(m))
        before = self._bindings()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            region._run_members(skips)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = self._changed(before, self._bindings())
        self._ctx.setdefault(m, {}).update(warm)
        self._bind(self._static.get(m))
        before = self._bindings()
        counts = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        if region._vectors is None:
            region._vectors = region._collect_vectors()
        for vec in region._vectors:
            vec._tracing = True
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                region._run_members(skips, capture=True)
        finally:
            if collecting:
                gc.enable()
            for vec in region._vectors:
                vec._tracing = False
        self._static.setdefault(m, {}).update(
            self._changed(before, self._bindings()))
        self._graphs[op] = (graph, launch_counts.delta(counts))
        launch_counts.restore(counts)  # the capture launched nothing
        _metrics.graph_captures(region.name).inc()
        self._bind(self._ctx[m])

    def run_step(self) -> dict:
        """One optimizer step's schedule; returns its modeled timing
        ``{"makespan": s, "bubble_seconds": s}`` (see the module)."""
        timed = []
        cuda = self.graphed
        for tick in self.ticks:
            row = []
            for op in tick:
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    self._op(op)
                    end.record()
                    row.append((op, start, end))
                else:
                    t0 = time.perf_counter()
                    self._op(op)
                    row.append((op, time.perf_counter() - t0, None))
                if op[0] == "B" and op[1] == 0 and not cuda:
                    self._ctx.pop(op[2], None)  # microbatch drained
            timed.append(row)
        if cuda:
            torch.cuda.synchronize(self.workflow.device.torch_device)
            # the graphs keep their own memory: the warm-up values of
            # the first step are needed no more
            self._ctx.clear()
        busy = [0.0] * self.n_stages
        makespan = 0.0
        for row in timed:
            span = 0.0
            for op, a, b in row:
                dt = a.elapsed_time(b) / 1e3 if cuda else a
                busy[op[1]] += dt
                span = max(span, dt)
            makespan += span
        if not cuda:
            self._ctx.clear()  # nothing leaks across optimizer steps
        bubble = sum(makespan - b for b in busy)
        self.last_makespan = makespan
        self.last_bubble_seconds = bubble
        _metrics.pipeline_bubble_seconds(self.workflow.name).inc(bubble)
        return {"makespan": makespan, "bubble_seconds": bubble}
