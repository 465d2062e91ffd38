"""Training anomaly guard: finite checks on the device, skip rather than
poison (port of ``znicz_tpu/resilience/guard.py``).

One non-finite step (a bad batch, overflowing logits) would otherwise
poison the weights for good.  The design is the reference's, inside the
training step's region (on the card, its CUDA graph):

- the evaluator seeds ``step_flags`` f32[2] = ``[running_ok, loss_ok]``,
  both ``isfinite(step loss)`` (under a data axis, of the loss summed
  over it, so every process agrees);
- every weighted backward unit ANDs ``isfinite(Σ g²)`` of each gradient
  it applies into ``running_ok`` and applies its update only where the
  flag holds (:meth:`GradientDescentBase.apply_param`): a skipped
  tensor keeps its parameter and momentum bit for bit, a finite step
  is bit-equal to the unguarded update;
- this unit runs after the backward chain and keeps ``anomaly_state``
  int32[3] = ``[consecutive streak, loss anomalies, gradient
  anomalies]`` on the device;
- the decision reads the state (``engine.anomaly_check_interval``,
  every step by default; :meth:`AnomalyGuard.poll_state`), turns the
  totals into the registry's
  ``znicz_step_anomalies_total{kind}`` and
  ``znicz_recoveries_total{kind=anomaly_step}``, and after
  ``engine.anomaly_rollback_k`` (5) anomalous steps in a row asks the
  workflow to roll back to its last snapshot
  (:meth:`StandardWorkflow.rollback_to_snapshot`).  On the card that
  read does not wait for the step: each poll queues a copy of the state
  into pinned host memory behind the step and reads the copy the
  previous poll queued, so the host queues the next step while this one
  runs, and the rollback comes one poll later than the reference's.

Every tensor of the guard is a device tensor at a fixed address written
in place, so the step's CUDA graph reads the value of the moment with
no recapture: ``step_flags``, ``anomaly_state``, ``sdc_fingerprint``
f32[5] (:mod:`~znicz_tpu_torch.resilience.integrity`), and the drill
leaves ``fault_inject`` f32[2] (``[loss_add, grad_add]``, made only when
the fault plan configures ``train.nonfinite_loss`` or
``train.nonfinite_grad``) and ``sdc_inject`` f32[2] (made only for
``sdc.flip_param``/``sdc.flip_grad``).  :meth:`host_run`, which stays in
the control graph before the region, arms the leaves by writing them in
place, and only when their value changes.  ``sdc.flip_param`` mutates
this process's stored copy of the first weighted parameter between two
steps (:meth:`_host_flip_param`).

Under gradient accumulation the flags AND across the microbatches of
one optimizer step and the guard commits once, in the apply phase,
then resets the flags to ones.  On the numpy oracle :meth:`numpy_run`
is the reference's.

Gate: ``root.common.engine.anomaly_guard`` (default on), built by
``StandardWorkflow``.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               current_accum_phase)
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.ops.nn_units import as_numpy
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.resilience import integrity as _integrity
from znicz_tpu_torch.utils.config import register_defaults

register_defaults("common", {"engine": {
    "anomaly_guard": True, "anomaly_check_interval": 1,
    "anomaly_rollback_k": 5}})

#: the two training injection sites this unit hosts
TRAIN_SITES = ("train.nonfinite_loss", "train.nonfinite_grad")


class AnomalyGuard(AcceleratedUnit):
    """Region member that commits the step's anomaly verdict, after the
    backward chain (the evaluator has seeded the flags and every
    weighted backward unit has ANDed its gradient check in)."""

    #: per-step transients and process-lifetime totals: none of them
    #: belongs in a snapshot
    SNAPSHOT_EXCLUDE = ("step_flags", "anomaly_state", "fault_inject",
                        "sdc_fingerprint", "sdc_inject")

    def __init__(self, workflow=None, name: str = "anomaly_guard",
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.step_flags: torch.Tensor | None = None
        self.anomaly_state: torch.Tensor | None = None
        self.fault_inject: torch.Tensor | None = None
        self.sdc_fingerprint: torch.Tensor | None = None
        self.sdc_inject: torch.Tensor | None = None
        #: built at initialize where the settings ask for them
        self._want_inject = _faults.site_configured(*TRAIN_SITES)
        self._want_fp = _integrity.enabled()
        self._want_sdc = _faults.site_configured(
            *_integrity.SDC_TRAIN_SITES)
        #: the totals the decision last turned into registry counters
        self._metric_base = (0, 0)
        self._last_inject = (False, False)
        self._last_sdc = (False, False)
        #: :meth:`poll_state`'s pinned copy, the event behind it, and
        #: whether a copy is queued that no poll has read yet
        self._state_host: torch.Tensor | None = None
        self._state_ready = None
        self._state_queued = False

    @property
    def has_fingerprint(self) -> bool:
        """True when the SDC fingerprint is folded (decided at build)."""
        return self._want_fp

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = self.torch_device
        self.step_flags = torch.ones(2, dtype=torch.float32, device=dev)
        self.anomaly_state = torch.zeros(3, dtype=torch.int32, device=dev)
        if self._want_inject:
            self.fault_inject = torch.zeros(2, dtype=torch.float32,
                                            device=dev)
        if self._want_fp:
            self.sdc_fingerprint = torch.zeros(5, dtype=torch.float32,
                                               device=dev)
        if self._want_sdc:
            self.sdc_inject = torch.zeros(2, dtype=torch.float32,
                                          device=dev)
        self._metric_base = (0, 0)
        self._last_inject = (False, False)
        self._last_sdc = (False, False)
        self._state_queued = False

    def state_dict(self, allow_collective: bool = False) -> dict:
        return {}

    def load_state(self, state: dict) -> None:
        pass

    def _on_train(self) -> bool:
        loader = getattr(self.workflow, "loader", None)
        return loader is None or loader.minibatch_class == TRAIN

    def region_key(self) -> tuple:
        # the self-check runs on train steps only; the evaluator keys
        # the region on the minibatch class already, so no new graph
        loader = getattr(self.workflow, "loader", None)
        return (int(loader.minibatch_class) if loader is not None else -1,)

    # -- the host: arm the drill leaves before the step ---------------------
    @torch.no_grad()
    def host_run(self) -> None:
        on_train = self._on_train()
        inj = self.fault_inject
        if inj is not None:
            want = ((_faults.fire("train.nonfinite_loss") is not None,
                     _faults.fire("train.nonfinite_grad") is not None)
                    if on_train else (False, False))
            if want != self._last_inject:
                self._last_inject = want
                inj.copy_(torch.tensor([np.nan if want[0] else 0.0,
                                        np.nan if want[1] else 0.0]))
        sdc = self.sdc_inject
        if sdc is not None:
            from znicz_tpu_torch.parallel.distributed import process_info
            pidx = process_info()[0]
            pay_p = (_faults.fire("sdc.flip_param", process=pidx)
                     if on_train else None)
            if pay_p is not None:
                self._host_flip_param(float(pay_p.get("factor", 2.0 ** 16)))
            pay_g = (_faults.fire("sdc.flip_grad", process=pidx)
                     if on_train else None)
            want_sdc = (False, pay_g is not None)
            if want_sdc != self._last_sdc:
                self._last_sdc = want_sdc
                # ``g * (1 + scale)``: an exact identity when disarmed
                sdc.copy_(torch.tensor([
                    0.0, float(pay_g.get("factor", 2.0 ** 16)) - 1.0
                    if pay_g is not None else 0.0]))

    @torch.no_grad()
    def _host_flip_param(self, factor: float) -> None:
        """Multiply element 0 of the first weighted parameter in this
        process's stored copy, in place, between two steps (the memory
        corruption the sticky self-check localizes)."""
        for gd_unit in getattr(self.workflow, "gds", []):
            fwd = gd_unit.forward_unit
            w = getattr(fwd, "weights", None)
            if not isinstance(w, torch.Tensor):
                continue
            w.view(-1)[0:1].mul_(factor)
            self.warning("sdc.flip_param injected: %s.weights[0] ×%g "
                         "(process-local memory corruption)", fwd.name,
                         factor)
            return

    # -- the commit, inside the step ----------------------------------------
    @torch.no_grad()
    def device_run(self) -> None:
        phase = current_accum_phase()
        if phase is not None and phase[0] != "apply":
            return  # a microbatch that only accumulates commits nothing
        flags = self.step_flags
        ok = flags[0] > 0.5
        loss_ok = flags[1] > 0.5
        st = self.anomaly_state
        one = torch.ones((), dtype=st.dtype, device=st.device)
        zero = torch.zeros((), dtype=st.dtype, device=st.device)
        st.copy_(torch.stack([
            torch.where(ok, zero, st[0] + 1),
            st[1] + torch.where(loss_ok, zero, one),
            st[2] + torch.where(loss_ok & ~ok, one, zero)]))
        fp = self.sdc_fingerprint
        if fp is not None and self._on_train():
            prev, pre = fp[4], fp[2]
            bad = (prev != 0.0) & (torch.abs(pre - prev) > 1e-5 * torch.clamp(
                torch.abs(prev), min=1.0))
            fp.copy_(torch.stack([fp[0], fp[1], fp[2],
                                  fp[3] + bad.float(), fp[0]]))
        if phase is not None:
            # the accumulated step is committed: the next one's first
            # microbatch ANDs into clean flags
            flags.fill_(1.0)

    def numpy_run(self) -> None:
        flags = as_numpy(self.step_flags)
        ok = bool(flags[0] > 0.5)
        loss_ok = bool(flags[1] > 0.5)
        st = as_numpy(self.anomaly_state)
        st[0] = 0 if ok else st[0] + 1
        if not loss_ok:
            st[1] += 1
        elif not ok:
            st[2] += 1
        if self.sdc_fingerprint is not None and self._on_train():
            fp = as_numpy(self.sdc_fingerprint)
            prev, pre = float(fp[4]), float(fp[2])
            if prev != 0.0 and abs(pre - prev) > 1e-5 * max(abs(prev), 1.0):
                fp[3] += 1.0
            fp[4] = fp[0]

    # -- the host's readers -------------------------------------------------
    def read_state(self) -> tuple[int, int, int]:
        """``(streak, loss total, grad total)``: one small read."""
        s = self.anomaly_state.tolist()
        return int(s[0]), int(s[1]), int(s[2])

    def poll_state(self) -> tuple[int, int, int] | None:
        """The state the decision's tick reads.  On the host's own
        memory, :meth:`read_state`.  On the card the state as the
        previous poll left it, and None on a first poll: the copy that
        poll queued behind its step has landed in pinned memory once that
        step is done, and this poll queues the next copy behind the step
        just queued, so the host waits at most for the step before it."""
        if not self._lagged():
            return self.read_state()
        st = self.anomaly_state
        out = None
        if self._state_queued:
            self._state_ready.synchronize()
            s = self._state_host.tolist()
            out = int(s[0]), int(s[1]), int(s[2])
        if self._state_host is None:
            self._state_host = torch.empty(3, dtype=torch.int32,
                                           pin_memory=st.is_cuda)
            self._state_ready = torch.cuda.Event()
        self._state_host.copy_(st, non_blocking=True)
        self._state_ready.record()
        self._state_queued = True
        return out

    def _lagged(self) -> bool:
        """True when :meth:`poll_state` reads a step behind: on the
        card."""
        return self.anomaly_state.device.type == "cuda"

    @torch.no_grad()
    def reset_streak(self) -> None:
        """Zero the streak (after a rollback), keeping the totals the
        metric deltas ride on; in place.  A copy :meth:`poll_state`
        queued before it is dropped: its streak is the one rolled back."""
        self.anomaly_state[0:1].zero_()
        self._state_queued = False

    def read_sdc_fingerprint(self) -> np.ndarray | None:
        """Host copy of the f32[5] fingerprint state, or None."""
        fp = self.sdc_fingerprint
        if fp is None:
            return None
        return fp.detach().cpu().numpy().astype(np.float64)

    @torch.no_grad()
    def reset_sdc_fingerprint(self) -> None:
        """Zero the fingerprint state after an in-process restore of
        older weights, so the next self-check does not false-alarm."""
        if self.sdc_fingerprint is not None:
            self.sdc_fingerprint.zero_()
