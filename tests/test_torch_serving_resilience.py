"""The port's serving resilience on the CPU, against the reference: the
engine's fault sites, deadlines and retries, the sampled SDC shadow
audit, the batcher's tenancy, request traces and the journal.

One blob classifier trained by the reference (``tests/
test_resilience_serving.py``'s bundle) serves through the port's
``ServingEngine(device="cpu")``; replies are held to the reference's
``ExportedModel`` within 1e-5 (f32, summation order only):

- the engine tests of ``tests/test_resilience_serving.py`` (its
  ``/healthz`` and ``/readyz`` tests are ``tests/test_torch_web_status.
  py``'s):
  coalesced replies with expired rows mixed in, a deadlined request's
  rows never dispatched, ``serving.program_error`` retried to success,
  ``serving.latency_spike`` expiring a deadlined request queued behind
  it — each fired site counted on ``znicz_faults_injected_total``;
- the audit: a clean run at rate 1 audits every batch with no
  mismatch, as the reference's engine does on the same traffic; a
  planted ``sdc.serving_bitflip`` is corrected from the oracle, marks
  the engine suspect and calls the hook once; the oracle follows a swap;
- the batcher's priority classes (strict priority, the newest
  lower-priority rows preempted when the queue is full) and
  ``tenant_max_rows``;
- every served request has a trace with its ``queue`` and ``decode``
  (dispatch) phases, a breaker transition and a swap are journaled.
"""

import threading

import numpy as np
import pytest

from conftest import make_blobs
from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefModel
from znicz_tpu.loader.fullbatch import ArrayLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow
from znicz_tpu.serving import ServingEngine as RefEngine
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.export import ExportedModel, read_bundle
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.observe.recorder import FlightRecorder, set_recorder
from znicz_tpu_torch.observe.tracing import TRACER
from znicz_tpu_torch.serving import (ContinuousBatcher, DeadlineExceeded,
                                     Overloaded, QueueFull, ServingEngine)
from znicz_tpu_torch.utils.config import reset_root, root

TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    data, labels = make_blobs(48, 4, 12)
    ref_prng.seed_all(5)
    wf = StandardWorkflow(
        name="resil_serve",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:160], train_labels=labels[:160],
            valid_data=data[160:], valid_labels=labels[160:],
            minibatch_size=32),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 4},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        ],
        decision_config={"max_epochs": 2})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    path = str(tmp_path_factory.mktemp("resil") / "resil_serve.npz")
    wf.export_forward(path)
    return path, data


# ----------------------------------------------------------------------
# the reference's engine tests
# ----------------------------------------------------------------------
def test_engine_coalesced_results_oracle_equal_with_expired_rows(bundle):
    """Some requests expire in the queue; the survivors' coalesced
    replies still match the reference, one request at a time (no padded
    row leaks, no row shifts from the eviction)."""
    path, data = bundle
    ref = RefModel.load(path, device=XLADevice(), max_batch=16)
    requests = [np.ascontiguousarray(data[i * 4:i * 4 + 2])
                for i in range(6)]
    oracle = [np.asarray(ref(x), np.float32) for x in requests]
    model = ExportedModel.load(path, device="cpu", max_batch=16)
    # 6 × 2 rows = 12 < max_batch: nothing flushes a full bucket
    # before the odd requests' deadlines pass inside the window
    engine = ServingEngine(model, max_batch=16, max_delay_ms=250.0)
    engine.start()
    try:
        futures = [engine.submit(x, deadline_ms=20 if i % 2 else None)
                   for i, x in enumerate(requests)]
        for i, f in enumerate(futures):
            if i % 2:
                with pytest.raises(DeadlineExceeded):
                    f.result(timeout=30)
            else:
                np.testing.assert_allclose(f.result(timeout=30), oracle[i],
                                           rtol=0, atol=TOL,
                                           err_msg=f"req {i}")
        st = engine.stats()
    finally:
        engine.shutdown()
    assert st["resilience"]["expired"] == 3
    assert st["resilience"]["breaker"] == "closed"
    assert sum(b["rows"] for b in st["buckets"].values()) == 6


def test_engine_deadline_rows_never_dispatch_and_stats(bundle):
    path, data = bundle
    engine = ServingEngine(path, max_batch=8, max_delay_ms=500.0,
                           device="cpu")
    engine.start()
    try:
        served = metrics.serving_requests(engine._obs_id, "served")
        with pytest.raises(DeadlineExceeded):
            engine.submit(data[:2], deadline_ms=30).result(timeout=10)
        assert served.value == 0  # nothing reached a program
        assert metrics.serving_requests(engine._obs_id,
                                        "expired").value == 1
        assert engine.ready()
        assert engine.serving_status()["backend"] == "cpu"
    finally:
        engine.shutdown()
    assert not engine.ready()


def test_engine_injected_program_error_retried_to_success(bundle):
    """``serving.program_error`` fails the first dispatch; the retry
    budget runs it again and the caller never notices."""
    path, data = bundle
    root.common.engine.faults = {"serving.program_error": {"at": [1]}}
    injected = metrics.faults_injected("serving.program_error").value
    retries = metrics.recoveries("serving_retry").value
    want = np.asarray(RefModel.load(path, device=XLADevice())(data[:3]))
    engine = ServingEngine(path, max_batch=8, max_delay_ms=2.0,
                           device="cpu", retry_budget=1)
    engine.start()
    try:
        out = engine(data[:3], timeout=60)
        st = engine.stats()
    finally:
        engine.shutdown()
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    assert st["resilience"]["retried"] == 1 and st["served"] == 1
    assert metrics.faults_injected("serving.program_error").value == \
        injected + 1
    assert metrics.recoveries("serving_retry").value == retries + 1


def test_engine_latency_spike_expires_deadlined_request(bundle):
    """An injected latency spike holds the scheduler; a deadlined
    request queued behind it fails fast, and its rows never reach a
    program."""
    path, data = bundle
    root.common.engine.faults = {
        "serving.latency_spike": {"at": [1], "ms": 300}}
    injected = metrics.faults_injected("serving.latency_spike").value
    engine = ServingEngine(path, max_batch=8, max_delay_ms=1.0,
                           device="cpu")
    engine.start()
    try:
        slow = engine.submit(data[:2])  # rides the spiked dispatch
        while engine._batcher.queue_rows:  # taken into the dispatch
            pass
        doomed = engine.submit(data[2:5], deadline_ms=60)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
        assert slow.result(timeout=30).shape == (2, 4)
        st = engine.stats()
    finally:
        engine.shutdown()
    assert st["buckets"] == {2: {"batches": 1, "rows": 2,
                                 "occupancy_pt": 100.0}}
    assert st["resilience"]["expired"] == 1
    assert metrics.faults_injected("serving.latency_spike").value == \
        injected + 1


# ----------------------------------------------------------------------
# the sampled SDC shadow audit
# ----------------------------------------------------------------------
def _traffic(data):
    return [data[i:i + n] for i, n in ((0, 1), (4, 3), (10, 8), (20, 2),
                                       (30, 5))]


def test_clean_audit_at_rate_one_as_the_reference(bundle):
    path, data = bundle
    with RefEngine(path, max_batch=8, max_delay_ms=1.0,
                   device=XLADevice(), shadow_audit_rate=1.0) as ref:
        for x in _traffic(data):
            ref(x, timeout=60)
        want = ref.stats()["resilience"]["sdc"]
    with ServingEngine(path, max_batch=8, max_delay_ms=1.0, device="cpu",
                       shadow_audit_rate=1.0) as eng:
        for x in _traffic(data):
            eng(x, timeout=60)
        sdc = eng.stats()["resilience"]["sdc"]
    assert want == {"audit_rate": 1.0, "suspect": False, "audited": 5,
                    "mismatched": 0}
    assert {k: sdc[k] for k in want} == want
    assert sdc["audit_ms_mean"] > 0.0


def test_planted_bitflip_corrected_suspect_hook_once(bundle):
    path, data = bundle
    root.common.engine.faults = {
        "sdc.serving_bitflip": {"at": [2], "factor": 64.0}}
    root.common.serving.sdc_audit_rate = 0.5
    oracle = ExportedModel.load(path, device="numpy")
    detected = metrics.sdc_detected("serving").value
    hooked = []
    with ServingEngine(path, max_batch=8, max_delay_ms=1.0,
                       device="cpu") as eng:
        eng.on_sdc_suspect = hooked.append
        assert eng.shadow_audit_rate == 0.5 and eng.sdc_audit_rtol == 0.05
        replies = [eng(x, timeout=60) for x in _traffic(data)]
        sdc = eng.stats()["resilience"]["sdc"]
        suspects = metrics.sdc_suspects(0, eng.sdc_replica).value
    # the second batch's flip was audited (the rate accumulator reached
    # 1), corrected from the oracle; every batch after it audits
    np.testing.assert_array_equal(replies[1], oracle(_traffic(data)[1]))
    for got, x in zip(replies, _traffic(data)):
        np.testing.assert_allclose(got, oracle(x), rtol=0, atol=TOL)
    assert sdc["suspect"] and sdc["mismatched"] == 1
    assert sdc["audited"] == 4  # batch 2, then 3–5 as a suspect
    assert hooked == [eng]
    assert suspects == 1
    assert metrics.sdc_detected("serving").value == detected + 1


def test_audit_oracle_follows_a_swap(bundle, tmp_path):
    path, data = bundle
    manifest, params = read_bundle(path)
    shifted = {k: (v + np.float32(0.25) if k.endswith("bias") else v)
               for k, v in params.items()}
    with ServingEngine(path, max_batch=8, max_delay_ms=1.0, device="cpu",
                       shadow_audit_rate=1.0) as eng:
        eng(data[:2], timeout=60)
        first = eng._shadow_oracle()
        eng.swap_weights((manifest, shifted))
        got = eng(data[:2], timeout=60)
        assert eng._shadow_oracle() is not first
        sdc = eng.stats()["resilience"]["sdc"]
    assert sdc["audited"] == 2 and sdc["mismatched"] == 0
    np.testing.assert_allclose(
        got, ExportedModel(manifest, shifted, device="numpy")(data[:2]),
        rtol=0, atol=TOL)


# ----------------------------------------------------------------------
# tenancy
# ----------------------------------------------------------------------
def _held_batcher(**kwargs):
    """A batcher whose dispatches wait for ``release`` (so the queue
    holds), recording each batch's (tenant, priority, rows)."""
    dispatched, release = [], threading.Event()

    def run_batch(reqs):
        assert release.wait(60)
        dispatched.append([(r.tenant, r.priority, r.n) for r in reqs])
        for r in reqs:
            r.future.set_result(r.n)

    b = ContinuousBatcher(run_batch, max_delay_ms=60_000.0,
                          max_queue_age_ms=None, **kwargs)
    return b, dispatched, release


def test_priority_classes_and_preemption():
    b, dispatched, release = _held_batcher(max_batch=8, max_queue=8)
    try:
        low = [b.submit(np.zeros((2, 1)), tenant="bulk", priority=5)
               for _ in range(4)]
        assert b.queue_rows == 8 and b.tenant_rows("bulk") == 8
        # full: a high-priority request preempts the NEWEST low rows
        high = b.submit(np.zeros((3, 1)), tenant="live", priority=0)
        for f in low[2:]:
            with pytest.raises(Overloaded, match="preempted"):
                f.result(timeout=10)
        assert b.queue_rows == 7 and b.shed_total == 2
        # nothing lower to preempt for a bulk request: plain backpressure
        with pytest.raises(QueueFull, match="queue full"):
            b.submit(np.zeros((2, 1)), tenant="bulk", priority=5)
        b.flush()
        release.set()
        assert high.result(timeout=10) == 3
        assert [f.result(timeout=10) for f in low[:2]] == [2, 2]
    finally:
        release.set()
        b.shutdown(timeout=10)
    # strict priority: the high request leads its dispatch
    assert dispatched[0][0] == ("live", 0, 3)
    assert sorted(sum(dispatched, [])) == [("bulk", 5, 2), ("bulk", 5, 2),
                                           ("live", 0, 3)]


def test_tenant_max_rows_bounds_one_tenant():
    b, dispatched, release = _held_batcher(max_batch=16, max_queue=64)
    try:
        a = [b.submit(np.zeros((3, 1)), tenant="a", tenant_max_rows=6)
             for _ in range(2)]
        with pytest.raises(QueueFull, match="tenant 'a' queue bound"):
            b.submit(np.zeros((1, 1)), tenant="a", tenant_max_rows=6)
        other = b.submit(np.zeros((5, 1)), tenant="b", tenant_max_rows=6)
        assert b.tenant_rows("a") == 6 and b.tenant_rows("b") == 5
        b.flush()
        release.set()
        assert [f.result(timeout=10) for f in a + [other]] == [3, 3, 5]
    finally:
        release.set()
        b.shutdown(timeout=10)
    assert b.tenant_rows("a") == 0


# ----------------------------------------------------------------------
# request traces and the journal
# ----------------------------------------------------------------------
def test_every_served_request_is_traced(bundle, tmp_path):
    path, data = bundle
    rec = FlightRecorder(str(tmp_path / "journal"))
    set_recorder(rec)
    mark = TRACER.mark()
    try:
        with ServingEngine(path, max_batch=8, max_delay_ms=1.0,
                           device="cpu") as eng:
            futures = [eng.submit(x, tenant="t") for x in _traffic(data)]
            for f in futures:
                f.result(timeout=60)
            eng.swap_weights(path)
            ok = metrics.trace_requests(eng._obs_id, "ok").value
    finally:
        set_recorder(None)
    events = TRACER.to_chrome_trace(mark)["traceEvents"]
    roots = [ev for ev in events if ev.get("cat") == "request"
             and ev["args"].get("parent_span_id") == 0]
    assert len(roots) == len(futures) == ok
    for root_span in roots:
        assert root_span["args"]["outcome"] == "ok"
        assert root_span["args"]["tenant"] == "t"
        phases = {ev["args"]["phase"] for ev in events
                  if ev.get("cat") == "request"
                  and ev["args"].get("trace_id")
                  == root_span["args"]["trace_id"]
                  and "phase" in ev["args"]}
        assert phases == {"queue", "decode"}
    assert any(ev["name"] == "serve_batch" for ev in events)
    swaps = rec.dump_since(0, kinds=["swap"])
    assert [(ev["engine"], ev["outcome"], ev["version"]) for ev in swaps] \
        == [(eng._obs_id, "promoted", 1)]


def test_breaker_transition_is_journaled(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    set_recorder(rec)

    def failing(reqs):
        raise RuntimeError("down")

    b = ContinuousBatcher(failing, max_batch=4, max_delay_ms=1.0,
                          max_queue=16, breaker_window=4,
                          breaker_min_samples=2, obs_id="journal#0")
    try:
        for _ in range(2):  # each outcome is recorded before it fails
            with pytest.raises(RuntimeError, match="down"):
                b.submit(np.zeros((1, 1))).result(timeout=10)
        assert b.breaker_state == "open"
        with pytest.raises(Overloaded):
            b.submit(np.zeros((1, 1)))
    finally:
        b.shutdown(timeout=10)
        set_recorder(None)
    opened = [ev for ev in rec.dump_since(0, kinds=["breaker"])
              if ev["to"] == "open"]
    assert opened and opened[0]["engine"] == "journal#0"
