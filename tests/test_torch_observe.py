"""The port's request tracing (``znicz_tpu_torch.observe.tracing``) and
flight recorder (``znicz_tpu_torch.observe.recorder``) against the
reference's, on the CPU.

- the trace and recorder tests of ``tests/test_obs_round24.py`` run on
  the port: one ``trace_id`` a request, its phases parented complete
  spans, ``phase_begin`` idempotent, ``finish`` closing a dangling
  phase with the first outcome winning, ``NULL_TRACE`` under the
  telemetry gate, the pending-trace channel; the recorder's ring of
  sealed segments, its ``seq`` resumed after a restart, a torn tail
  skipped, and a stalled write (``observe.recorder_stall``) dropped and
  counted, never raised;
- the two packages' traces and journals agree: the same span tree for
  the same phases, and a journal written by either package read back by
  the other event for event (the on-disk format is the reference's);
- ``profile_window`` writes the window's host spans beside the
  profiler's trace.
"""

import json
import os

import pytest

from znicz_tpu.observe import recorder as ref_recorder
from znicz_tpu.observe import tracing as ref_tracing
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.observe import tracing
from znicz_tpu_torch.observe.recorder import (FlightRecorder, get_recorder,
                                              record, set_recorder)
from znicz_tpu_torch.observe.tracing import (NULL_TRACE, TRACER,
                                             RequestTrace,
                                             adopt_pending_trace,
                                             new_request_trace,
                                             profile_window,
                                             set_pending_trace)
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _request_events(tracer, since: int, trace_id: str) -> list:
    return [ev for ev in tracer.to_chrome_trace(since)["traceEvents"]
            if (ev.get("args") or {}).get("trace_id") == trace_id]


# ----------------------------------------------------------------------
# request-scoped tracing
# ----------------------------------------------------------------------
def _span_tree(module):
    mark = module.TRACER.mark()
    tr = module.RequestTrace("request", model="m", tenant="t")
    tr.phase_begin("queue")
    dur = tr.phase_end("queue", engine="e#0")
    assert dur > 0.0
    tr.phase_begin("decode")
    tr.event("fleet_route", version="v1")
    tr.finish("ok")
    events = _request_events(module.TRACER, mark, tr.trace_id)
    roots = [ev for ev in events if ev["ph"] == "X"
             and ev["args"]["parent_span_id"] == 0]
    assert len(roots) == 1
    assert roots[0]["args"]["outcome"] == "ok"
    assert roots[0]["args"]["span_id"] == 1
    assert roots[0]["args"]["model"] == "m"
    phases = {ev["args"]["phase"]: ev for ev in events
              if ev["ph"] == "X" and "phase" in ev["args"]}
    # finish() closed the dangling decode phase
    assert set(phases) == {"queue", "decode"}
    assert all(ev["args"]["parent_span_id"] == 1
               for ev in phases.values())
    instants = [ev for ev in events if ev["ph"] in ("i", "I")]
    assert [ev["name"] for ev in instants] == ["req.fleet_route"]
    assert tr.phases["queue"] == pytest.approx(dur)
    return [(ev["ph"], ev["name"], ev["cat"],
             {k: v for k, v in ev["args"].items() if k != "depth"})
            for ev in events]


def test_request_trace_span_tree_as_the_reference():
    port, ref = _span_tree(tracing), _span_tree(ref_tracing)
    # the same events in the same order, args and all (the trace ids
    # differ by their sequence numbers)
    strip = [(ph, name, cat, {k: v for k, v in args.items()
                              if k != "trace_id"})
             for ph, name, cat, args in port]
    assert strip == [(ph, name, cat, {k: v for k, v in args.items()
                                      if k != "trace_id"})
                     for ph, name, cat, args in ref]


def test_request_trace_idempotent_begin_and_unbegun_end():
    tr = RequestTrace()
    # a phase that never began closes as a no-op
    assert tr.phase_end("prefill") == 0.0
    t0 = tracing.now_us()
    tr.phase_begin("handoff")
    tr.phase_begin("handoff")  # a retry re-entering keeps the FIRST t0
    assert tr._phase_t0["handoff"] <= tracing.now_us()
    first = tr._phase_t0["handoff"]
    assert first >= t0 - 1e3
    tr.phase_begin("handoff")
    assert tr._phase_t0["handoff"] == first
    assert tr.phase_end("handoff") >= 0.0
    tr.finish("failed")
    mark = TRACER.mark()
    tr.finish("ok")  # idempotent: the first outcome won, nothing emitted
    assert not _request_events(TRACER, mark, tr.trace_id)


def test_null_trace_under_gate():
    root.common.engine.telemetry = False
    tr = new_request_trace("request")
    assert tr is NULL_TRACE
    tr.phase_begin("queue")
    assert tr.phase_end("queue") == 0.0
    tr.event("x")
    tr.finish("ok")
    mark = TRACER.mark()
    TRACER.complete("gated", 0.0, 1.0)
    TRACER.instant("gated")
    assert TRACER.mark() == mark
    root.common.engine.telemetry = True
    assert isinstance(new_request_trace("request"), RequestTrace)


def test_pending_trace_adoption_channel():
    tr = RequestTrace()
    set_pending_trace(tr)
    assert adopt_pending_trace() is tr
    # the pop clears: a later submit on the same thread starts clean
    assert adopt_pending_trace() is None


def test_tracer_mark_clear_export(tmp_path):
    TRACER.instant("before")
    mark = TRACER.mark()
    TRACER.complete("window", 10.0, 30.0, cat="test", k=1)
    path = TRACER.export(str(tmp_path / "t.json"), since=mark)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert [ev["name"] for ev in events] == ["process_name", "window"]
    assert events[1]["dur"] == 20.0 and events[1]["args"]["k"] == 1
    with profile_window(str(tmp_path / "prof"), n_steps=3) as out:
        with TRACER.span("inside", cat="test"):
            pass
    names = sorted(os.listdir(out))
    assert "host_spans.trace.json" in names
    with open(os.path.join(out, "host_spans.trace.json")) as fh:
        spans = {ev["name"]: ev for ev in json.load(fh)["traceEvents"]}
    assert {"inside", "profile_window"} <= set(spans)
    assert spans["profile_window"]["args"]["n_steps"] == 3


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------
def test_flight_recorder_ring_seal_verify(tmp_path):
    rec = FlightRecorder(str(tmp_path), segment_events=4,
                         max_segments=2)
    for i in range(20):
        assert rec.record("swap", engine="e#0", outcome="promoted",
                          version=i)
    names = sorted(os.listdir(tmp_path))
    segs = [n for n in names if n.endswith(".jsonl")]
    assert len(segs) <= 3  # ring: max_segments sealed + active
    v = rec.verify()
    assert v["sealed_bad"] == 0 and v["sealed_good"] >= 1
    events = rec.dump_since(0)
    seqs = [ev["seq"] for ev in events]
    assert seqs == sorted(seqs)
    assert seqs[-1] == 20  # the newest survives the ring trim
    # filters: kind + since + limit
    assert rec.dump_since(18) == events[-2:]
    assert len(rec.dump_since(0, kinds=["nope"])) == 0
    assert len(rec.dump_since(0, limit=3)) == 3


def test_flight_recorder_restart_resumes_seq(tmp_path):
    rec = FlightRecorder(str(tmp_path), segment_events=100)
    rec.record("scale", delta=1)
    rec.record("scale", delta=2)
    rec2 = FlightRecorder(str(tmp_path), segment_events=100)
    rec2.record("scale", delta=3)
    seqs = [ev["seq"] for ev in rec2.dump_since(0)]
    assert seqs == sorted(set(seqs))  # monotone across the restart
    assert seqs[-1] > 2


def test_flight_recorder_torn_tail_skipped(tmp_path):
    rec = FlightRecorder(str(tmp_path), segment_events=100)
    rec.record("swap", outcome="promoted")
    seg = os.path.join(str(tmp_path), sorted(os.listdir(tmp_path))[0])
    with open(seg, "a") as fh:
        fh.write('{"t": 1.0, "seq": 99, "kind": "tor')  # crash window
    events = FlightRecorder(str(tmp_path)).dump_since(0)
    assert [ev["kind"] for ev in events] == ["swap"]


def test_flight_recorder_stall_drops_and_recovers(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    dropped = metrics.flightrecord_dropped().value
    root.common.engine.faults = {"observe.recorder_stall": {"at": [1]}}
    assert rec.record("breaker", to="open") is False
    assert rec.record("breaker", to="closed") is True
    root.common.engine.faults = None
    assert metrics.flightrecord_dropped().value == dropped + 1
    kinds = [ev["to"] for ev in rec.dump_since(0)]
    assert kinds == ["closed"]  # the stalled event is GONE, not stuck
    assert rec.status()["dropped"] == dropped + 1


def test_module_hook_and_gate(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    set_recorder(rec)
    try:
        assert get_recorder() is rec
        assert record("swap", engine="e#1", outcome="rejected")
        root.common.engine.telemetry = False
        assert record("swap", engine="e#1", outcome="promoted") is False
        assert get_recorder() is rec  # an installed recorder still reads
    finally:
        set_recorder(None)
    assert [ev["outcome"] for ev in rec.dump_since(0)] == ["rejected"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_read_by_the_other_package(tmp_path, writer):
    """A journal written by either package, sealed segments and an open
    one, reads back event for event in the other, with its digests
    checked and its ``seq`` resumed."""
    mods = {"reference": ref_recorder, "port": __import__(
        "znicz_tpu_torch.observe.recorder", fromlist=["x"])}
    reader = "port" if writer == "reference" else "reference"
    rec = mods[writer].FlightRecorder(str(tmp_path), segment_events=3,
                                      max_segments=4)
    for i in range(7):
        assert rec.record("swap", engine="e#0", outcome="promoted",
                          version=i, pause_ms=0.125 * i)
    written = rec.dump_since(0)
    other = mods[reader].FlightRecorder(str(tmp_path), segment_events=3,
                                        max_segments=4)
    assert other.dump_since(0) == written
    assert other.verify() == rec.verify() == {
        "sealed_good": 2, "sealed_bad": 0, "open": 1}
    assert other.record("breaker", to="open")
    assert other.dump_since(7)[0]["seq"] == 8
    assert rec.dump_since(7, kinds=["breaker"])[0]["to"] == "open"
