"""Ops flight recorder: bounded, crash-safe structured event journal
(copy of ``znicz_tpu/observe/recorder.py``; the on-disk format is the
reference's, so each package reads the other's journal).

Counters say HOW OFTEN something happened; a post-mortem needs to know
WHAT happened, IN WHAT ORDER, CORRELATED WITH WHAT — today that story
lives in stdout logs that die with the process.  The flight recorder
journals every consequential ops event — swap verdicts, canary
rejections, elastic restarts, SDC quarantines, breaker transitions,
autoscaler actions, AOT-cache quarantines — as JSONL with monotone
sequence numbers and trace/step correlation IDs, into a bounded ring
of on-disk segments that ride the snapshot-dir fence conventions:

- the ACTIVE segment is appended+flushed per event (a crash loses at
  most the final partial line, which the reader skips);
- a FULL segment is sealed by writing its ``.sha256`` sidecar strictly
  after the data — a sidecarless segment is the crash window, its
  parseable prefix still counts;
- the oldest sealed segments are deleted past ``max_segments`` — the
  journal is a ring, never an unbounded log.

Failure discipline (the ``observe.recorder_stall`` contract): a
journal write that stalls or fails must NEVER block or fail the
caller — a swap, a dispatch, a restart proceeds identically with a
dead disk underneath; the recorder degrades to counting drops on
``znicz_flightrecord_dropped_total``.

:func:`record` is the module-level hook instrumentation sites call;
:meth:`FlightRecorder.dump_since` is the read API (the reference's
``/flightrecord`` page; the port's web page waits for ROADMAP A12).
All of it is gated on ``root.common.engine.telemetry``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time

from znicz_tpu_torch.observe import metrics as _metrics

__all__ = ["FlightRecorder", "get_recorder", "set_recorder", "record"]

_SEG_PREFIX = "flight_"
_SEG_SUFFIX = ".jsonl"


def _seg_name(idx: int) -> str:
    return f"{_SEG_PREFIX}{idx:06d}{_SEG_SUFFIX}"


def _seg_index(name: str) -> int | None:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


class FlightRecorder:
    """One journal directory: an append-only active segment plus a
    bounded ring of sealed (sha256-sidecarred) predecessors."""

    def __init__(self, directory: str, *, segment_events: int = 256,
                 max_segments: int = 8) -> None:
        self.directory = str(directory)
        self.segment_events = max(1, int(segment_events))
        self.max_segments = max(2, int(max_segments))
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._seg_events = 0
        self._seg_idx = 0
        os.makedirs(self.directory, exist_ok=True)
        existing = self._segments()
        if existing:
            self._seg_idx = existing[-1] + 1
            # resume the sequence past anything already journaled so
            # dump_since(seq) stays monotone across restarts
            for ev in self._read_segment(existing[-1]):
                self._seq = max(self._seq, int(ev.get("seq", 0)))

    # ------------------------------------------------------------------
    # write side
    # ------------------------------------------------------------------
    def record(self, kind: str, /, **fields) -> bool:
        """Journal one event; returns False when the event was dropped
        (write stall/failure) — NEVER raises, never blocks beyond one
        flushed line.  ``kind`` is positional-only so a field named
        ``kind`` cannot collide at the call site."""
        if not _metrics.enabled():
            return False
        from znicz_tpu_torch.resilience import faults as _faults
        try:
            if _faults.fire("observe.recorder_stall") is not None:
                raise OSError("injected flight-recorder write stall")
            with self._lock:
                self._seq += 1
                event = {"t": round(time.time(), 6), "seq": self._seq,
                         "kind": str(kind)}
                for key, val in fields.items():
                    # envelope keys (t/seq/kind) are not overridable
                    if val is not None and key not in event:
                        event[key] = val
                if self._fh is None:
                    path = os.path.join(self.directory,
                                        _seg_name(self._seg_idx))
                    self._fh = open(path, "a")
                self._fh.write(json.dumps(event, default=str) + "\n")
                self._fh.flush()
                self._seg_events += 1
                if self._seg_events >= self.segment_events:
                    self._seal_locked()
        except Exception:  # noqa: BLE001 — a dead disk must not fail a swap
            _metrics.flightrecord_dropped().inc()
            return False
        _metrics.flightrecord_events(kind).inc()
        return True

    def _seal_locked(self) -> None:
        """Seal the active segment: close, sidecar strictly AFTER the
        data, roll to the next index, trim the ring."""
        self._fh.close()
        self._fh = None
        path = os.path.join(self.directory, _seg_name(self._seg_idx))
        digest = hashlib.sha256()
        with open(path, "rb") as fh:
            digest.update(fh.read())
        tmp = path + ".sha256.tmp"
        with open(tmp, "w") as fh:
            fh.write(digest.hexdigest() + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path + ".sha256")
        self._seg_idx += 1
        self._seg_events = 0
        for idx in self._segments()[:-self.max_segments]:
            old = os.path.join(self.directory, _seg_name(idx))
            for victim in (old, old + ".sha256"):
                try:
                    os.remove(victim)
                except OSError:
                    pass

    def flush_seal(self) -> None:
        """Seal the active segment now (tests / shutdown hooks)."""
        with self._lock:
            if self._fh is not None:
                self._seal_locked()

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def _segments(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(i for i in (_seg_index(n) for n in names)
                      if i is not None)

    def _read_segment(self, idx: int) -> list[dict]:
        path = os.path.join(self.directory, _seg_name(idx))
        out: list[dict] = []
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        break  # torn tail of a crash window
        except OSError:
            pass
        return out

    def dump_since(self, seq: int = 0, *, kinds=None,
                   limit: int | None = None) -> list[dict]:
        """Events with ``seq > seq``, oldest first, optionally
        filtered by ``kinds`` and capped at the LAST ``limit``
        events."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            segments = self._segments()
        events: list[dict] = []
        want = set(kinds) if kinds else None
        for idx in segments:
            for ev in self._read_segment(idx):
                if int(ev.get("seq", 0)) <= seq:
                    continue
                if want is not None and ev.get("kind") not in want:
                    continue
                events.append(ev)
        events.sort(key=lambda ev: int(ev.get("seq", 0)))
        if limit is not None and len(events) > limit:
            events = events[-limit:]
        return events

    def verify(self) -> dict:
        """Digest-check every sealed segment; the active (sidecarless)
        one is the crash window and counts ``open``."""
        good = bad = open_ = 0
        for idx in self._segments():
            path = os.path.join(self.directory, _seg_name(idx))
            side = path + ".sha256"
            if not os.path.exists(side):
                open_ += 1
                continue
            digest = hashlib.sha256()
            try:
                with open(path, "rb") as fh:
                    digest.update(fh.read())
                with open(side) as fh:
                    want = fh.read().strip()
                good += 1 if digest.hexdigest() == want else 0
                bad += 0 if digest.hexdigest() == want else 1
            except OSError:
                bad += 1
        return {"sealed_good": good, "sealed_bad": bad, "open": open_}

    def status(self) -> dict:
        with self._lock:
            return {"dir": self.directory, "seq": self._seq,
                    "segments": len(self._segments()),
                    "dropped": int(
                        _metrics.flightrecord_dropped().value)}


# ----------------------------------------------------------------------
# the process-global recorder instrumentation sites write through
# ----------------------------------------------------------------------
_RECORDER: FlightRecorder | None = None
_RECORDER_LOCK = threading.Lock()


def set_recorder(recorder: FlightRecorder | None) -> None:
    """Install (or clear) the process recorder explicitly — dryruns
    and chaos drills point it at their scratch directory."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = recorder


def get_recorder() -> FlightRecorder | None:
    """The process recorder, created lazily under the telemetry gate.
    Journal directory: ``root.common.engine.flight_dir`` when set,
    else ``<tmp>/znicz_flight_<pid>`` (bounded either way)."""
    global _RECORDER
    if not _metrics.enabled():
        return _RECORDER  # an explicitly installed recorder still reads
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                from znicz_tpu_torch.utils.config import root
                directory = root.common.engine.get("flight_dir", None)
                if not directory:
                    directory = os.path.join(
                        tempfile.gettempdir(),
                        f"znicz_flight_{os.getpid()}")
                try:
                    _RECORDER = FlightRecorder(str(directory))
                except OSError:
                    _metrics.flightrecord_dropped().inc()
                    return None
    return _RECORDER


def record(kind: str, /, **fields) -> bool:
    """Module-level journal hook: one line per consequential ops
    event.  No-op (False) when telemetry is off; never raises."""
    if not _metrics.enabled():
        return False
    rec = get_recorder()
    if rec is None:
        return False
    return rec.record(kind, **fields)
