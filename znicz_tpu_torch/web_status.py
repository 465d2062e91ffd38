"""Web status: a live page of a process's running workflows and
serving engines (port of ``znicz_tpu/web_status.py``).

Stdlib ``http.server`` on a daemon thread, bound to 127.0.0.1 unless the
caller names another host.  Routes:

- ``/``: a self-refreshing HTML page; ``/status.json``: the same as
  JSON (:func:`gather_status` of each registered workflow, or the
  ``serving_status()`` of a registered engine or fleet);
- ``/healthz``: liveness, always 200;
- ``/readyz``: readiness, read from the metrics registry (so it sees
  exactly what ``/metrics`` exports): 503 while any engine's breaker is
  open; a fleet tenant's breaker is reported but never flips it; the
  queue age, a workflow's last-step staleness, heartbeat ages, snapshot
  and publish ages, the model version, the rows a quarantined shard
  delivered as zeros and the federation's source ages are reported,
  each bounded only when its ``engine.ready_max_*`` setting is set;
- ``/metrics``: the Prometheus text of the port's registry (with
  ``znicz_build_info``); ``/trace.json``: the host-span ring as a
  Chrome trace; ``/flightrecord``: the ops flight recorder's journal
  (``?since=<seq>&kind=<k1,k2>``, the newest 256 events).
"""

from __future__ import annotations

import html
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from znicz_tpu_torch.utils.logger import Logger


def gather_status(workflow) -> dict:
    """One workflow's live status (scalars only, safe to read while it
    trains).  Anything with a ``serving_status`` hook — a
    :class:`~znicz_tpu_torch.serving.ServingEngine`, a
    :class:`~znicz_tpu_torch.serving.DecodeEngine` or a whole
    :class:`~znicz_tpu_torch.serving.FleetEngine` — reports its own."""
    if hasattr(workflow, "serving_status"):
        return workflow.serving_status()
    from znicz_tpu_torch.utils.introspect import (slowest_units,
                                            validation_metrics)
    out: dict = {"name": workflow.name,
                 "initialized": workflow.is_initialized,
                 "stopped": bool(workflow.stopped)}
    loader = getattr(workflow, "loader", None)
    if loader is not None and loader.is_initialized:
        out["epoch"] = int(loader.epoch_number)
        out["total_samples"] = int(loader.total_samples)
        schedule_len = len(loader._schedule)
        if schedule_len:
            out["epoch_progress_pt"] = round(
                100.0 * min(loader._cursor, schedule_len) / schedule_len,
                1)
    out.update(validation_metrics(workflow))
    decision = getattr(workflow, "decision", None)
    if decision is not None:
        out["complete"] = bool(getattr(decision, "complete", False))
    device = getattr(workflow, "device", None)
    if device is not None:
        out["backend"] = device.backend
        mesh = getattr(device, "mesh", None)
        if mesh is not None:
            out["mesh"] = dict(mesh.shape)
    out["slowest_units"] = slowest_units(workflow, n=5)
    return out


class WebStatusServer(Logger):
    """Serves ``/`` (HTML) and ``/status.json`` for every registered
    workflow.  ``port=0`` picks a free port (see :attr:`port`)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        super().__init__()
        self._workflows: list = []
        self._lock = threading.Lock()
        self._started = time.time()
        status_server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                status_server.debug("http: " + fmt, *args)

            def do_GET(self):
                if self.path.startswith("/status.json"):
                    body = json.dumps(status_server.status()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/healthz"):
                    # liveness: the process answers — always 200
                    body = json.dumps(status_server.health()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                elif self.path.startswith("/readyz"):
                    # readiness: fed from the observe registry (breaker
                    # state, queue age, last-step staleness) — 503
                    # tells an external supervisor to stop routing here
                    report = status_server.readiness()
                    body = json.dumps(report).encode()
                    self.send_response(200 if report["ready"] else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                elif self.path.startswith("/metrics"):
                    from znicz_tpu_torch.observe import metrics
                    body = metrics.REGISTRY.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/trace.json"):
                    from znicz_tpu_torch.observe import tracing
                    body = json.dumps(
                        tracing.TRACER.to_chrome_trace()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/flightrecord"):
                    # the ops flight recorder's journal —
                    # ?since=<seq> and ?kind=<k1,k2> filter; newest
                    # 256 events by default so the page stays bounded
                    from urllib.parse import parse_qs, urlparse
                    from znicz_tpu_torch.observe import recorder
                    q = parse_qs(urlparse(self.path).query)
                    since = int(q.get("since", ["0"])[0] or 0)
                    kinds = None
                    if q.get("kind"):
                        kinds = [k for k in
                                 q["kind"][0].split(",") if k]
                    rec = recorder.get_recorder()
                    if rec is None:
                        payload = {"events": [], "status": None}
                    else:
                        events = rec.dump_since(since, kinds=kinds)
                        payload = {"events": events[-256:],
                                   "status": rec.status()}
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                elif self.path == "/" or self.path.startswith("/index"):
                    body = status_server.render_html().encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # every /metrics page exports znicz_build_info (which build a
        # scrape came from); registered here only when nothing richer
        # did
        try:
            from znicz_tpu_torch.observe import metrics as _metrics
            _metrics.set_build_info(fallback=True)
        except Exception:  # noqa: BLE001 — never block the dashboard
            pass
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="web-status",
            daemon=True)
        self._thread.start()
        self.info("web status @ http://%s:%d/", self.host, self.port)

    # ------------------------------------------------------------------
    def register(self, workflow) -> None:
        with self._lock:
            if workflow not in self._workflows:
                self._workflows.append(workflow)

    def unregister(self, workflow) -> None:
        with self._lock:
            if workflow in self._workflows:
                self._workflows.remove(workflow)

    def status(self) -> dict:
        with self._lock:
            workflows = list(self._workflows)
        return {
            "uptime_s": round(time.time() - self._started, 1),
            "workflows": [gather_status(wf) for wf in workflows],
        }

    # -- supervisor probes ----------------------------------------------
    def health(self) -> dict:
        """/healthz body: liveness only — the process is up and the
        status thread answers."""
        with self._lock:
            n = len(self._workflows)
        return {"status": "ok",
                "uptime_s": round(time.time() - self._started, 1),
                "workflows": n}

    def readiness(self) -> dict:
        """/readyz body, fed from the observe REGISTRY (so it reflects
        exactly what ``/metrics`` exports, not object state):

        - ``znicz_serving_breaker_state`` — any ENGINE with an OPEN
          breaker (2) makes the process not-ready (it is shedding
          every caller);
        - ``znicz_fleet_breaker_state`` — per-TENANT fleet
          breakers are reported under ``tenants`` but are
          REPORT-ONLY: an open tenant breaker sheds exactly that
          tenant while every other tenant is served normally, so it
          must not flip a supervisor's routing decision;
        - ``znicz_serving_queue_age_seconds`` — reported per engine;
          not-ready when it exceeds ``engine.ready_max_queue_age_s``
          (default unset = report-only);
        - ``znicz_last_step_timestamp_seconds`` — per-workflow step
          staleness; not-ready when older than
          ``engine.ready_max_staleness_s`` (default unset =
          report-only, so a finished training run does not flip a
          serving process to 503);
        - ``znicz_model_version`` — the live published
          model version per serving engine, reported so a supervisor
          can confirm which weights a replica is actually running;
        - ``znicz_snapshot_age_seconds`` — time since each
          source (snapshotter prefix / publish directory) last wrote a
          GOOD artifact; not-ready when it exceeds
          ``engine.ready_max_snapshot_age_s`` (default unset =
          report-only), so a stalled trainer that stopped publishing
          shows up on the serving probe;
        - ``znicz_loader_rows_quarantined_total`` — rows a
          quarantined shard delivered as zeros, per loader.
          REPORT-ONLY: quarantine-and-continue is degraded, not dead
          — restarting would lose more progress than the zeros cost.
        """
        from znicz_tpu_torch.observe import metrics
        from znicz_tpu_torch.utils.config import root
        now = time.time()
        out: dict = {"ready": True, "reasons": [],
                     "engines": {}, "workflows": {}}

        def not_ready(reason: str) -> None:
            out["ready"] = False
            out["reasons"].append(reason)

        fam = metrics.REGISTRY.get("znicz_serving_breaker_state")
        if fam is not None:
            for key, child in fam.items():
                (engine,) = key
                state = {0: "closed", 1: "half_open",
                         2: "open"}.get(int(child.value), "?")
                out["engines"].setdefault(engine, {})["breaker"] = state
                if state == "open":
                    not_ready(f"breaker open on engine {engine}")
        fam = metrics.REGISTRY.get("znicz_fleet_breaker_state")
        if fam is not None:
            out["tenants"] = {}
            for key, child in fam.items():
                fleet, tenant = key
                state = {0: "closed", 1: "half_open",
                         2: "open"}.get(int(child.value), "?")
                out["tenants"][f"{fleet}/{tenant}"] = state
        fam = metrics.REGISTRY.get("znicz_serving_queue_age_seconds")
        max_age = root.common.engine.get("ready_max_queue_age_s", None)
        if fam is not None:
            for key, child in fam.items():
                # ("engine", "pool") children: /readyz watches the
                # worst pool of an engine
                engine = key[0]
                age = round(float(child.value), 3)
                prior = out["engines"].setdefault(engine, {})
                age = max(age, prior.get("queue_age_s", 0.0))
                prior["queue_age_s"] = age
                if max_age is not None and age > float(max_age):
                    not_ready(f"queue age {age:.1f}s on engine "
                              f"{engine}")
        fam = metrics.REGISTRY.get("znicz_last_step_timestamp_seconds")
        max_stale = root.common.engine.get("ready_max_staleness_s", None)
        if fam is not None:
            for key, child in fam.items():
                (workflow,) = key
                stale = round(max(0.0, now - float(child.value)), 3)
                out["workflows"][workflow] = {"last_step_age_s": stale}
                if max_stale is not None and stale > float(max_stale):
                    not_ready(f"workflow {workflow} last step "
                              f"{stale:.0f}s ago")
        # aggregate pod health — per-process heartbeat ages
        # (fed by the coordinator-side HeartbeatMonitor from the
        # shared channel).  A stale peer makes the POD not ready when
        # engine.ready_max_heartbeat_s is set (unset = report-only:
        # single-host runs and gang supervisors that own restarts
        # themselves must not flip this process's probe).
        fam = metrics.REGISTRY.get("znicz_heartbeat_age_seconds")
        max_hb = root.common.engine.get("ready_max_heartbeat_s", None)
        if fam is not None:
            out["processes"] = {}
            for key, child in fam.items():
                (process,) = key
                age = float(child.value)
                out["processes"][process] = {
                    "heartbeat_age_s": (None if age == float("inf")
                                        else round(age, 3))}
                if max_hb is not None and age > float(max_hb):
                    not_ready(f"process {process} heartbeat "
                              f"{age:.0f}s stale")
        # silent data loss made loud — rows a quarantined
        # shard delivered as ZEROS.  REPORT-ONLY by design: a run that
        # chose quarantine-and-continue is degraded, not dead, and an
        # external supervisor restarting it would lose MORE progress;
        # the row count here (and on /metrics) is the operator signal.
        fam = metrics.REGISTRY.get("znicz_loader_rows_quarantined_total")
        if fam is not None:
            out["loaders"] = {}
            for key, child in fam.items():
                (loader,) = key
                out["loaders"][loader] = {
                    "rows_quarantined": int(child.value)}
        fam = metrics.REGISTRY.get("znicz_model_version")
        if fam is not None:
            for key, child in fam.items():
                (engine,) = key
                out["engines"].setdefault(engine, {})[
                    "model_version"] = int(child.value)
        fam = metrics.REGISTRY.get("znicz_snapshot_age_seconds")
        max_snap = root.common.engine.get("ready_max_snapshot_age_s",
                                          None)
        if fam is not None:
            out["artifacts"] = {}
            for key, child in fam.items():
                (source,) = key
                age = round(float(child.value), 3)
                out["artifacts"][source] = {"age_s": age}
                if max_snap is not None and age > float(max_snap):
                    not_ready(f"no good artifact from {source} for "
                              f"{age:.0f}s")
        # the federated view — when this process folds a
        # gang's children (supervisor/fleet/disagg federators), report
        # each source's scrape staleness; not-ready only when
        # engine.ready_max_fed_age_s is set AND a source is staler
        # (unset = report-only: a paused fold must not 503 a healthy
        # serving process)
        try:
            from znicz_tpu_torch.observe import federation
            feds = federation.status()
        except Exception:  # noqa: BLE001 — probe must answer anyway
            feds = []
        if feds:
            out["federation"] = feds
            max_fed = root.common.engine.get("ready_max_fed_age_s",
                                             None)
            if max_fed is not None:
                worst = federation.max_age_s()
                if worst > float(max_fed):
                    not_ready(f"federated scrape {worst:.1f}s stale")
        return out

    # ------------------------------------------------------------------
    def render_html(self) -> str:
        status = self.status()
        rows = []
        for wf in status["workflows"]:
            metrics = {k: v for k, v in wf.items()
                       if k not in ("name", "slowest_units")}
            timing = "".join(
                f"<li>{html.escape(t['unit'])}: {t['total_s']}s / "
                f"{t['runs']}x</li>" for t in wf.get("slowest_units", []))
            rows.append(
                f"<div class='wf'><h2>{html.escape(wf['name'])}</h2>"
                f"<pre>{html.escape(json.dumps(metrics, indent=2))}"
                f"</pre><ul>{timing}</ul></div>")
        body = "\n".join(rows) or "<p>No workflows registered.</p>"
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<meta http-equiv='refresh' content='2'>"
            "<title>znicz_tpu_torch status</title>"
            "<style>body{font-family:monospace;margin:2em}"
            ".wf{border:1px solid #999;padding:1em;margin:1em 0}"
            "</style></head><body><h1>znicz_tpu_torch</h1>"
            f"<p>uptime {status['uptime_s']}s</p>{body}</body></html>")

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
