"""The port's web status page (``znicz_tpu_torch/web_status.py``) on
the CPU, with the reference's cases: ``tests/test_web_shell.py``'s web
tests (its shell tests are ``tests/test_torch_shell.py``'s), and
the ``/healthz`` and ``/readyz`` tests of ``tests/test_resilience_
serving.py``, ``tests/test_swap.py``, ``tests/test_integrity.py`` and
``tests/test_supervisor.py``.

- ``/status.json`` for a trained Wine workflow carries what the
  reference's page carries for the same sample (the same keys; the
  reference trained on its numpy device beside the port's);
- ``/readyz`` answers 503 while an engine's breaker is open — forced on
  the gauge, and held open for real by ``serving.program_error`` — and
  200 again after; a fleet tenant's open breaker is reported and never
  flips it; staleness, snapshot age, model version, quarantined rows,
  heartbeat ages and the federation's ages are reported, and bound the
  probe only when their ``engine.ready_max_*`` setting is set;
- ``/metrics`` carries ``znicz_build_info`` and a fleet's
  ``znicz_fleet_*`` series; ``/trace.json`` and ``/flightrecord`` serve;
- the launcher starts the page for a run, and so does
  ``python -m znicz_tpu_torch <sample> --web-status 0``.

No wall-clock bound: every wait is on a future or a request's reply.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.models.samples.wine import build as ref_build
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.web_status import gather_status as ref_gather_status
from znicz_tpu_torch.models.samples.wine import build
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.web_status import WebStatusServer, gather_status


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


@pytest.fixture(autouse=True)
def closed_breakers():
    """The registry is process-wide: an engine that a test of another
    file left with its breaker open would answer this file's probes, so
    every breaker gauge reads closed during a test and is put back
    after."""
    fam = metrics.REGISTRY.get("znicz_serving_breaker_state")
    saved = [] if fam is None else [(child, child.value)
                                    for _, child in fam.items()]
    for child, _ in saved:
        child.set(0)
    yield
    for child, value in saved:
        child.set(value)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def _readyz(server) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/readyz", timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as exc:
        return exc.code, json.load(exc)


@pytest.fixture(scope="module")
def scorer(tmp_path_factory):
    """A small blob classifier exported by the port."""
    from conftest import make_blobs
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    data, labels = make_blobs(24, 3, 10)
    prng.seed_all(3)
    wf = StandardWorkflow(
        name="web_scorer",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
                 "<-": {"learning_rate": 0.05}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.05}}],
        decision_config={"max_epochs": 1})
    wf._max_fires = 10 ** 6
    wf.initialize(device="cpu")
    wf.run()
    path = str(tmp_path_factory.mktemp("web") / "scorer.npz")
    wf.export_forward(path)
    return path, data


def test_web_status_serves_json_and_html():
    prng.seed_all(1)
    wf = build(max_epochs=2)
    wf.initialize(device="numpy")
    wf.run()
    ref_prng.seed_all(1)
    ref_wf = ref_build(max_epochs=2)
    ref_wf.initialize(device=RefNumpyDevice())
    ref_wf.run()
    server = WebStatusServer(port=0)
    try:
        server.register(wf)
        blob = json.loads(_get(
            f"http://127.0.0.1:{server.port}/status.json"))
        assert blob["uptime_s"] >= 0
        [status] = blob["workflows"]
        assert status["name"] == "wine"
        assert status["epoch"] >= 1
        assert status["complete"] is True
        assert status["backend"] == "numpy"
        assert 0 <= status["min_validation_n_err_pt"] <= 100
        assert status["slowest_units"]
        assert set(status) == set(ref_gather_status(ref_wf))
        page = _get(f"http://127.0.0.1:{server.port}/").decode()
        assert "wine" in page and "uptime" in page
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{server.port}/nope")
        assert exc.value.code == 404
    finally:
        server.stop()


def test_web_status_register_unregister():
    server = WebStatusServer(port=0)
    try:
        wf = build(max_epochs=1)
        server.register(wf)
        server.register(wf)  # idempotent
        assert len(server.status()["workflows"]) == 1
        server.unregister(wf)
        assert server.status()["workflows"] == []
        assert server.health()["workflows"] == 0
    finally:
        server.stop()


def test_gather_status_before_initialize():
    status = gather_status(build(max_epochs=1))
    assert status["name"] == "wine" and not status["initialized"]


def test_launcher_starts_web_status():
    from znicz_tpu_torch.launcher import Launcher
    launcher = Launcher(backend="numpy", web_status=0)
    launcher._load(build, max_epochs=1)
    launcher._main()
    assert launcher.web_server is not None
    try:
        blob = json.loads(_get(
            f"http://127.0.0.1:{launcher.web_server.port}/status.json"))
        assert blob["workflows"][0]["name"] == "wine"
        assert launcher.web_server.host == "127.0.0.1"
    finally:
        launcher.web_server.stop()


def test_the_cli_serves_the_page_for_the_run():
    from znicz_tpu_torch.__main__ import Main
    main = Main()
    assert main.run(["wine", "-b", "numpy", "--web-status", "0",
                     "--root", "wine.max_epochs=1"]) == 0
    server = main.launcher.web_server
    try:
        blob = json.loads(_get(f"http://127.0.0.1:{server.port}/status.json"))
        assert blob["workflows"][0]["name"] == "wine"
        assert json.loads(_get(
            f"http://127.0.0.1:{server.port}/healthz"))["status"] == "ok"
    finally:
        server.stop()


def test_healthz_and_readyz_follow_an_engines_breaker(scorer):
    """``/healthz`` is always 200; ``/readyz`` is 200 while every breaker
    is closed and 503, the reason named, while an engine sheds: the
    gauge forced open as the reference's test does, then the breaker
    held open for real by ``serving.program_error``."""
    from znicz_tpu_torch.serving import ServingEngine
    path, data = scorer
    engine = ServingEngine(path, max_batch=4, max_delay_ms=1.0,
                           device="cpu", retry_budget=0,
                           breaker_cooldown_ms=600_000.0)
    engine.start()
    server = WebStatusServer(port=0)
    try:
        server.register(engine)
        engine(data[:2], timeout=60)
        assert json.loads(_get(
            f"http://127.0.0.1:{server.port}/healthz"))["status"] == "ok"
        code, report = _readyz(server)
        assert code == 200 and report["ready"] is True
        mine = report["engines"][engine._obs_id]
        assert mine["breaker"] == "closed" and "queue_age_s" in mine
        assert mine["model_version"] == 0
        metrics.serving_breaker_state(engine._obs_id).set(2)
        code, report = _readyz(server)
        assert code == 503 and report["ready"] is False
        assert any("breaker open" in r for r in report["reasons"])
        metrics.serving_breaker_state(engine._obs_id).set(0)
        assert _readyz(server)[0] == 200
        root.common.engine.faults = {"serving.program_error": {"after": 1}}
        for _ in range(4):
            with pytest.raises(Exception):
                engine(data[:1], timeout=60)
        assert engine.stats()["resilience"]["breaker"] == "open"
        code, report = _readyz(server)
        assert code == 503
        assert f"breaker open on engine {engine._obs_id}" in report["reasons"]
    finally:
        # the registry is process-wide: later probes see no open breaker
        root.common.engine.faults = None
        metrics.serving_breaker_state(engine._obs_id).set(0)
        server.stop()
        engine.shutdown()


def test_readyz_reports_a_tenants_breaker_without_flipping(scorer):
    from znicz_tpu_torch.serving import FleetEngine, TenantClass
    path, data = scorer
    fleet = FleetEngine(tenants=[TenantClass("hi", priority=0),
                                 TenantClass("lo", priority=2)],
                        autoscale=False, device="cpu", name="webfleet")
    fleet.add_model("scorer", path, max_batch=4, max_delay_ms=1.0)
    server = WebStatusServer(port=0)
    with fleet:
        try:
            server.register(fleet)
            fleet("scorer", data[:1], tenant="hi", timeout=60)
            fleet._tenant_state("lo").transition("open")
            code, report = _readyz(server)
            assert code == 200 and report["ready"] is True
            assert report["tenants"]["webfleet/lo"] == "open"
            assert report["tenants"]["webfleet/hi"] == "closed"
            status = json.loads(_get(
                f"http://127.0.0.1:{server.port}/status.json"))
            [fleet_status] = status["workflows"]
            assert fleet_status["name"] == "fleet:webfleet"
            assert fleet_status["tenants"]["lo"]["breaker"] == "open"
            scrape = _get(f"http://127.0.0.1:{server.port}/metrics").decode()
            for series in ("znicz_fleet_requests_total",
                           "znicz_fleet_breaker_state",
                           "znicz_fleet_replicas",
                           "znicz_fleet_traffic_weight",
                           "znicz_build_info"):
                assert series in scrape, series
        finally:
            server.stop()


def test_readyz_bounds_only_what_is_configured(tmp_path):
    """Staleness, snapshot age, heartbeat age, quarantined rows and the
    federation's age are reported; each flips the probe only under its
    ``engine.ready_max_*`` setting."""
    from znicz_tpu_torch.observe.federation import Federator
    metrics.last_step_timestamp("stale_wf").set(time.time() - 100)
    metrics.loader_rows_quarantined("web_loader").inc(7)
    metrics.heartbeat_age_seconds(3).set(40.0)
    metrics.snapshot_age_seconds("web:src").set(500.0)
    fed = Federator("web_gang")
    fed.add_http("http://127.0.0.1:9/metrics", "dead", timeout_s=0.2)
    fed.scrape()
    server = WebStatusServer(port=0)
    try:
        code, report = _readyz(server)
        assert code == 200, report["reasons"]
        assert report["workflows"]["stale_wf"]["last_step_age_s"] >= 99
        assert report["loaders"]["web_loader"]["rows_quarantined"] == 7
        assert report["processes"]["3"]["heartbeat_age_s"] == 40.0
        assert report["artifacts"]["web:src"]["age_s"] == 500.0
        gangs = {f["gang"]: f for f in report["federation"]}
        assert gangs["web_gang"]["sources"][0]["age_s"] is None
        for key, value, reason in (
                ("ready_max_staleness_s", 30, "stale_wf"),
                ("ready_max_heartbeat_s", 30, "process 3 heartbeat"),
                ("ready_max_snapshot_age_s", 60, "from web:src"),
                ("ready_max_fed_age_s", 60, "federated scrape")):
            setattr(root.common.engine, key, value)
            code, report = _readyz(server)
            assert code == 503 and any(reason in r
                                       for r in report["reasons"])
            setattr(root.common.engine, key, None)
        assert not any("quarantin" in r for r in _readyz(server)[1][
            "reasons"])
    finally:
        fed.close()
        server.stop()
        metrics.last_step_timestamp("stale_wf").set(time.time())
        metrics.heartbeat_age_seconds(3).set(0.0)
        metrics.snapshot_age_seconds("web:src").set(0.0)


def test_trace_and_flightrecord_pages(tmp_path):
    from znicz_tpu_torch.observe import recorder
    from znicz_tpu_torch.observe.tracing import TRACER
    rec = recorder.FlightRecorder(str(tmp_path / "journal"))
    recorder.set_recorder(rec)
    server = WebStatusServer(port=0)
    try:
        with TRACER.span("web_probe"):
            pass
        trace = json.loads(_get(
            f"http://127.0.0.1:{server.port}/trace.json"))
        assert any(e.get("name") == "web_probe"
                   for e in trace["traceEvents"])
        recorder.record("swap", engine="e", outcome="promoted")
        recorder.record("scale", group="g", delta=1)
        page = json.loads(_get(
            f"http://127.0.0.1:{server.port}/flightrecord?kind=scale"))
        assert [e["kind"] for e in page["events"]] == ["scale"]
        assert page["status"] is not None
        everything = json.loads(_get(
            f"http://127.0.0.1:{server.port}/flightrecord?since=0"))
        assert [e["kind"] for e in everything["events"]] == ["swap",
                                                             "scale"]
    finally:
        server.stop()
        recorder.set_recorder(None)


def test_the_page_binds_loopback_by_default():
    server = WebStatusServer(port=0)
    try:
        assert server.host == "127.0.0.1"
        assert server._httpd.server_address[0] == "127.0.0.1"
        assert np.isfinite(server.health()["uptime_s"])
    finally:
        server.stop()
