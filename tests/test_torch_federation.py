"""The port's metrics federator (``znicz_tpu_torch/observe/
federation.py``) against the reference's, on the CPU.

- ``parse_prometheus`` reads the same samples from the same exposition
  text in both packages, and the fold of those samples writes equal
  ``znicz_fed_*`` children in each package's registry;
- the reference's federator tests (``tests/test_obs_round24.py:180-260``)
  ported: a registry fold with the pool sentinel (a series kept under
  its own pool, folded under an explicit one, or skipped), a dead HTTP
  source that only ages and never raises, the heartbeat channel;
- an HTTP source: the port's own ``/metrics`` page folded over
  127.0.0.1;
- the gang supervisor folds its heartbeat channel into
  ``Federator("elastic")`` on each poll (a gang of one stub process).
"""

from __future__ import annotations

import json
import sys
import time

import pytest

from znicz_tpu.observe import federation as ref_federation
from znicz_tpu.observe import metrics as ref_metrics
from znicz_tpu_torch.observe import federation, metrics
from znicz_tpu_torch.observe.federation import FEDERATORS, Federator
from znicz_tpu_torch.utils.config import reset_root

TEXT = """# HELP znicz_serving_queue_age_seconds Age of the oldest request
# TYPE znicz_serving_queue_age_seconds gauge
znicz_serving_queue_age_seconds{engine="e#0",pool="prefill"} 1.5
znicz_serving_queue_age_seconds{engine="e#0",pool="decode"} 0.25
znicz_serving_queue_age_seconds{engine="e#1",pool="decode"} 0.75
znicz_serving_requests_total{engine="e#0",event="served"} 3
znicz_serving_requests_total{engine="e#1",event="served"} 4
znicz_serving_requests_total{engine="e#1",event="rejected"} 2
znicz_last_step_timestamp_seconds{workflow="w"} 1700000000.5
znicz_heartbeat_age_seconds{process="1"} +Inf
znicz_odd_label{a="x\\"y"} 7
not a sample line
znicz_bad_value{} nan_or_not
"""


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _fed(registry, family: str, gang: str) -> dict:
    fam = registry.REGISTRY.get(family)
    return {} if fam is None else {
        key: float(child.value) for key, child in fam.items()
        if key[0] == gang}


def test_parse_and_fold_match_the_reference():
    port = federation.parse_prometheus(TEXT)
    ref = ref_federation.parse_prometheus(TEXT)
    assert port == ref
    assert ("znicz_heartbeat_age_seconds", {"process": "1"},
            float("inf")) in port
    children = federation._fold_samples("parity", "child", port)
    assert children == ref_federation._fold_samples("parity", "child", ref)
    for family in ("znicz_fed_queue_age_seconds", "znicz_fed_requests",
                   "znicz_fed_step"):
        got = _fed(metrics, family, "parity")
        assert got and got == _fed(ref_metrics, family, "parity"), family
    assert _fed(metrics, "znicz_fed_queue_age_seconds", "parity") == {
        ("parity", "child", "prefill"): 1.5,
        ("parity", "child", "decode"): 0.75}
    assert _fed(metrics, "znicz_fed_requests", "parity") == {
        ("parity", "child", "served"): 7.0,
        ("parity", "child", "rejected"): 2.0}


def test_federator_registry_fold_pool_sentinel():
    metrics.serving_queue_age_seconds("fedA#0", "prefill").set(1.5)
    metrics.serving_queue_age_seconds("fedA#0", "decode").set(0.5)
    metrics.serving_queue_age_seconds("fedB#0").set(2.5)
    metrics.serving_queue_age_seconds("other#0").set(9.0)
    metrics.serving_requests("fedA#0", "ok").inc(3)

    def pool_of(engine):
        if engine == "fedA#0":
            return ""  # ours: keep the series' own pool label
        if engine == "fedB#0":
            return "solo"  # ours: fold under an explicit pool
        return None  # not ours: skip

    fed = Federator("gang24")
    try:
        assert fed.max_age_s() == 0.0  # no sources yet
        fed.add_registry("self", pool_of=pool_of)
        assert fed.max_age_s() == float("inf")  # never folded
        summary = fed.scrape()
        assert summary["sources_ok"] == 1
        assert fed.max_age_s() < float("inf")
        folded = _fed(metrics, "znicz_fed_queue_age_seconds", "gang24")
        assert folded[("gang24", "self", "prefill")] == 1.5
        assert folded[("gang24", "self", "decode")] == 0.5
        assert folded[("gang24", "self", "solo")] == 2.5
        assert not any(v == 9.0 for v in folded.values())
        vals = _fed(metrics, "znicz_fed_requests", "gang24")
        assert vals[("gang24", "self", "ok")] >= 3.0
        children = fed.status()["children"]
        assert "self/prefill" in children and "self/solo" in children
        assert federation.status()[-1]["gang"] == "gang24"
        assert metrics.fed_sources("gang24").value == 1
    finally:
        fed.close()
    assert fed not in FEDERATORS


def test_federator_dead_source_ages_never_raises():
    fed = Federator("gang24b")
    try:
        fed.add_http("http://127.0.0.1:9/metrics", "dead", timeout_s=0.2)
        summary = fed.scrape()  # must not raise
        assert summary["sources_ok"] == 0
        assert fed.max_age_s() == float("inf")
        assert federation.max_age_s() == float("inf")
        st = fed.status()["sources"][0]
        assert st["errors"] == 1 and st["age_s"] is None
    finally:
        fed.close()


def test_federator_heartbeat_channel(tmp_path):
    for i in range(2):
        with open(tmp_path / f"hb_{i:04d}.json", "w") as fh:
            json.dump({"process": i, "step": 10 + i, "time": time.time(),
                       "pid": 1}, fh)
    fed = Federator("gang24c")
    try:
        fed.add_heartbeats(str(tmp_path), 3)  # member 2 never wrote
        summary = fed.scrape()
        assert summary["children"] == 2
        steps = {key[1]: v for key, v in
                 _fed(metrics, "znicz_fed_step", "gang24c").items()}
        assert steps == {"p0": 10.0, "p1": 11.0}
        ages = _fed(metrics, "znicz_fed_heartbeat_age_seconds", "gang24c")
        assert set(ages) == {("gang24c", "p0"), ("gang24c", "p1")}
    finally:
        fed.close()


def test_federator_folds_a_live_metrics_page():
    from znicz_tpu_torch.web_status import WebStatusServer
    metrics.serving_queue_age_seconds("httpchild#0").set(0.5)
    metrics.serving_requests("httpchild#0", "served").inc(2)
    server = WebStatusServer(port=0)
    fed = Federator("gang_http")
    try:
        fed.add_http(f"http://127.0.0.1:{server.port}/metrics", "child")
        assert fed.scrape()["sources_ok"] == 1
        ages = _fed(metrics, "znicz_fed_queue_age_seconds", "gang_http")
        assert ages[("gang_http", "child", "all")] >= 0.5
        assert fed.status()["sources"][0]["errors"] == 0
    finally:
        fed.close()
        server.stop()


_STUB = """
import os, sys
sys.path.insert(0, {repo!r})
from znicz_tpu_torch.resilience import supervisor as sup
pid = int(os.environ["ZNICZ_PROCESS_ID"])
w = sup.HeartbeatWriter(os.environ["ZNICZ_HEARTBEAT_DIR"], pid,
                        interval_s=0.05).start()
for step in range(1, 6):
    w.beat(step)
w.stop()
"""


def test_the_gang_supervisor_folds_its_heartbeats(tmp_path):
    import pathlib

    from znicz_tpu_torch.resilience import supervisor as sup
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    stub = tmp_path / "stub.py"
    stub.write_text(_STUB.format(repo=repo))
    summary = sup.ElasticSupervisor(
        lambda pid, n, attempt: [sys.executable, str(stub)],
        n_processes=1, work_dir=str(tmp_path / "work"),
        snapshot_dir=str(tmp_path / "snaps"), heartbeat_timeout_s=600.0,
        stall_timeout_s=600.0, start_grace_s=600.0, poll_interval_s=0.05,
        drain_s=600.0, max_restarts=0).run()
    assert summary["ok"]
    assert _fed(metrics, "znicz_fed_step", "elastic")[
        ("elastic", "p0")] == 5.0
    assert ("elastic", "p0") in _fed(
        metrics, "znicz_fed_heartbeat_age_seconds", "elastic")
    assert not any(f.gang == "elastic" for f in FEDERATORS), \
        "the gang's federator outlived its run"
