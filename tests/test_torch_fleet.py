"""The port's fleet (``znicz_tpu_torch/serving/fleet.py``) against the
reference's, on the CPU.

The bundles are the reference's fixtures of ``tests/test_fleet.py``: a
blob classifier (all2all_tanh → softmax) and a tiny byte LM (embedding
→ pos_encoding → causal attention → last_token → softmax), trained and
written by the reference's ``export_forward`` and read unchanged by both
packages.  The port's ``FleetEngine(device="cpu")`` serves them through
its ``ServingEngine`` and ``DecodeEngine``; the reference's
``FleetEngine`` serves the same bundles on its CPU device.

- replies agree within ``TOL`` = 1e-5 (f32 class probabilities,
  summation order only: the tolerance ``tests/test_torch_serving.py``
  holds ``ExportedModel`` to for an f32 bundle), and a decode reply is
  the lone ``DecodeEngine``'s tokens exactly;
- the smooth weighted round robin picks the same sequence of versions;
- a scripted flood sheds the same counts per tenant and event in both
  (every admitted request is waited for before the next submit, and
  the token buckets hold no refill worth a token, so the order of
  outcomes is fixed);
- ``SharedLadderBudget`` evicts in the same order for the same charges;
- the reference's fleet tests (``tests/test_fleet.py:328-621``) ported:
  weighted A/B routing, isolation under a flood, the tenant breaker
  opened, half-open and closed by a decode probe and by a one-shot
  probe, a probe that sheds re-opening it, deadlines and queue bounds,
  the shared budget, the autoscaler's scale-up and its repair after
  ``fleet.replica_loss``, ``fleet.tenant_flood``, readiness.  Their
  ``PriorityQueue``, limiter and ``TokenBudget`` cases are in
  ``tests/test_torch_serving_resilience.py``.

No wall-clock bound (C6): a breaker's cooldown is passed by moving its
``opened_at`` back, a queue ages past a threshold of 0, and every wait
is on a future with a timeout of its own.  The graph tests stand in for
the CUDA graph API, as ``tests/test_torch_swap.py`` does: an evicted
bucket's graph is released and captured again on its next request,
each capture counted on ``znicz_graph_captures_total``, and a repair
captures nothing.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from conftest import make_blobs
from znicz_tpu.backends import XLADevice
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.serving import FleetEngine as RefFleet
from znicz_tpu.serving import Overloaded as RefOverloaded
from znicz_tpu.serving import SharedLadderBudget as RefBudget
from znicz_tpu.serving import TenantClass as RefTenant
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.export import ExportedModel
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.serving import (DeadlineExceeded, DecodeEngine,
                                     FleetEngine, Overloaded, QueueFull,
                                     SharedLadderBudget, TenantClass)
from znicz_tpu_torch.utils.config import reset_root, root

DIM, N_CLASSES, VOCAB = 12, 4, 10
TOL = 1e-5
#: a token bucket that refills nothing worth a token during a test
SLOW = 1e-6
LM_KWARGS = dict(max_slots=4, max_t=32, max_prompt=8, prompt_align=4,
                 max_new_tokens=4, paged=False)


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    ref_root.common.engine.aot_cache = False
    yield
    reset_root()
    ref_root.common.engine.faults = None


@pytest.fixture(scope="module")
def oneshot_bundle(tmp_path_factory):
    from znicz_tpu.loader.fullbatch import ArrayLoader
    data, labels = make_blobs(48, N_CLASSES, DIM)
    ref_prng.seed_all(5)
    wf = RefWorkflow(
        name="fleet_scorer",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:160], train_labels=labels[:160],
            valid_data=data[160:], valid_labels=labels[160:],
            minibatch_size=32),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": N_CLASSES},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        ],
        decision_config={"max_epochs": 2})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    path = str(tmp_path_factory.mktemp("fleet") / "scorer.npz")
    wf.export_forward(path)
    return path, data


@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    from znicz_tpu.loader.fullbatch import ArrayLoader
    rng = np.random.default_rng(31)
    seq_len = 8
    start = rng.integers(0, VOCAB, size=192)
    data = ((start[:, None] + np.arange(seq_len)[None, :])
            % VOCAB).astype(np.float32)
    labels = ((start + seq_len) % VOCAB).astype(np.int32)
    ref_prng.seed_all(31)
    wf = RefWorkflow(
        name="fleet_lm",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:128], train_labels=labels[:128],
            valid_data=data[128:], valid_labels=labels[128:],
            minibatch_size=32),
        layers=[
            {"type": "embedding", "->": {"vocab_size": VOCAB, "dim": 8},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
            {"type": "pos_encoding", "->": {}},
            {"type": "attention", "->": {"n_heads": 1, "causal": True},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "last_token", "->": {}},
            {"type": "softmax", "->": {"output_sample_shape": VOCAB},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        ],
        decision_config={"max_epochs": 1})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    path = str(tmp_path_factory.mktemp("fleet") / "lm.npz")
    wf.export_forward(path)
    return path


def _tenants(pkg: str, lo_rate=50, lo_burst=8):
    cls = TenantClass if pkg == "port" else RefTenant
    return [cls("hi", priority=0),
            cls("lo", priority=2, rate=lo_rate, burst=lo_burst,
                max_queue_rows=32)]


def make_fleet(oneshot_bundle, lm_bundle=None, **kwargs):
    path, _data = oneshot_bundle
    tenants = kwargs.pop("tenants", None) or _tenants("port")
    fleet = FleetEngine(tenants=tenants, autoscale=False, device="cpu",
                        **kwargs)
    fleet.add_model("scorer", path, max_batch=8, max_delay_ms=1.0)
    if lm_bundle is not None:
        fleet.add_model("lm", lm_bundle, kind="lm", **LM_KWARGS)
    return fleet


def _record_versions(monkeypatch, fleet_module) -> list:
    """Every version a fleet module's smooth weighted round robin
    picks, in order."""
    picked = []
    pick = fleet_module._FleetModel.pick_version

    def recording(self):
        v = pick(self)
        picked.append(v.label)
        return v

    monkeypatch.setattr(fleet_module._FleetModel, "pick_version",
                        recording)
    return picked


# ----------------------------------------------------------------------
# held to the reference's fleet
# ----------------------------------------------------------------------
def test_replies_and_version_choices_match_the_reference(oneshot_bundle,
                                                         monkeypatch):
    from znicz_tpu.serving import fleet as ref_fleet_module
    from znicz_tpu_torch.serving import fleet as fleet_module
    path, data = oneshot_bundle
    weights = {"v1": 3.0, "v2": 1.0, "v3": 2.0}
    fleets = {"port": FleetEngine(autoscale=False, device="cpu"),
              "ref": RefFleet(autoscale=False)}
    picks = {"port": _record_versions(monkeypatch, fleet_module),
             "ref": _record_versions(monkeypatch, ref_fleet_module)}
    replies = {}
    for pkg, fleet in fleets.items():
        fleet.add_model("m", path, max_batch=8, max_delay_ms=0.5)
        fleet.add_version("m", path, version="v2")
        fleet.add_version("m", path, version="v3")
        fleet.set_traffic("m", weights)
        with fleet:
            replies[pkg] = [np.asarray(fleet("m", data[i:i + 1 + i % 3],
                                             timeout=60))
                            for i in range(18)]
            served = {v: s["served"] for v, s in
                      fleet.stats()["models"]["m"]["versions"].items()}
        assert served == {"v1": 9, "v2": 3, "v3": 6}, (pkg, served)
    assert picks["port"] == picks["ref"]
    assert len(picks["port"]) == 18
    for got, want in zip(replies["port"], replies["ref"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_a_scripted_flood_sheds_the_same_counts_as_the_reference(
        oneshot_bundle):
    """lo, at a burst of 6 that never refills, sends 16 one-row requests
    between hi's; each admitted request is waited for.  Both fleets
    admit the same 6, shed the same 10 (rate limit, then the breaker)
    and serve every hi request."""
    path, data = oneshot_bundle
    counts = {}
    for pkg in ("port", "ref"):
        tenants = _tenants(pkg, lo_rate=SLOW, lo_burst=6)
        if pkg == "port":
            fleet = FleetEngine(tenants=tenants, autoscale=False,
                                device="cpu")
        else:
            fleet = RefFleet(tenants=tenants, autoscale=False)
        fleet.add_model("scorer", path, max_batch=8, max_delay_ms=1.0)
        events = []
        with fleet:
            for i in range(16):
                try:
                    fleet.submit("scorer", data[:1],
                                 tenant="lo").result(timeout=60)
                    events.append("admitted")
                except (Overloaded, RefOverloaded) as exc:
                    events.append("breaker" if "breaker" in str(exc)
                                  else "rate")
                fleet("scorer", data[i:i + 2], tenant="hi", timeout=60)
            st = fleet.stats()["tenants"]
        counts[pkg] = ({t: {k: st[t][k] for k in ("submitted", "served",
                                                  "shed", "expired",
                                                  "failed", "breaker")}
                        for t in ("hi", "lo")}, events)
    assert counts["port"] == counts["ref"]
    tenants, events = counts["port"]
    assert tenants["hi"] == {"submitted": 16, "served": 16, "shed": 0,
                             "expired": 0, "failed": 0,
                             "breaker": "closed"}
    assert tenants["lo"]["served"] == 6 and tenants["lo"]["shed"] == 10
    assert events[:6] == ["admitted"] * 6 and "breaker" in events


def test_the_shared_budget_evicts_in_the_reference_order():
    class FakeModel:
        def __init__(self, dropped, key):
            self.dropped, self.key = dropped, key

        def drop_program(self, size):
            self.dropped.append((self.key, size))
            return True

    script = [("charge", "a", 1, 100), ("charge", "b", 1, 100),
              ("charge", "c", 1, 100), ("charge", "a", 2, 200),
              ("touch", "b", 1, 0), ("charge", "c", 2, 200),
              ("charge", "b", 2, 200), ("charge", "a", 4, 400),
              ("forget", "c", 2, 0), ("charge", "c", 4, 50),
              ("touch", "a", 2, 0), ("charge", "b", 4, 300)]
    orders = {}
    for pkg, cls in (("port", SharedLadderBudget), ("ref", RefBudget)):
        dropped = []
        budget = cls(max_programs=4, max_bytes=900, fleet=f"order_{pkg}")
        for key, prio in (("a", 0), ("b", 1), ("c", 2)):
            budget.register(key, FakeModel(dropped, key), prio)
        for op, key, size, nbytes in script:
            if op == "charge":
                budget.charge(key, size, nbytes)
            else:
                getattr(budget, op)(key, size)
        orders[pkg] = (dropped, budget.stats())
    assert orders["port"] == orders["ref"]
    assert orders["port"][0][0] == ("c", 1)  # the lowest priority first


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_the_shared_budget_never_evicts_the_charged_program(pkg):
    class FakeModel:
        def __init__(self):
            self.dropped = []

        def drop_program(self, size):
            self.dropped.append(size)
            return True

    cls = SharedLadderBudget if pkg == "port" else RefBudget
    budget = cls(max_bytes=100, fleet=f"budget_test2_{pkg}")
    m = FakeModel()
    budget.register("only", m, priority=3)
    budget.charge("only", 1, 400)  # over the budget, but the only entry
    assert m.dropped == []
    budget.charge("only", 2, 50)   # now the older one may go
    assert m.dropped == [1]


# ----------------------------------------------------------------------
# the reference's fleet tests, ported
# ----------------------------------------------------------------------
def test_fleet_weighted_ab_routing_exact(oneshot_bundle):
    path, data = oneshot_bundle
    fleet = FleetEngine(autoscale=False, device="cpu")
    fleet.add_model("m", path, max_batch=8, max_delay_ms=0.5)
    fleet.add_version("m", path, version="v2", weight=1.0)
    fleet.set_traffic("m", {"v1": 3.0, "v2": 1.0})
    with fleet:
        for _ in range(12):
            fleet("m", data[:1], timeout=60)
        st = fleet.stats()["models"]["m"]["versions"]
        # a pinned version bypasses the split
        fleet("m", data[:1], version="v2", timeout=60)
        assert fleet.stats()["models"]["m"]["versions"]["v2"][
            "served"] == 4
    assert st["v1"]["served"] == 9 and st["v2"]["served"] == 3
    with pytest.raises(KeyError):
        fleet.set_traffic("m", {"nope": 1.0})


def test_fleet_flood_sheds_only_the_flooding_tenant(oneshot_bundle,
                                                    lm_bundle):
    """A lo flood is absorbed inside lo while hi traffic, one-shot and
    decode, sees no failure."""
    path, data = oneshot_bundle
    fleet = make_fleet(oneshot_bundle, lm_bundle,
                       tenants=_tenants("port", lo_rate=SLOW))
    with fleet:
        hi_futures = []
        shed = 0
        for i in range(30):
            try:
                fleet.submit("scorer", data[:1], tenant="lo")
            except (Overloaded, QueueFull):
                shed += 1
            hi_futures.append(fleet.submit("scorer", data[i:i + 2],
                                           tenant="hi"))
            if i % 5 == 0:
                hi_futures.append(fleet.submit(
                    "lm", np.array([i % VOCAB, 1]), tenant="hi"))
        for f in hi_futures:
            f.result(timeout=120)  # raises on any hi failure
        assert shed == 30 - 8  # the burst, then nothing refills
        st = fleet.stats()["tenants"]
        assert st["hi"]["shed"] == 0 and st["hi"]["failed"] == 0
        assert st["hi"]["served"] == len(hi_futures)
        assert st["lo"]["shed"] == shed
        hi_shed = metrics.fleet_requests(fleet._obs_id, "hi", "shed")
        lo_shed = metrics.fleet_requests(fleet._obs_id, "lo", "shed")
        assert hi_shed.value == 0 and lo_shed.value == shed


def _cooldown_passes(state) -> None:
    """The breaker's cooldown over, without waiting for it."""
    state.opened_at -= state.cooldown


def test_fleet_tenant_breaker_half_open_mixed_paths(oneshot_bundle,
                                                    lm_bundle):
    """Sustained rate-limit shedding opens lo's breaker (hi stays
    closed and served on both paths); after the cooldown a decode probe
    closes it; a second flood opens it again and a one-shot probe
    closes it: both paths drive one tenant state machine."""
    path, data = oneshot_bundle
    fleet = FleetEngine(
        tenants=[TenantClass("hi", priority=0),
                 TenantClass("lo", priority=2, rate=SLOW, burst=4)],
        breaker_min_samples=4, breaker_window=8,
        breaker_cooldown_ms=150.0, autoscale=False, device="cpu")
    fleet.add_model("scorer", path, max_batch=8, max_delay_ms=1.0)
    fleet.add_model("lm", lm_bundle, kind="lm",
                    **dict(LM_KWARGS, max_new_tokens=2))
    state = fleet._tenant_state("lo")

    def flood_until_open():
        for _ in range(100):
            try:  # the flood itself is mixed
                fleet.submit("scorer", data[:1], tenant="lo")
                fleet.submit("lm", np.array([1, 2]), tenant="lo")
            except Overloaded as exc:
                if "breaker" in str(exc):
                    return
        raise AssertionError("lo breaker never opened")

    with fleet:
        flood_until_open()
        assert state.state == "open"
        assert metrics.fleet_breaker_state(fleet._obs_id, "lo").value == 2
        assert fleet("scorer", data[:2], tenant="hi",
                     timeout=60).shape == (2, N_CLASSES)
        assert len(fleet("lm", np.array([1]), tenant="hi",
                         timeout=60)) == 2
        assert fleet._tenant_state("hi").state == "closed"
        # the probes need tokens: refill lo's bucket by hand
        state.bucket._level = state.bucket.burst
        _cooldown_passes(state)
        assert len(fleet("lm", np.array([2, 3]), tenant="lo",
                         timeout=60)) == 2
        assert state.state == "closed"
        state.bucket._level = 0.0
        flood_until_open()
        assert state.state == "open"
        state.bucket._level = state.bucket.burst
        _cooldown_passes(state)
        assert fleet("scorer", data[:1], tenant="lo",
                     timeout=60).shape == (1, N_CLASSES)
        assert state.state == "closed"


def test_fleet_half_open_probe_failure_reopens(oneshot_bundle):
    """A probe that sheds (the tenant still flooding) opens the breaker
    again instead of closing it."""
    path, data = oneshot_bundle
    fleet = FleetEngine(
        tenants=[TenantClass("lo", priority=2, rate=SLOW, burst=2)],
        breaker_min_samples=2, breaker_window=4,
        breaker_cooldown_ms=100.0, autoscale=False, device="cpu")
    fleet.add_model("scorer", path, max_batch=8, max_delay_ms=1.0)
    with fleet:
        state = fleet._tenant_state("lo")
        for _ in range(100):
            if state.state == "open":
                break
            try:
                fleet.submit("scorer", data[:1], tenant="lo")
            except Overloaded:
                pass
        assert state.state == "open"
        _cooldown_passes(state)  # the next submit is the probe, and the
        # bucket is still empty: the probe sheds and the breaker reopens
        with pytest.raises(Overloaded):
            fleet.submit("scorer", data[:1], tenant="lo")
        assert state.state == "open"


def test_fleet_tenant_deadline_and_queue_bound(oneshot_bundle):
    path, data = oneshot_bundle
    fleet = FleetEngine(
        tenants=[TenantClass("slo", priority=1, deadline_ms=25,
                             max_queue_rows=4)],
        autoscale=False, device="cpu")
    fleet.add_model("scorer", path, max_batch=8, max_delay_ms=5_000.0)
    with fleet:
        # the tenant's default deadline applies with none on the call
        f = fleet.submit("scorer", data[:2], tenant="slo")
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=30)
        assert fleet.stats()["tenants"]["slo"]["expired"] == 1
        # the per-tenant queue bound: 4 rows pending at most
        fleet.submit("scorer", data[:4], tenant="slo")
        with pytest.raises(QueueFull, match="tenant 'slo' queue"):
            fleet.submit("scorer", data[:2], tenant="slo")


def test_shared_ladder_budget_evicts_lowest_priority_first(
        oneshot_bundle):
    path, _data = oneshot_bundle
    premium = ExportedModel.load(path, device="cpu", max_batch=8)
    cheap = ExportedModel.load(path, device="cpu", max_batch=8)
    budget = SharedLadderBudget(max_programs=5, fleet="budget_test")
    premium.attach_program_budget(budget, "premium", priority=0)
    cheap.attach_program_budget(budget, "cheap", priority=2)
    premium.warmup(8)   # 4 programs: 1, 2, 4, 8
    cheap.warmup(8)     # 4 more: pressure
    st = budget.stats()
    assert st["programs"] == 5
    # the premium ladder is whole; the cheap one took the pressure
    assert st["per_model"] == {"premium": 4, "cheap": 1}
    assert list(premium._programs) == [1, 2, 4, 8]
    assert list(cheap._programs) == [8]
    assert metrics.fleet_ladder_evictions("budget_test",
                                          "cheap").value == 3
    # a dropped bucket is made resident again on demand and serves
    built = cheap.programs_built
    want = ExportedModel.load(path, device="cpu")(np.zeros((1, DIM)))
    np.testing.assert_array_equal(cheap(np.zeros((1, DIM), np.float32)),
                                  want)
    assert cheap.programs_built == built + 1
    # ... charged again, which evicted the cheap ladder's own LRU bucket
    assert list(cheap._programs) == [1]
    assert budget.stats()["per_model"] == {"premium": 4, "cheap": 1}


def test_fleet_autoscaler_scales_up_from_queue_age(oneshot_bundle):
    path, data = oneshot_bundle
    fleet = FleetEngine(autoscale=True, max_replicas=3, device="cpu")
    fleet.autoscaler.queue_age_up_s = 0.0  # any queued request
    fleet.autoscaler.cooldown_s = 0.0
    fleet.add_model("m", path, max_batch=4, max_delay_ms=5_000.0)
    with fleet:
        group = fleet._models["m"].versions["v1"].group
        assert group.live() == 1
        f = fleet.submit("m", data[:1], tenant="default")
        events = fleet.tick()
        assert any("scaled m@v1 up" in e for e in events), events
        assert group.live() == 2
        assert metrics.fleet_scale_events(fleet._obs_id, "m@v1",
                                          "up").value == 1
        # one shared model: the new replica made nothing resident
        assert fleet._models["m"].versions["v1"].model.programs_built == 3
        for eng in group.engines():
            eng.flush()
        f.result(timeout=60)


def test_fleet_tenant_flood_chaos_site(oneshot_bundle):
    path, data = oneshot_bundle
    root.common.engine.faults = {
        "fleet.tenant_flood": {"at": [1], "n": 20}}
    fleet = make_fleet((path, data),
                       tenants=_tenants("port", lo_rate=SLOW))
    with fleet:
        events = fleet.tick()
        assert any("injected flood" in e for e in events), events
        st = fleet.stats()["tenants"]
        # the flood landed on the lowest-priority tenant and stayed
        # there: the burst admitted, the rest shed, hi untouched
        assert st["lo"]["submitted"] == 8 and st["lo"]["shed"] == 12
        assert st["hi"]["shed"] == 0 and st["hi"]["submitted"] == 0
        assert fleet("scorer", data[:2], tenant="hi",
                     timeout=60).shape == (2, N_CLASSES)
    assert metrics.faults_injected("fleet.tenant_flood").value >= 1


def test_fleet_ready_and_web_status(oneshot_bundle):
    path, data = oneshot_bundle
    fleet = make_fleet((path, data))
    with fleet:
        fleet("scorer", data[:1], tenant="hi", timeout=60)
        assert fleet.ready()
        status = fleet.serving_status()
        assert status["name"].startswith("fleet:")
        assert status["models"]["scorer"]["kind"] == "oneshot"
        # an open lo breaker sheds lo alone: the process stays ready
        fleet._tenant_state("lo").transition("open")
        assert fleet.ready()
    assert not fleet.ready()


def test_decode_through_the_fleet_is_the_lone_engine(oneshot_bundle,
                                                     lm_bundle):
    """An ``lm`` model's replies are the tokens a lone ``DecodeEngine``
    on the same bundle generates, for hi and lo alike."""
    prompts = [np.array(p) for p in ([1, 2], [3], [4, 5, 6], [7, 8, 9, 0])]
    lone = DecodeEngine(lm_bundle, device="cpu", **LM_KWARGS)
    lone.start()
    try:
        want = [list(lone.submit(p).result(timeout=60)) for p in prompts]
    finally:
        lone.shutdown()
    fleet = make_fleet(oneshot_bundle, lm_bundle)
    with fleet:
        got = [list(fleet("lm", p, tenant=("hi", "lo")[i % 2],
                          timeout=60)) for i, p in enumerate(prompts)]
        assert fleet.stats()["models"]["lm"]["kind"] == "lm"
    assert got == want


def test_the_fleet_wants_the_card_unless_told_otherwise(oneshot_bundle,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fleet = FleetEngine(autoscale=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.add_model("scorer", oneshot_bundle[0], max_batch=8)


# ----------------------------------------------------------------------
# the graphs, with a stand-in for the CUDA graph API
# ----------------------------------------------------------------------
class _Graph:
    """A stand-in ``CUDAGraph``: a replay runs what was bound to it."""

    def __init__(self):
        self.run = None
        self.replays = 0
        self.resets = 0

    def replay(self):
        self.replays += 1
        self.run()

    def reset(self):
        self.resets += 1


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """``ExportedModel`` graphed on the CPU: a capture binds a rerun of
    the chain into the output to a stand-in graph; every graph made is
    listed."""
    graphs = []
    capture = ExportedModel._capture

    def bound_capture(self, prog):
        warm = capture(self, prog)
        graphs.append(prog.graph)

        def rerun():
            with torch.inference_mode():
                prog.out.copy_(self.forward_padded(prog.buf))

        prog.graph.run = rerun
        return warm

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(ExportedModel, "graphed",
                        property(lambda self: not self.host_only))
    monkeypatch.setattr(ExportedModel, "_capture", bound_capture)
    return graphs


def _captures(name: str) -> float:
    return metrics.graph_captures(f"serving:{name}").value


def test_an_evicted_bucket_is_released_and_captured_again(
        oneshot_bundle, fake_graphs):
    path, data = oneshot_bundle
    lone = ExportedModel.load(path, device="cpu")
    want, want1 = lone(data[:3]), lone(data[:1])
    premium = ExportedModel.load(path, device="cpu", max_batch=4)
    cheap = ExportedModel.load(path, device="cpu", max_batch=4)
    budget = SharedLadderBudget(max_programs=4, fleet="graphs")
    premium.attach_program_budget(budget, "premium", priority=0)
    cheap.attach_program_budget(budget, "cheap", priority=2)
    before = _captures("fleet_scorer")
    premium.warmup(4)
    cheap.warmup(4)
    assert _captures("fleet_scorer") == before + 6
    assert premium.captures == 3 and cheap.captures == 1
    released = [g for g in fake_graphs if g.resets]
    assert len(released) == 2 and all(g.resets == 1 for g in released)
    # the cheap ladder kept its bucket 4, which replays; its buckets 1
    # and 2 were released, and bucket 1 is captured again on demand
    np.testing.assert_array_equal(cheap(data[:3]), want)
    assert _captures("fleet_scorer") == before + 6
    np.testing.assert_array_equal(cheap(data[:1]), want1)
    assert _captures("fleet_scorer") == before + 7
    assert metrics.fleet_ladder_evictions("graphs", "cheap").value == 3
    assert premium.captures == 3


def test_fleet_replica_loss_is_repaired_with_no_capture(oneshot_bundle,
                                                        fake_graphs):
    """``fleet.replica_loss`` kills a live replica; routing steers around
    it, the autoscaler repairs the group in the same tick, and since the
    replicas share the version's graphs the repair captures nothing."""
    path, data = oneshot_bundle
    root.common.engine.faults = {"fleet.replica_loss": {"at": [1]}}
    fleet = FleetEngine(autoscale=True, device="cpu")
    fleet.add_model("m", path, max_batch=8, max_delay_ms=1.0, replicas=2)
    with fleet:
        warmed = _captures("fleet_scorer")
        group = fleet._models["m"].versions["v1"].group
        assert group.live() == 2
        assert fleet._models["m"].versions["v1"].model.captures == 4
        fleet("m", data[:2], timeout=60)
        events = fleet.tick()
        assert any("replica loss" in e for e in events), events
        assert any("repaired" in e for e in events), events
        assert group.live() == 2
        for _ in range(4):  # both replicas serve
            assert fleet("m", data[:2], timeout=60).shape == (2, N_CLASSES)
        assert _captures("fleet_scorer") == warmed, \
            "the repair captured the shared ladder again"
        assert metrics.fleet_scale_events(fleet._obs_id, "m@v1",
                                          "repair").value == 1
        assert fleet.stats()["tenants"]["default"]["failed"] == 0
    assert root.common.engine.faults.events_fired == 1


def test_a_dispatch_holding_the_model_keeps_its_graph(oneshot_bundle,
                                                      fake_graphs):
    """An eviction waits for a dispatch that holds the model's lock: the
    dispatch replays and copies its reply first."""
    path, data = oneshot_bundle
    model = ExportedModel.load(path, device="cpu", max_batch=2)
    model.warmup(2)
    graph = model._programs[2].graph
    started, dropped = threading.Event(), []
    with model._lock:
        fn = model.program_for(2)
        t = threading.Thread(target=lambda: (started.set(),
                                             dropped.append(
                                                 model.drop_program(2))))
        t.start()
        started.wait(30)
        out = fn(torch.as_tensor(data[:2]))
        reply = out[:2].float().numpy().copy()
        assert graph.resets == 0 and not dropped
    t.join(30)
    assert dropped == [True] and graph.resets == 1
    np.testing.assert_array_equal(
        reply, ExportedModel.load(path, device="cpu")(data[:2]))
