"""The port's runtime core (``znicz_tpu_torch.units``, ``workflow``,
``mutable``) against the reference's: every scenario of
``tests/test_units.py`` and ``tests/test_mutable.py`` runs through both
packages, and the order in which units fire, the gate outcomes and the
values read back must agree.  Then what only the port has to show: a
unit that is also an ``nn.Module`` keeps its attribute links, its
parameters and both ``state_dict``\\ s."""

import types

import numpy as np
import pytest
import torch

import znicz_tpu.mutable as ref_mutable
import znicz_tpu.units as ref_units
import znicz_tpu.workflow as ref_workflow
import znicz_tpu_torch.mutable as port_mutable
import znicz_tpu_torch.units as port_units
import znicz_tpu_torch.workflow as port_workflow


def _pkg(mutable, units, workflow):
    return types.SimpleNamespace(
        Bool=mutable.Bool, LinkableAttribute=mutable.LinkableAttribute,
        Unit=units.Unit, Repeater=units.Repeater, Workflow=workflow.Workflow)


PACKAGES = {"reference": _pkg(ref_mutable, ref_units, ref_workflow),
            "port": _pkg(port_mutable, port_units, port_workflow)}


def _tracer(pkg):
    class Tracer(pkg.Unit):
        def run(self):
            self.workflow.trace.append(self.name)
    return Tracer


def _wf(pkg):
    wf = pkg.Workflow(name="test")
    wf.trace = []
    return wf


def _chain(pkg, gate=None):
    wf = _wf(pkg)
    a, b, c = (_tracer(pkg)(wf, name=n) for n in "abc")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(b)
    wf.end_point.link_from(c)
    if gate:
        getattr(b, gate) << True
    wf.initialize()
    wf.run()
    return wf.trace


def linear_chain_order(pkg):
    return _chain(pkg)


def gate_skip_propagates_without_running(pkg):
    return _chain(pkg, "gate_skip")


def gate_block_stops_flow(pkg):
    return _chain(pkg, "gate_block")


def diamond_join_waits_for_all(pkg):
    wf = _wf(pkg)
    a, b, c, d = (_tracer(pkg)(wf, name=n) for n in "abcd")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(a)
    d.link_from(b, c)
    wf.end_point.link_from(d)
    wf.initialize()
    wf.run()
    return wf.trace


def repeater_loop_with_derived_gate(pkg):
    wf = _wf(pkg)
    rep = pkg.Repeater(wf, name="rep")
    complete = pkg.Bool(False)

    class Body(_tracer(pkg)):
        def run(self):
            super().run()
            if len(self.workflow.trace) >= 5:
                complete << True

    body = Body(wf, name="body")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    rep.link_from(body)
    rep.gate_block = complete
    wf.end_point.link_from(body)
    wf.end_point.gate_block = ~complete
    wf.initialize()
    wf._max_fires = 100
    wf.run()
    return wf.trace, bool(complete), wf._finished


def link_attrs_aliasing(pkg):
    wf = _wf(pkg)
    a = _tracer(pkg)(wf, name="a")
    b = _tracer(pkg)(wf, name="b")
    a.output = 10
    b.link_attrs(a, ("input", "output"))
    seen = [b.input]
    a.output = 20
    seen.append(b.input)
    b.input = 30  # two-way: writes through
    seen.append(a.output)
    c = _tracer(pkg)(wf, name="c")
    c.link_attrs(a, "output", two_way=False)
    try:
        c.output = 1
        seen.append("wrote")
    except AttributeError:
        seen.append("one-way")
    return seen


def initialize_defers_on_attribute_error(pkg):
    wf = _wf(pkg)
    order = []

    class Producer(pkg.Unit):
        def initialize(self, **kwargs):
            order.append(self.name)
            self.payload = 99

    class Consumer(pkg.Unit):
        def initialize(self, **kwargs):
            order.append(self.name)
            _ = self.source.payload  # AttributeError until the producer
            self.got = self.source.payload

    consumer = Consumer(wf, name="consumer")  # added FIRST
    producer = Producer(wf, name="producer")
    consumer.source = producer
    wf.initialize()
    return consumer.got, order


def initialize_deadlock_detection(pkg):
    wf = _wf(pkg)

    class Stuck(pkg.Unit):
        def initialize(self, **kwargs):
            raise AttributeError("never ready")

    Stuck(wf, name="stuck")
    with pytest.raises(RuntimeError, match="deadlock") as info:
        wf.initialize()
    return "first stuck unit: <Stuck 'stuck'>" in str(info.value)


def unique_unit_names(pkg):
    wf = _wf(pkg)
    return [_tracer(pkg)(wf, name="x").name for _ in range(3)]


def generate_graph_dot(pkg):
    wf = _wf(pkg)
    a = _tracer(pkg)(wf, name="a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    return wf.generate_graph()


def stop_ends_the_run(pkg):
    wf = _wf(pkg)
    rep = pkg.Repeater(wf, name="rep")

    class Body(_tracer(pkg)):
        def run(self):
            super().run()
            if len(self.workflow.trace) == 3:
                self.workflow.stop()

    body = Body(wf, name="body")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    rep.link_from(body)
    wf.initialize()
    wf._max_fires = 100
    wf.run()
    return wf.trace, bool(wf.stopped)


def bool_basic(pkg):
    b = pkg.Bool(False)
    out = [bool(b)]
    b << True
    out.append(bool(b))
    b.value = False
    return out + [bool(b)]


def bool_derived_views_are_live(pkg):
    a, b = pkg.Bool(False), pkg.Bool(True)
    inv, conj, disj = ~a, a & b, a | b
    out = [bool(inv), bool(conj), bool(disj)]
    a << True
    return out + [bool(inv), bool(conj), bool(disj)]


def bool_derived_is_readonly(pkg):
    inv = ~pkg.Bool(False)
    with pytest.raises(ValueError):
        inv.value = True
    return repr(inv)


def bool_on_true_callbacks(pkg):
    a = pkg.Bool(False)
    fired = []
    a.on_true.append(lambda: fired.append(1))
    a << True
    a << True  # no re-fire while already True
    a << False
    a << True
    return fired


def linkable_attribute_two_way(pkg):
    src = types.SimpleNamespace(output=41)
    link = pkg.LinkableAttribute(src, "output")
    got = link.get()
    link.set(42)
    return got, src.output


def linkable_attribute_one_way(pkg):
    src = types.SimpleNamespace(output=1)
    link = pkg.LinkableAttribute(src, "output", two_way=False)
    with pytest.raises(AttributeError):
        link.set(2)
    return src.output


SCENARIOS = [linear_chain_order, diamond_join_waits_for_all,
             gate_skip_propagates_without_running, gate_block_stops_flow,
             repeater_loop_with_derived_gate, link_attrs_aliasing,
             initialize_defers_on_attribute_error,
             initialize_deadlock_detection, unique_unit_names,
             generate_graph_dot, stop_ends_the_run, bool_basic,
             bool_derived_views_are_live, bool_derived_is_readonly,
             bool_on_true_callbacks, linkable_attribute_two_way,
             linkable_attribute_one_way]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(scenario):
    """The scenario's outcome (firing order, gate outcomes, values) is
    the reference's, and is what the reference's own test asserts."""
    ref = scenario(PACKAGES["reference"])
    port = scenario(PACKAGES["port"])
    assert port == ref
    expected = {
        "linear_chain_order": ["a", "b", "c"],
        "gate_skip_propagates_without_running": ["a", "c"],
        "gate_block_stops_flow": ["a"],
        "repeater_loop_with_derived_gate": (["body"] * 5, True, True),
        "link_attrs_aliasing": [10, 20, 30, "one-way"],
        "initialize_defers_on_attribute_error": (
            99, ["consumer", "producer", "consumer"]),
        "initialize_deadlock_detection": True,
        "unique_unit_names": ["x", "x_2", "x_3"],
        "stop_ends_the_run": (["body"] * 3, True),
        "bool_on_true_callbacks": [1, 1]}
    if scenario.__name__ in expected:
        assert port == expected[scenario.__name__]
    if scenario.__name__ == "diamond_join_waits_for_all":
        assert port.index("d") == 3 and set(port[1:3]) == {"b", "c"}


def test_op_unit_is_a_unit_and_a_module():
    """An op unit is both: ``link_attrs`` aliases through it (reads and
    two-way writes), ``named_parameters()`` lists its own parameters
    only (not the forward's that a backward unit aliases), the unit's
    ``state_dict()`` gives its snapshot (f32 numpy) while
    ``nn.Module.state_dict``'s arguments give the module's, and a
    ``load_state`` writes the parameters in place."""
    from znicz_tpu_torch.ops.all2all import All2AllSoftmax
    from znicz_tpu_torch.ops.gd import GDSoftmax
    from znicz_tpu_torch.units import Unit

    src = Unit(None, name="src")
    src.output = torch.ones(2, 3)
    unit = All2AllSoftmax((3,), torch.float32, output_sample_shape=2)
    unit.load_params({"weights": torch.arange(6.0).view(3, 2),
                      "bias": torch.zeros(2)})
    unit.link_attrs(src, ("input", "output"))
    assert unit.input is src.output
    unit.input = torch.zeros(2, 3)  # two-way
    assert torch.equal(src.output, torch.zeros(2, 3))
    assert isinstance(unit, torch.nn.Module)
    assert [n for n, _ in unit.named_parameters()] == ["weights", "bias"]
    gd = GDSoftmax(unit, gradient_moment=0.9)
    gd.link_attrs(unit, "weights", "bias", "input")
    assert gd.weights is unit.weights and gd.input is src.output
    assert [n for n, _ in gd.named_parameters()] == []
    assert sorted(n for n, _ in gd.named_buffers()) == [
        "accumulated_gradient_bias", "accumulated_gradient_weights"]
    snap = unit.state_dict()
    assert set(snap) == {"weights", "bias"}
    assert isinstance(snap["weights"], np.ndarray)
    module_state = unit.state_dict(prefix="head.")
    assert set(module_state) == {"head.weights", "head.bias"}
    assert isinstance(module_state["head.weights"], torch.Tensor)
    ptr = unit.weights.data_ptr()
    unit.load_state({"weights": np.full((3, 2), 2.0, np.float32),
                     "bias": np.ones(2, np.float32)})
    assert unit.weights.data_ptr() == ptr
    assert torch.equal(unit.weights, torch.full((3, 2), 2.0))
    vec = unit.vector("weights")
    vec.map_write()
    vec.mem[...] = 5.0
    vec.unmap()
    assert unit.weights.data_ptr() == ptr
    assert torch.equal(unit.weights, torch.full((3, 2), 5.0))
    with pytest.raises(KeyError, match="All2AllSoftmax.bias"):
        unit.load_state({"weights": snap["weights"]})


def test_fires_are_traced_spans():
    """With telemetry on (the default) each unit's fire is a host span
    of the unit's name (the reference's ``TRACER``)."""
    from znicz_tpu_torch.observe import tracing

    pkg = PACKAGES["port"]
    wf = _wf(pkg)
    a = _tracer(pkg)(wf, name="traced_a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    wf.initialize()
    wf.run()
    names = [ev["name"] for ev in tracing.TRACER.events()[-4:]]
    assert names[-2:] == ["end_point", "workflow:test"]
    assert "traced_a" in names
    trace = tracing.TRACER.to_chrome_trace()
    assert trace["traceEvents"][0]["ph"] == "M"
