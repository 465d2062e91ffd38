"""The command line's ``--chunk`` and ``--dump-graph`` on the CPU (in
``tests/test_torch_cli.py``'s style, on the ``attention_seq`` sample):
a run of ``--chunk 4`` ends in the state of a run step by step, bit for
bit, resumed or not; ``--dump-graph`` writes the unit graph as DOT with
the reference's nodes and edges and trains nothing."""

import re

import numpy as np
import pytest

from znicz_tpu.__main__ import Main as RefMain
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _state(wf) -> dict:
    state = wf.state_dict()
    return {"units": state["__units__"], "prng": state["__prng__"]}


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _cli(*args) -> Main:
    main = Main()
    assert main.run(["attention_seq", "-b", "cpu", *args]) == 0
    return main


@pytest.mark.parametrize("chunk", ["4", "13"])
def test_chunk_ends_in_the_state_of_single_steps(chunk):
    """``--chunk N`` (a chunk never crosses a class or an epoch: 96
    validation and 384 train samples in minibatches of 32 give chunks of
    3, then 4 or 12) against ``--chunk 1`` and no flag."""
    epochs = ["--root", "attention_seq.max_epochs=3"]
    chunked = _cli("--chunk", chunk, *epochs)
    single = _cli("--chunk", "1", *epochs)
    plain = _cli(*epochs)
    assert chunked.launcher.chunk == int(chunk) and single.launcher.chunk == 1
    wf = chunked.launcher.workflow
    assert wf.decision.complete and wf.loader.epoch_number == 2
    _assert_same(_state(wf), _state(single.launcher.workflow))
    _assert_same(_state(wf), _state(plain.launcher.workflow))


def test_chunked_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    snap = ["--root", "attention_seq.snapshotter_config={'prefix': 'seq', "
            f"'directory': '{tmp_path}'}}"]
    straight = _cli("--chunk", "4", "--root", "attention_seq.max_epochs=4")
    first = _cli("--chunk", "4", "--root", "attention_seq.max_epochs=2",
                 *snap)
    path = first.launcher.latest_snapshot(first.launcher.workflow)
    reset_root()
    root.common.seed = 999  # the snapshot's generator state must win
    resumed = _cli("--chunk", "4", "-s", path, "--root",
                   "attention_seq.max_epochs=4")
    _assert_same(_state(resumed.launcher.workflow),
                 _state(straight.launcher.workflow))


def _graph(dot: str) -> tuple[set, set]:
    labels = dict(re.findall(r'(u\d+) \[label="([^"]+)"\]', dot))
    nodes = {tuple(label.split("\\n")) for label in labels.values()}
    edges = {(labels[a].split("\\n")[0], labels[b].split("\\n")[0])
             for a, b in re.findall(r"(u\d+) -> (u\d+);", dot)}
    return nodes, edges


def test_dump_graph_writes_the_reference_graph(tmp_path):
    """The port's DOT of an initialized ``attention_seq`` has the nodes
    and edges of the reference's (``--dump-graph --dry-run``, both with
    the anomaly guard, their default), ``train_region`` and
    ``anomaly_guard`` among them."""
    port_dot, ref_dot = tmp_path / "port.dot", tmp_path / "ref.dot"
    main = _cli("--dump-graph", str(port_dot))
    assert RefMain().run(["attention_seq", "--dump-graph", str(ref_dot),
                          "--dry-run"]) == 0
    port_text = port_dot.read_text()
    assert port_text.startswith('digraph "attention_seq"')
    nodes, edges = _graph(port_text)
    assert (nodes, edges) == _graph(ref_dot.read_text())
    assert ("train_region", "RegionUnit") in nodes
    assert ("anomaly_guard", "AnomalyGuard") in nodes
    assert ("anomaly_guard", "train_region") in edges
    assert ("decision", "repeater") in edges
    wf = main.launcher.workflow
    assert wf.is_initialized and wf.loader.epoch_number == 0
    assert wf.region.captures == 0 and wf.decision.epoch_n_err == [0, 0, 0]


def test_chunk_must_be_positive():
    with pytest.raises(ValueError, match="chunk 0"):
        Launcher(backend="cpu", chunk=0)
