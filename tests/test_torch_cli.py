"""The port's command line and launcher on the CPU (counterparts of
``tests/test_cli.py``, run with ``-b cpu``).

Most runs drive the ``attention_seq`` sample (a few hundred small
samples, an epoch in well under a second); CIFAR's path through the CLI
is held by a dry run here (its epochs take tens of seconds on the CPU)
and trained on the card by ``chip_smoke.py``.  Beyond the reference's
tests: a run resumed from a snapshot ends bit-equal to the run that was
never interrupted (parameters, momentum, loader, decision and evaluator
state), every flag of the reference's parser the port has not ported
raises naming its ROADMAP item, and with no ``-b`` and no GPU the CLI
raises instead of falling back to the CPU.
"""

import glob
import os
import signal
import threading

import numpy as np
import pytest
import torch

from znicz_tpu_torch.__main__ import Main, _apply_root_overrides
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models.samples import attention_seq
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    root.common.dirs.datasets = str(tmp_path / "no_datasets")
    yield
    reset_root()


def _state(wf) -> dict:
    """Everything a resumed run must reproduce, as numpy."""
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


def test_root_overrides():
    _apply_root_overrides(["cifar.learning_rate=0.125",
                           "root.common.seed=77",
                           "cifar.tag=fast",
                           "cifar.snapshotter_config=None"])
    assert root.cifar.learning_rate == 0.125
    assert root.common.seed == 77
    assert root.cifar.tag == "fast"
    assert root.cifar.snapshotter_config is None


def test_list_samples(capsys):
    assert Main().run(["--list-samples"]) == 0
    out = capsys.readouterr().out.split()
    for name in ("cifar", "alexnet", "attention_seq", "mnist_rbm",
                 "kohonen"):
        assert name in out


@pytest.mark.parametrize("name", ["mnist_rbm", "kohonen"])
def test_cli_chunk_trains_a_custom_loop_as_without(name):
    """``--chunk 4`` on a workflow with no ``run_chunked`` (the RBM's and
    the SOM's own loops) trains it with ``run()``: the same epochs, the
    same weights."""
    runs = []
    for chunk in ([], ["--chunk", "4"]):
        main = Main()
        assert main.run([name, "-b", "cpu", *chunk,
                         "--root", f"{name}.max_epochs=2"]) == 0
        wf = main.launcher.workflow
        assert wf.device.type == "cpu" and wf.decision.complete
        assert wf.loader.epoch_number == 1
        runs.append(wf)
    state = [{k: v for k, v in wf.state_dict()["__units__"].items()
              if k not in ("loader", "decision")} for wf in runs]
    assert state[0].keys() == state[1].keys()
    for unit, values in state[0].items():
        for key, value in values.items():
            np.testing.assert_array_equal(state[1][unit][key], value,
                                          err_msg=f"{unit}.{key}")


def test_cli_trains_attention_seq_on_the_cpu():
    main = Main()
    rc = main.run(["attention_seq", "-b", "cpu",
                   "--root", "attention_seq.max_epochs=3",
                   "--root", "attention_seq.n_train=96"])
    assert rc == 0
    wf = main.launcher.workflow
    assert wf.device.type == "cpu"
    assert wf.loader.epoch_number + 1 == 3 and wf.decision.complete
    assert wf.loader.class_lengths[2] == 96


def test_cli_config_module_applies(tmp_path):
    config = tmp_path / "seq_config.py"
    config.write_text("from znicz_tpu_torch.utils.config import root\n"
                      "root.attention_seq.max_epochs = 12\n"
                      "root.attention_seq.learning_rate = 0.5\n")
    main = Main()
    rc = main.run(["attention_seq", str(config), "-b", "cpu",
                   "--root", "attention_seq.max_epochs=2"])
    assert rc == 0
    wf = main.launcher.workflow
    # the config module set lr 0.5; --root, applied later, set 2 epochs
    assert wf.decision.max_epochs == 2
    assert wf.gds[0].learning_rate == 0.5


def test_cli_dry_run():
    main = Main()
    assert main.run(["cifar", "-b", "cpu", "--dry-run"]) == 0
    wf = main.launcher.workflow
    assert wf.is_initialized and wf.loader.epoch_number == 0
    assert [type(u).__name__ for u in wf.forwards][1:5:3] == [
        "MaxAbsPooling", "AvgPooling"]
    assert not wf.evaluator.epoch_n_err.any()


def test_cli_workflow_by_path(tmp_path):
    wf_file = tmp_path / "tiny.py"
    wf_file.write_text(
        "from znicz_tpu_torch.models.samples.attention_seq import build\n"
        "def run(load, main):\n"
        "    load(build, max_epochs=1)\n"
        "    main()\n")
    main = Main()
    assert main.run([str(wf_file), "-b", "cpu"]) == 0
    assert main.launcher.workflow.loader.epoch_number + 1 == 1


def test_snapshot_resume_roundtrip(tmp_path):
    launcher = Launcher(backend="cpu")
    wf, loaded = launcher._load(
        attention_seq.build, max_epochs=2,
        snapshotter_config={"prefix": "seq_cli", "directory": str(tmp_path)})
    assert not loaded
    launcher._main()
    snaps = sorted(glob.glob(str(tmp_path / "*.pickle.gz")),
                   key=os.path.getmtime)
    assert snaps, "the snapshotter wrote nothing"

    resumed = Launcher(backend="cpu", snapshot=snaps[-1])
    wf2, loaded2 = resumed._load(attention_seq.build, max_epochs=4)
    assert loaded2
    resumed._main()
    # the resumed run went on counting epochs past the snapshot's
    assert wf2.loader.epoch_number + 1 == 4


def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    """C8 end to end: 4 epochs straight, against 2 epochs that snapshot
    and a second CLI run that resumes from the snapshot (``-s``) and
    trains the rest: the same parameters, momentum, loader, evaluator
    and decision state, and generator, bit for bit."""
    snap = ["--root", "attention_seq.snapshotter_config={'prefix': 'seq', "
            f"'directory': '{tmp_path}'}}"]
    straight = Main()
    assert straight.run(["attention_seq", "-b", "cpu", "--root",
                         "attention_seq.max_epochs=4"]) == 0
    first = Main()
    assert first.run(["attention_seq", "-b", "cpu", "--root",
                      "attention_seq.max_epochs=2", *snap]) == 0
    path = first.launcher.latest_snapshot(first.launcher.workflow)
    assert path and path.startswith(str(tmp_path))
    reset_root()
    root.common.seed = 999  # the snapshot's generator state must win
    resumed = Main()
    assert resumed.run(["attention_seq", "-b", "cpu", "-s", path, "--root",
                        "attention_seq.max_epochs=4"]) == 0
    a, b = straight.launcher.workflow, resumed.launcher.workflow
    assert b.loader.epoch_number == a.loader.epoch_number == 3
    _assert_same(_state(b), _state(a))
    assert b.decision.min_validation_n_err_pt == \
        a.decision.min_validation_n_err_pt


def test_launcher_auto_resume_retries(tmp_path, monkeypatch):
    launcher = Launcher(backend="cpu", retries=1)
    wf, _ = launcher._load(
        attention_seq.build, max_epochs=2,
        snapshotter_config={"prefix": "seq", "directory": str(tmp_path)})
    calls = {"n": 0}
    real_step = wf.step

    def crash_once_after_an_epoch():
        calls["n"] += 1
        if calls["n"] == 20:  # epoch 0 took 15 steps and snapshotted
            raise RuntimeError("injected crash")
        real_step()

    monkeypatch.setattr(wf, "step", crash_once_after_an_epoch)
    loaded = []
    real_load = wf.load_state
    monkeypatch.setattr(wf, "load_state",
                        lambda state: loaded.append(state) or
                        real_load(state))
    launcher._main()
    assert len(loaded) == 1  # auto-resumed from the epoch-0 snapshot
    assert loaded[0]["__units__"][wf.loader.name]["epoch_number"] == 0
    assert wf.decision.complete and wf.loader.epoch_number == 1


def test_launcher_emergency_snapshot(tmp_path):
    root.common.dirs.snapshots = str(tmp_path / "snaps")
    launcher = Launcher(backend="cpu")
    wf, _ = launcher._load(attention_seq.build, max_epochs=1)
    wf.initialize(device=launcher.make_device())
    path = launcher._emergency_snapshot(wf)
    assert path == str(tmp_path / "snaps" /
                       "attention_seq_interrupted.pickle.gz")
    assert os.path.exists(path) and os.path.exists(path + ".sha256")


def test_sigint_writes_the_emergency_snapshot_and_stops(tmp_path,
                                                        monkeypatch):
    """A SIGINT in the middle of training: the handler writes
    ``<name>_interrupted`` and the run stops at the next step boundary,
    where ``latest_snapshot`` finds it."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread "
                    "only")
    launcher = Launcher(backend="cpu")
    wf, _ = launcher._load(attention_seq.build, max_epochs=50)
    steps = {"n": 0}
    real_step = wf.step

    def step():
        steps["n"] += 1
        real_step()
        if steps["n"] == 5:
            os.kill(os.getpid(), signal.SIGINT)

    monkeypatch.setattr(wf, "step", step)
    launcher._main()
    assert steps["n"] == 5 and not wf.decision.complete
    path = os.path.join(str(root.common.dirs.snapshots),
                        "attention_seq_interrupted.pickle.gz")
    assert launcher.latest_snapshot(wf) == path
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def test_listen_master_exclusive():
    with pytest.raises(ValueError):
        Launcher(listen="h:1", master="h:2")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Launcher(listen="h:1")


@pytest.mark.parametrize("flags,item", [
    (["--listen", "localhost:1234"], "A9"),
    (["--master", "localhost:1234"], "A9"),
    (["--nodes", "2"], "A9"),
    (["--process-id", "1"], "A9"),
    (["--n-model", "2"], "A9"),
    (["--optimize", "2x4"], "A13"),
    (["--root", "attention_seq.learning_rate=Tune(0.1, 0.01, 1.0)"], "A13"),
    (["--web-status", "0"], "A12"),
])
def test_an_unported_flag_names_its_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError,
                       match=f"not ported yet \\(ROADMAP {item}\\)"):
        Main().run(["attention_seq", "-b", "cpu", *flags])


def test_no_backend_and_no_gpu_raises(monkeypatch):
    """With no ``-b`` the CLI wants the card; without one it raises and
    trains nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = Main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.run(["attention_seq", "--root", "attention_seq.max_epochs=1"])
    assert not main.launcher.workflow.is_initialized
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Main().run(["attention_seq", "-b", "cuda"])
