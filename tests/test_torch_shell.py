"""The port's interactive shell (``znicz_tpu_torch/interaction.py``,
``StandardWorkflow.link_shell``) and the launcher's graphics switch on
the CPU: the shell cases of the reference's ``tests/test_web_shell.py``,
then ``Launcher(graphics=…)`` and the CLI's ``--no-graphics``.

- the shell fires once an epoch with the workflow, its loader and its
  decision in its namespace and the sample named in its banner; set
  ``enabled = False`` from inside, it fires no more;
- ``graphics=False`` (``--no-graphics``) turns the render thread off: a
  plotter still logs ``events.jsonl`` and no PNG is drawn;
  ``graphics=True`` starts the process's server before the run and it
  draws.
"""

from __future__ import annotations

import json
import os

import pytest

from znicz_tpu_torch import graphics
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models.samples.wine import build
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.plots = str(tmp_path / "plots")
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    graphics.reset_server()
    reset_root()


def test_shell_unit_fires_with_namespace():
    prng.seed_all(2)
    wf = build(max_epochs=1)
    seen = {}

    def fake_interact(banner, local):
        seen["banner"] = banner
        seen["local"] = dict(local)

    wf.link_shell(interact_fn=fake_interact)
    wf.initialize(device="numpy")
    wf.run()
    assert "workflow" in seen["local"]
    assert seen["local"]["workflow"] is wf
    assert "loader" in seen["local"] and "decision" in seen["local"]
    assert "wine" in seen["banner"]


def test_shell_disable_stops_firing():
    prng.seed_all(3)
    wf = build(max_epochs=3)
    calls = {"n": 0}

    def fake_interact(banner, local):
        calls["n"] += 1
        local["shell"].enabled = False  # the user opts out from inside

    wf.link_shell(interact_fn=fake_interact)
    wf.initialize(device="numpy")
    wf.run()
    assert calls["n"] == 1


def _plotted(**overrides):
    wf = build(**overrides)
    wf.link_error_plotter()  # the process's server, made on first use
    return wf


@pytest.mark.parametrize("render", [False, True])
def test_launcher_graphics_switch(render):
    launcher = Launcher(backend="numpy", graphics=render)
    launcher._load(_plotted, max_epochs=2)
    launcher._main()
    assert root.common.graphics.render is render
    server = graphics.get_server()
    assert server.render is render
    assert graphics.flush_server()
    plots = root.common.dirs.plots
    events = open(os.path.join(plots, "events.jsonl")).readlines()
    assert len(events) == 2 and json.loads(events[0])["name"] == \
        "error_plotter"
    assert os.path.exists(os.path.join(plots, "error_plotter.png")) is render


def test_cli_no_graphics():
    main = Main()
    assert main.run(["wine", "-b", "numpy", "--no-graphics",
                     "--root", "wine.max_epochs=1"]) == 0
    assert main.launcher._graphics is False
    assert root.common.graphics.render is False
    main = Main()
    assert main.run(["wine", "-b", "numpy",
                     "--root", "wine.max_epochs=1"]) == 0
    assert main.launcher._graphics is None
