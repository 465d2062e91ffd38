"""The port's report chain (``znicz_tpu_torch/publishing.py`` and
``StandardWorkflow.link_publisher``) on the CPU: the publisher cases of
the reference's ``tests/test_export_publish.py``, and the port held to
the reference.

- a trained Wine workflow's report in md, html and json: the title, the
  best validation error, the layer types, the epochs, the snapshot, a
  table;
- ``link_publisher`` fires once, at completion, under ``run`` and under
  ``run_chunked``, its plots this run's only;
- parity: one report dict renders to the same Markdown and HTML strings
  in both packages (the ``generated`` stamp pinned, a PNG embedded);
  the port's Wine report has the reference's keys, metric names, layer
  names, types, output shapes and parameter counts.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from znicz_tpu import publishing as ref_publishing
from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.models.samples import wine as ref_wine
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch import graphics, publishing
from znicz_tpu_torch.graphics import GraphicsServer
from znicz_tpu_torch.models.samples.wine import build
from znicz_tpu_torch.publishing import Publisher
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.plots = str(tmp_path / "plots")
    root.common.dirs.cache = str(tmp_path / "cache")
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    graphics.reset_server()
    reset_root()


def train_wine(device="numpy", **overrides):
    prng.seed_all(321)
    wf = build(max_epochs=4, **overrides)
    wf.initialize(device=device)
    wf.run()
    return wf


def test_publisher_writes_reports(tmp_path):
    wf = train_wine(
        snapshotter_config={"prefix": "pub", "directory": str(tmp_path)})
    # the publisher fires through the decision's gate; fire it directly
    pub = Publisher(wf, out_dir=str(tmp_path),
                    formats=("md", "html", "json"))
    pub.run()
    assert len(pub.destinations) == 3
    md = open(os.path.join(tmp_path, "wine_report.md")).read()
    assert "Training report: wine" in md
    assert "best validation error %" in md
    assert "All2AllTanh" in md and "All2AllSoftmax" in md
    blob = json.load(open(os.path.join(tmp_path, "wine_report.json")))
    assert blob["metrics"]["epochs"] >= 3
    assert blob["snapshot"]
    html_text = open(os.path.join(tmp_path, "wine_report.html")).read()
    assert "<table" in html_text


def test_publisher_fires_on_completion(tmp_path):
    prng.seed_all(11)
    wf = build(max_epochs=2)
    wf.link_publisher(out_dir=str(tmp_path), formats=("json",))
    wf.initialize(device="numpy")
    wf.run()
    assert wf.publisher.destinations
    blob = json.load(open(wf.publisher.destinations[0]))
    assert blob["title"] == "wine"
    assert wf.publisher.run_count == 1  # once, at completion


def test_unknown_format_refused_at_wiring_time():
    wf = build(max_epochs=1)
    with pytest.raises(ValueError, match="unknown report format"):
        wf.link_publisher(formats=("md", "pdf"))


@pytest.mark.parametrize("chunk", [1, 4])
def test_publisher_fires_once_under_run_chunked(tmp_path, chunk):
    """On the CPU device, the region's path: the report fires once under
    ``run_chunked`` as under ``run``, after the last epoch, with this
    run's plots (the weights plotter's PNG, drawn before the report)."""
    prng.seed_all(11)
    wf = build(max_epochs=3)
    srv = graphics.get_server()
    wf.link_weights_plotter(server=srv)
    wf.link_publisher(out_dir=str(tmp_path), formats=("json", "html"))
    wf.initialize(device="cpu")
    wf.run_chunked(chunk)
    assert wf.decision.complete
    assert wf.publisher.run_count == 1
    assert wf.weights_plotter.run_count == 3
    blob = json.load(open(wf.publisher.destinations[0]))
    assert [os.path.basename(p) for p in blob["plots"]] == \
        ["weights2d_l0.png"]
    assert blob["metrics"]["epochs"] == wf.loader.epoch_number
    page = open(wf.publisher.destinations[1]).read()
    assert "data:image/png;base64," in page


def _report(png: str) -> dict:
    return {
        "title": "wine", "generated": "2026-10-18 12:00:00",
        "metrics": {"epochs": 4, "best validation error %": 3.5714},
        "layers": [{"name": "All2AllTanh", "type": "All2AllTanh",
                    "output_shape": (8,), "parameters": 112},
                   {"name": "All2AllSoftmax", "type": "All2AllSoftmax",
                    "output_shape": (3,), "parameters": 27}],
        "timing": [{"unit": "train_region", "runs": 72,
                    "total_s": 0.125}],
        "plots": [png], "snapshot": "/snap/wine_3.57pt.pickle.gz",
        "config": {"minibatch_size": 10, "layers": [8],
                   "note": "<b>&amp;</b>"},
    }


def test_renderers_equal_the_references(tmp_path):
    png = str(tmp_path / "error_plotter.png")
    srv = GraphicsServer(out_dir=str(tmp_path), render=True,
                         publish_port=False)
    srv.submit({"kind": "curve", "name": "error_plotter",
                "series": {"train": [[0, 1], [9.0, 4.0]]}})
    srv.stop()
    report = _report(png)
    assert publishing.render_markdown(report) == \
        ref_publishing.render_markdown(report)
    assert publishing.render_html(report) == \
        ref_publishing.render_html(report)
    assert "data:image/png;base64," in publishing.render_html(report)
    empty = {**report, "metrics": {}, "layers": [], "timing": [],
             "plots": [], "snapshot": None, "config": {}}
    assert publishing.render_markdown(empty) == \
        ref_publishing.render_markdown(empty)
    assert publishing.render_html(empty) == ref_publishing.render_html(empty)


def test_wine_report_has_the_references_shape():
    ref_prng.seed_all(321)
    ref = ref_wine.build(max_epochs=4)
    ref.initialize(device=RefNumpyDevice())
    ref.run()
    want = json.loads(json.dumps(ref_publishing.gather_report(ref),
                                 default=str))
    got = json.loads(json.dumps(publishing.gather_report(train_wine()),
                                default=str))
    assert sorted(got) == sorted(want)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    assert got["title"] == want["title"]
    for key in ("name", "type", "output_shape", "parameters"):
        assert [row[key] for row in got["layers"]] == \
            [row[key] for row in want["layers"]], key
    assert sorted(got["config"]) == sorted(want["config"])
    assert got["metrics"]["epochs"] == want["metrics"]["epochs"]
    assert np.isfinite(got["metrics"]["best validation error %"])
