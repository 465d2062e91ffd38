"""The port's graphics service and plotters (``znicz_tpu_torch/graphics.py``,
``plotting_units.py``, ``ops/nn_plotting_units.py``) on the CPU: the
cases of the reference's ``tests/test_plotting.py`` through the port,
and the port held to the reference.

- the server draws every payload kind, logs ``events.jsonl`` with large
  arrays summarized, and a zmq SUB client draws what the PUB server
  sends (pyzmq);
- the accumulators and ``tile_filters`` as in the reference's cases;
- a blobs workflow with the error, confusion and weights plotters and
  the image saver, on the numpy oracle and on the CPU device: a point a
  epoch, the confusion matrix's trace the correct count, the PNGs and
  3 × 3 event lines; the MSE loss's error plotter;
- parity: ``tile_filters`` bit-equal to the reference's on seeded
  weights; ``_summarize`` and the ``events.jsonl`` line of one payload
  equal in both packages; the error curves and the confusion matrix of
  one seeded blobs workflow equal to the reference's numpy-oracle run
  (within 1e-5; the percentages are counts over the same samples).

No wall-clock bound: the zmq case polls until a payload arrives, as the
reference's does.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from conftest import make_blobs
from znicz_tpu import graphics as ref_graphics
from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.ops.nn_plotting_units import tile_filters as ref_tile_filters
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch import graphics
from znicz_tpu_torch.graphics import GraphicsClient, GraphicsServer
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops.accumulator import FixAccumulator, RangeAccumulator
from znicz_tpu_torch.ops.nn_plotting_units import tile_filters
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

N_CLASSES, DIM = 3, 10
#: the error curves and confusion counts against the reference's oracle
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.plots = str(tmp_path / "plots")
    root.common.dirs.images = str(tmp_path / "images")
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    graphics.reset_server()
    reset_root()


# -- the graphics service -----------------------------------------------------
def test_server_renders_and_logs_all_kinds(tmp_path):
    srv = GraphicsServer(out_dir=str(tmp_path), render=True)
    srv.submit({"kind": "curve", "name": "err",
                "series": {"train": [[0, 1, 2], [3.0, 2.0, 1.0]]},
                "step": 2})
    srv.submit({"kind": "matrix", "name": "conf",
                "data": np.arange(9).reshape(3, 3)})
    srv.submit({"kind": "image", "name": "img",
                "data": np.random.rand(8, 8)})
    srv.submit({"kind": "hist", "name": "h",
                "data": np.array([1, 5, 2]),
                "bin_centers": np.array([0.1, 0.2, 0.3]),
                "bar_width": 0.05})
    srv.stop()
    for name in ("err", "conf", "img", "h"):
        assert os.path.exists(tmp_path / f"{name}.png"), name
    events = [json.loads(line)
              for line in open(tmp_path / "events.jsonl")]
    assert len(events) == 4
    assert events[0]["series"]["train"] == [[0, 1, 2], [3.0, 2.0, 1.0]]


def test_server_summarizes_large_arrays(tmp_path):
    srv = GraphicsServer(out_dir=str(tmp_path), render=False)
    srv.submit({"kind": "image", "name": "big",
                "data": np.ones((64, 64))})
    srv.stop()
    event = json.loads(open(tmp_path / "events.jsonl").read())
    assert event["data"] == {"shape": [64, 64], "min": 1.0, "max": 1.0,
                             "mean": 1.0}


def test_zmq_pub_sub_roundtrip(tmp_path):
    """The live-viewer channel: a PUB server, a SUB client that draws
    the payload (in this process)."""
    srv = GraphicsServer(out_dir=str(tmp_path / "srv"), render=False,
                         publish_port=0)  # a free port
    cli = GraphicsClient(srv.endpoint, out_dir=str(tmp_path / "cli"))
    time.sleep(0.2)  # PUB/SUB joining is asynchronous
    got = False
    for _ in range(100):
        srv.submit({"kind": "image", "name": "live",
                    "data": np.random.rand(4, 4)})
        if cli.poll_once(200):
            got = True
            break
    cli.close()
    srv.stop()
    assert got
    assert os.path.exists(tmp_path / "cli" / "live.png")


def test_failed_draw_is_logged_and_rendering_goes_on(tmp_path):
    """The reference's behaviour, in both packages: a payload the
    renderer cannot draw (``MultiHistogram``'s ``multi_hist``) is logged
    to ``events.jsonl`` and draws no PNG, and the next payload is
    drawn."""
    for module, out in ((graphics, "port"), (ref_graphics, "ref")):
        srv = module.GraphicsServer(out_dir=str(tmp_path / out),
                                    render=True, publish_port=False)
        srv.submit({"kind": "multi_hist", "name": "mh",
                    "panels": {"w": [1, 2, 3]}})
        assert srv.flush()
        srv.submit({"kind": "image", "name": "after",
                    "data": np.random.rand(4, 4)})
        srv.stop()
        assert sorted(os.listdir(tmp_path / out)) == [
            "after.png", "events.jsonl"], out
        assert len(open(tmp_path / out / "events.jsonl").readlines()) == 2


# -- the accumulators ---------------------------------------------------------------
def test_fix_accumulator():
    acc = FixAccumulator(None, lo=0.0, hi=1.0, n_bins=10)
    acc.observe(np.array([0.05, 0.15, 0.15, 5.0, -3.0]))
    h = acc.histogram.mem
    assert h[0] == 2  # 0.05 and the clamped -3.0
    assert h[1] == 2
    assert h[-1] == 1  # the clamped 5.0
    assert acc.n_observed == 5


def test_range_accumulator_rebins():
    acc = RangeAccumulator(None, n_bins=4)
    acc.observe(np.array([0.0, 1.0]))
    assert acc.x_min == 0.0 and acc.x_max == 1.0
    acc.observe(np.array([3.0]))  # widens: all 3 samples binned again
    assert acc.x_max == 3.0
    assert int(acc.histogram.mem.sum()) == 3
    assert acc.n_observed == 3


# -- tile_filters -----------------------------------------------------------------
def test_tile_filters_square_inference():
    w = np.random.rand(16, 6).astype(np.float32)  # 4×4 fields, 6 units
    img = tile_filters(w)
    side = int(np.ceil(np.sqrt(6)))
    assert img.shape == (side * 5 + 1, side * 5 + 1)
    assert img.max() <= 1.0 and img.min() >= 0.0


def test_tile_filters_conv_kernels():
    w = np.random.rand(3, 3, 3, 5).astype(np.float32)
    img = tile_filters(w)
    assert img.ndim == 3 and img.shape[-1] == 3  # RGB kernels stay RGB
    # a channel count imshow cannot draw collapses to grayscale
    img2 = tile_filters(np.random.rand(3, 3, 2, 5).astype(np.float32))
    assert img2.ndim == 2


@pytest.mark.parametrize("shape, kwargs", [
    ((784, 100), {"sample_shape": (28, 28)}),
    ((16, 6), {}),
    ((15, 70), {"max_tiles": 9}),
    ((3, 3, 3, 5), {}),
    ((5, 5, 4, 7), {}),
])
def test_tile_filters_bit_equal_to_the_reference(shape, kwargs):
    w = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    got = tile_filters(w, **kwargs)
    want = ref_tile_filters(w, **kwargs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_summarize_and_event_lines_equal_the_references(tmp_path):
    rng = np.random.default_rng(9)
    payload = {"kind": "curve", "name": "err", "step": np.int64(3),
               "series": {"train": [[0.0, 1.0], [5.5, np.float32(2.5)]]},
               "data": rng.normal(size=(40, 40)).astype(np.float32),
               "small": np.arange(6).reshape(2, 3),
               "long": list(range(300)), "labels": ("a", "b")}
    assert graphics._summarize(payload) == ref_graphics._summarize(payload)
    lines = []
    for module, out in ((graphics, "port"), (ref_graphics, "ref")):
        srv = module.GraphicsServer(out_dir=str(tmp_path / out),
                                    render=False, publish_port=False)
        srv.submit(payload)
        srv.stop()
        lines.append(open(tmp_path / out / "events.jsonl").read())
    assert lines[0] == lines[1] and lines[0].count("\n") == 1


# -- plotters riding a training workflow ---------------------------------------------
def _blobs_factory(cls, mse: bool = False):
    data, labels = make_blobs(40, N_CLASSES, DIM)
    if mse:
        return lambda w: cls(w, train_data=data[:90], valid_data=data[90:],
                             minibatch_size=30)
    return lambda w: cls(w, train_data=data[:90], train_labels=labels[:90],
                         valid_data=data[90:], valid_labels=labels[90:],
                         minibatch_size=30)


LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": N_CLASSES},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
]


def build(tmp_path, cls=StandardWorkflow, loader=ArrayLoader,
          max_epochs=3, server_cls=GraphicsServer, saver=True):
    wf = cls(name="mlp_plot", loader_factory=_blobs_factory(loader),
             layers=LAYERS, evaluator_config={"compute_confusion": True},
             decision_config={"max_epochs": max_epochs})
    wf._max_fires = 100_000
    srv = server_cls(out_dir=str(tmp_path / "plots"), render=True,
                     publish_port=False)
    wf.link_error_plotter(server=srv)
    wf.link_confusion_plotter(server=srv)
    wf.link_weights_plotter(server=srv)
    if saver:
        wf.link_image_saver(out_dir=str(tmp_path / "images"), limit=16)
    return wf, srv


@pytest.mark.parametrize("device", ["numpy", "cpu"])
def test_workflow_observability(tmp_path, device):
    wf, srv = build(tmp_path)
    wf.initialize(device=device)
    wf.run()
    srv.stop()
    # one point an epoch on each class with samples
    xs, _ys = wf.error_plotter.values["train"]
    assert len(xs) == 3
    # the validation counts sum to the validation set
    cm = wf.decision.confusion_matrixes[1]
    assert cm is not None and cm.sum() == 30
    # the trace is the correct count: the set less the last epoch's
    # errors (epoch_n_err is reset after each epoch)
    assert np.trace(cm) == 30 - wf.decision.last_epoch_n_err[1]
    for png in ("error_plotter.png", "confusion_matrix.png",
                "weights2d_l0.png"):
        assert os.path.exists(tmp_path / "plots" / png), png
    events = [json.loads(line)
              for line in open(tmp_path / "plots" / "events.jsonl")]
    assert len(events) == 9  # 3 epochs × 3 plotters
    # the image saver wrote the last epoch's misclassified PNGs
    img_root = tmp_path / "images"
    epochs = sorted(os.listdir(img_root))
    assert epochs, "no image-saver output"
    files = os.listdir(img_root / epochs[-1])
    for f in files:
        assert f.endswith(".png")
    assert 0 < len(files) <= 16
    idx, t, p = files[0][:-4].split("_")
    assert t.startswith("t") and p.startswith("p") and int(idx) >= 0


def test_mse_decision_error_plotter(tmp_path):
    """The error plotter also rides an MSE workflow (``epoch_mse``)."""
    wf = StandardWorkflow(
        name="ae_plot", loader_factory=_blobs_factory(ArrayLoader, mse=True),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
             "<-": {"learning_rate": 0.05}},
            {"type": "all2all", "->": {"output_sample_shape": DIM},
             "<-": {"learning_rate": 0.05}},
        ],
        loss="mse", decision_config={"max_epochs": 2})
    wf._max_fires = 100_000
    srv = GraphicsServer(out_dir=str(tmp_path / "plots"), render=False)
    wf.link_error_plotter(server=srv)
    wf.initialize(device="numpy")
    wf.run()
    srv.stop()
    xs, ys = wf.error_plotter.values["validation"]
    assert len(xs) == 2 and all(np.isfinite(ys))


@pytest.mark.parametrize("device", ["numpy", "cpu"])
def test_curves_and_confusion_equal_the_references(tmp_path, device):
    """One seeded blobs workflow in both packages (no dropout): the error
    curves of every class and the last confusion matrix equal the
    reference oracle's within ``TOL``, and so do the weights plotter's
    tiles."""
    ref_prng.seed_all(21)
    ref, ref_srv = build(tmp_path / "ref", RefWorkflow, RefLoader,
                         server_cls=ref_graphics.GraphicsServer,
                         saver=False)
    ref.initialize(device=RefNumpyDevice())
    ref.run()
    ref_srv.stop()
    prng.seed_all(21)
    port, srv = build(tmp_path / "port", saver=False)
    port.initialize(device=device)
    port.run()
    srv.stop()
    assert port.error_plotter.values.keys() == ref.error_plotter.values.keys()
    for label, (xs, ys) in ref.error_plotter.values.items():
        got_x, got_y = port.error_plotter.values[label]
        assert got_x == xs, label
        np.testing.assert_allclose(got_y, ys, rtol=0, atol=TOL,
                                   err_msg=label)
    for cls in (1, 2):
        np.testing.assert_allclose(port.decision.confusion_matrixes[cls],
                                   ref.decision.confusion_matrixes[cls],
                                   rtol=0, atol=TOL)
    ref.forwards[0].weights.map_read()
    want = ref_tile_filters(np.array(ref.forwards[0].weights.mem))
    got = tile_filters(port.forwards[0].weights.detach().numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
