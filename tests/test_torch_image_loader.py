"""The image loaders and the native decode pool of the port
(``znicz_tpu_torch.loader.image``, ``znicz_tpu_torch.native``) against
the reference's, on the CPU.

- the port's pool (its own build of its copy of ``pipeline.cpp``) gives
  the reference's pool's bytes for JPEG and PNG, RGB and grayscale,
  float32 and raw uint8, failed files, seeded random crops and flips,
  and matches the pixel-center bilinear oracle;
- ``scan_directory`` and ``carve_validation`` give the reference's
  lists;
- ``FileImageLoader`` minibatches (raw pixels, labels, indices; the
  normalized batch within one f32 ulp of the reference's oracle) equal
  the reference's over 3 epochs with the native pool (prefetched, the
  epochs' first entries included) and with PIL; so do
  ``FullBatchImageLoader``'s;
- ``use_native=None`` is the pool on the CPU when it builds and means
  True on a CUDA device, where a pool that cannot build raises with its
  build error; the loader records the decoder that ran.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from znicz_tpu.backends import NumpyDevice
from znicz_tpu.dummy import DummyWorkflow
from znicz_tpu.loader import image as ref_image
from znicz_tpu.native import ImagePipeline as RefPipeline
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch import native
from znicz_tpu_torch.loader import image
from znicz_tpu_torch.native import ImagePipeline
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root
from znicz_tpu_torch.workflow import Workflow


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def write_dataset(base, n_classes=3, n_per_class=8, hw=(36, 40),
                  fmt="png", seed=3):
    """A class-per-subdirectory tree whose class is the mean intensity
    (the reference test's)."""
    rng = np.random.default_rng(seed)
    for cls in range(n_classes):
        d = os.path.join(base, f"class_{cls}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            level = 40 + cls * 80
            arr = np.clip(rng.normal(level, 12, size=(*hw, 3)),
                          0, 255).astype(np.uint8)
            PILImage.fromarray(arr).save(os.path.join(d, f"s{i}.{fmt}"))
    return base


def bilinear_oracle(img, rh, rw):
    """Pixel-center bilinear resize, the native resizer's spec."""
    h, w, _ = img.shape
    ys = np.clip((np.arange(rh) + .5) * h / rh - .5, 0, h - 1)
    xs = np.clip((np.arange(rw) + .5) * w / rw - .5, 0, w - 1)
    y0 = np.clip(ys.astype(int), 0, max(h - 2, 0))
    x0 = np.clip(xs.astype(int), 0, max(w - 2, 0))
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, np.minimum(x0 + 1, w - 1)]
    c = img[np.minimum(y0 + 1, h - 1)][:, x0]
    d = img[np.minimum(y0 + 1, h - 1)][:, np.minimum(x0 + 1, w - 1)]
    v = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
         + c * wy * (1 - wx) + d * wy * wx)
    return np.floor(v + .5)


@pytest.fixture
def image_tree(tmp_path):
    return write_dataset(str(tmp_path / "data"))


def test_the_pool_builds_into_the_checkout():
    assert ImagePipeline.available(), ImagePipeline.build_error()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("build", "znicz_tpu_torch",
                                           "native")


def _decode_both(paths, shape, dtype, **kwargs):
    outs = []
    for cls in (ImagePipeline, RefPipeline):
        pipe = cls(2)
        out = np.zeros(shape, dtype=dtype)
        pipe.submit(paths, out, **kwargs)
        failed = pipe.wait()
        pipe.close()
        outs.append((out, failed))
    return outs


@pytest.mark.parametrize("fmt", ["png", "jpg"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pool_equals_the_reference_pool(tmp_path, fmt, dtype):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        src = rng.integers(0, 255, (40 + i, 50, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"img{i}.{fmt}"))
        PILImage.fromarray(src).save(paths[-1])
    scale = 1 / 255.0 if dtype == np.float32 else 1.0
    (got, gf), (want, wf) = _decode_both(
        paths, (3, 24, 28, 3), dtype, out_hw=(24, 28), resize_hw=(32, 36),
        scale=scale)
    assert gf == wf == 0
    np.testing.assert_array_equal(got, want)


def test_pool_matches_the_bilinear_oracle(tmp_path):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")  # lossless
    PILImage.fromarray(src).save(path)
    pipe = ImagePipeline(2)
    out = np.zeros((1, 24, 28, 3), dtype=np.float32)
    pipe.submit([path], out, out_hw=(24, 28), resize_hw=(32, 36),
                scale=1 / 255.0)
    assert pipe.wait() == 0
    pipe.close()
    ref = bilinear_oracle(src.astype(np.float64), 32, 36)[4:28, 4:32] / 255.0
    # f32 against f64: one u8 step apart at exact .5 boundaries
    np.testing.assert_allclose(out[0], ref, atol=1.01 / 255.0)
    assert np.mean(np.abs(out[0] - ref) > 1e-6) < 0.02


def test_pool_grayscale_and_failed_files(tmp_path):
    good = str(tmp_path / "g.png")
    PILImage.fromarray(np.full((30, 30, 3), 120, np.uint8)).save(good)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    missing = str(tmp_path / "missing.png")
    (got, gf), (want, wf) = _decode_both(
        [good, bad, missing], (3, 16, 16), np.float32, out_hw=(16, 16),
        resize_hw=None, channels=1)
    assert gf == wf == 2
    np.testing.assert_array_equal(got, want)
    assert np.allclose(got[0], 120.0, atol=1.0)
    assert not got[1:].any()  # failed rows zero-filled


def test_pool_seeded_crop_and_flip(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.png")
    PILImage.fromarray(rng.integers(0, 255, (48, 48, 3),
                                    dtype=np.uint8)).save(path)
    runs = {}
    for seed in (99, 99, 100):
        (got, _), (want, _) = _decode_both(
            [path] * 4, (4, 20, 20, 3), np.uint8, out_hw=(20, 20),
            resize_hw=None, random_crop=True, random_flip=True, seed=seed)
        np.testing.assert_array_equal(got, want)
        runs.setdefault(seed, []).append(got)
    np.testing.assert_array_equal(*runs[99])
    assert not np.array_equal(runs[99][0], runs[100][0])


def test_scan_and_carve_equal_the_reference(image_tree, tmp_path):
    assert image.scan_directory(image_tree) == \
        ref_image.scan_directory(image_tree)
    flat = tmp_path / "flat"
    flat.mkdir()
    PILImage.fromarray(np.zeros((4, 4, 3), np.uint8)).save(flat / "a.png")
    assert image.scan_directory(str(flat)) == \
        ref_image.scan_directory(str(flat))
    paths, labels, _ = image.scan_directory(image_tree)
    prng.seed_all(5)
    ref_prng.seed_all(5)
    assert image.carve_validation(paths, labels, 0.25, prng.get()) == \
        ref_image.carve_validation(paths, labels, 0.25, ref_prng.get())


def _loaders(tree, use_native, prefetch=True, **kwargs):
    kw = dict(train_dir=tree, validation_fraction=0.25, out_hw=(24, 24),
              resize_hw=(28, 28), minibatch_size=6, use_native=use_native,
              prefetch=prefetch, n_threads=2, **kwargs)
    ref_prng.seed_all(1234)
    ref = ref_image.FileImageLoader(DummyWorkflow(), **kw)
    ref.initialize(device=NumpyDevice())
    prng.seed_all(1234)
    port = image.FileImageLoader(Workflow(name="w"), **kw)
    port.initialize(device="cpu")
    return port, ref


@pytest.mark.parametrize("use_native", [True, False])
def test_file_image_loader_equals_the_reference(image_tree, use_native):
    port, ref = _loaders(image_tree, use_native,
                         normalization_scale=1 / 255.0,
                         normalization_bias=0.0)
    try:
        assert port.decoder == ("native" if use_native else "pil")
        assert port.class_lengths == ref.class_lengths == [0, 6, 18]
        assert port.file_paths == ref.file_paths
        assert port.file_labels == ref.file_labels
        n = 3 * len(port._schedule)
        for _ in range(n):
            port.run()
            ref.run()
            ref.minibatch_raw.map_read()
            ref.minibatch_labels.map_read()
            np.testing.assert_array_equal(np.asarray(port.minibatch_indices),
                                          ref._host_indices)
            np.testing.assert_array_equal(port.minibatch_raw.devmem.numpy(),
                                          ref.minibatch_raw.mem)
            np.testing.assert_array_equal(np.asarray(port.minibatch_labels),
                                          ref.minibatch_labels.mem)
            assert int(port.minibatch_valid) == ref.minibatch_size
            ref.numpy_run()
            ref.minibatch_data.map_read()
            np.testing.assert_array_max_ulp(np.asarray(port.minibatch_data),
                                            ref.minibatch_data.mem, maxulp=1)
        if use_native:  # only the first step decoded synchronously
            assert port.prefetch_misses == ref.prefetch_misses == 1
            assert port.epoch_cross_prefetches == 2
    finally:
        port.stop()
        ref.stop()


def test_prefetched_decode_equals_the_synchronous(image_tree):
    batches = {}
    for prefetch in (False, True):
        port, ref = _loaders(image_tree, True, prefetch=prefetch)
        ref.stop()
        for _ in range(8):
            port.run()
            batches.setdefault(prefetch, []).append(
                port.minibatch_raw.devmem.numpy().copy())
        port.stop()
    for a, b in zip(batches[False], batches[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_full_batch_image_loader_equals_the_reference(image_tree,
                                                      use_native):
    kw = dict(train_dir=image_tree, out_hw=(24, 24), resize_hw=(28, 28),
              minibatch_size=8, normalization_scale=1 / 255.0,
              validation_fraction=0.25, use_native=use_native)
    ref_prng.seed_all(9)
    ref = ref_image.FullBatchImageLoader(DummyWorkflow(), **kw)
    ref.initialize(device=NumpyDevice())
    prng.seed_all(9)
    port = image.FullBatchImageLoader(Workflow(name="w"), **kw)
    port.initialize(device="cpu")
    assert port.decoder == ("native" if use_native else "pil")
    ref.original_data.map_read()
    np.testing.assert_array_equal(port.original_data.numpy(),
                                  ref.original_data.mem)
    ref.original_labels.map_read()
    np.testing.assert_array_equal(port.original_labels.numpy(),
                                  ref.original_labels.mem)
    assert port.class_lengths == ref.class_lengths
    for _ in range(5):
        port.run()
        ref.run()
        ref.minibatch_data.map_read()
        np.testing.assert_array_max_ulp(np.asarray(port.minibatch_data),
                                        ref.minibatch_data.mem, maxulp=1)


class _Card:
    type = "cuda"


def test_use_native_none_means_true_on_the_card(monkeypatch):
    assert image._resolve_native(None, _Card()) is True
    assert image._resolve_native(False, _Card()) is False
    assert image._resolve_native(None, torch.device("cpu")) \
        is ImagePipeline.available()
    # a pool that cannot build raises with its build error, never PIL
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error",
                        "native build failed: jpeglib.h: No such file")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        ImagePipeline(1)
