"""The port's model zoo (``znicz_tpu_torch/forge.py``) on the CPU: the
cases of the reference's ``tests/test_forge.py`` through the port, and
bundles crossing between the packages.

- package → manifest → extract → serve a trained Wine workflow;
- the registry's numeric-aware versions, immutable uploads, garbage
  refused; the HTTP server and client on loopback;
- integrity: the ``.sha256`` sidecar of an upload, a corrupt bundle
  quarantined with the fetch falling back to the newest good version
  (counted), trust-on-first-fetch for a bundle without a sidecar, a
  corrupt registry answering 410 over HTTP, and ``fleet.model_corrupt``
  fired in the port's ``ForgeRegistry.fetch``;
- across the packages: a bundle the reference packages is fetched from
  the port's registry and served by the port's ``ExportedModel`` on the
  CPU within 1e-5 of the reference's ``ExportedModel``; a bundle the port
  packages is read by the reference's ``read_manifest`` and
  ``extract_model`` and served by both packages alike.

No wall-clock bound: every HTTP call waits on its reply.
"""

from __future__ import annotations

import io
import os
import tarfile
import urllib.error
import urllib.request

import numpy as np
import pytest

from znicz_tpu import forge as ref_forge
from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.export import ExportedModel as RefExportedModel
from znicz_tpu.models.samples import wine as ref_wine
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch import datasets
from znicz_tpu_torch.export import ExportedModel
from znicz_tpu_torch.forge import (ForgeClient, ForgeRegistry, ForgeServer,
                                   extract_model, package, read_manifest)
from znicz_tpu_torch.models.samples.wine import build
from znicz_tpu_torch.observe import metrics as obs_metrics
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import SnapshotCorrupt, _sha256_file

#: the port's replies against the reference's on one bundle (f32, the
#: products summed in other orders)
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.plots = str(tmp_path / "plots")
    yield
    reset_root()


@pytest.fixture
def trained_wine():
    prng.seed_all(31)
    wf = build(max_epochs=3)
    wf.initialize(device="numpy")
    wf.run()
    return wf


def _data():
    return datasets.load_wine()


def _corrupt(path, at=10, data=b"\xde\xad\xbe\xef"):
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(data)


def test_package_roundtrip(trained_wine, tmp_path):
    bundle = str(tmp_path / "wine.forge.tar.gz")
    assert package(trained_wine, bundle, version="1.2.0",
                   author="tests", description="hello") == bundle
    manifest = read_manifest(bundle)
    assert manifest["name"] == "wine"
    assert manifest["version"] == "1.2.0"
    assert manifest["format"] == "znicz-tpu-forge"
    assert "best validation error %" in manifest["metrics"]

    model_path = extract_model(bundle, str(tmp_path / "serve"))
    model = ExportedModel.load(model_path, device="numpy")
    data, labels = _data()
    acc = (model.predict_classes(data[150:]) == labels[150:]).mean()
    assert acc > 0.5  # a trained model came through


def test_registry_versions(trained_wine, tmp_path):
    registry = ForgeRegistry(str(tmp_path / "reg"))
    for version in ("1.9.0", "1.10.0", "1.2.0"):
        bundle = str(tmp_path / f"b{version}.forge.tar.gz")
        package(trained_wine, bundle, version=version)
        registry.upload(bundle)
    assert registry.list() == {"wine": ["1.10.0", "1.2.0", "1.9.0"]}
    assert registry.latest_version("wine") == "1.10.0"  # numeric-aware
    assert registry.fetch("wine").endswith("1.10.0.forge.tar.gz")
    assert registry.manifest("wine", "1.2.0")["version"] == "1.2.0"
    # versions are immutable
    bundle = str(tmp_path / "dup.forge.tar.gz")
    package(trained_wine, bundle, version="1.2.0")
    with pytest.raises(FileExistsError):
        registry.upload(bundle)
    with pytest.raises(KeyError):
        registry.fetch("nope")


def test_registry_rejects_garbage(tmp_path):
    registry = ForgeRegistry(str(tmp_path / "reg"))
    bad = tmp_path / "bad.forge.tar.gz"
    with tarfile.open(bad, "w:gz") as tar:
        data = b"{}"
        info = tarfile.TarInfo("manifest.json")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="not a forge bundle"):
        registry.upload(str(bad))
    with pytest.raises(ValueError, match="invalid model name"):
        package(None, str(tmp_path / "x"), name="../up")


def test_http_publish_fetch(trained_wine, tmp_path):
    registry = ForgeRegistry(str(tmp_path / "reg"))
    server = ForgeServer(registry, port=0)
    try:
        client = ForgeClient(f"http://127.0.0.1:{server.port}")
        bundle = str(tmp_path / "up.forge.tar.gz")
        package(trained_wine, bundle, version="2.0.0")
        manifest = client.upload(bundle)
        assert manifest["version"] == "2.0.0"
        assert client.list() == {"wine": ["2.0.0"]}
        # a duplicate upload: a clean 400, raised as RuntimeError
        with pytest.raises(RuntimeError, match="already published"):
            client.upload(bundle)
        fetched = client.fetch("wine", str(tmp_path / "down"))
        assert read_manifest(fetched)["version"] == "2.0.0"
        model_path = extract_model(fetched, str(tmp_path / "down"))
        model = ExportedModel.load(model_path, device="numpy")
        data, _ = _data()
        assert model(data[:4]).shape == (4, 3)
    finally:
        server.stop()


def test_upload_writes_sha256_sidecar_and_fetch_verifies(trained_wine,
                                                         tmp_path):
    registry = ForgeRegistry(str(tmp_path / "reg"))
    bundle = str(tmp_path / "b.forge.tar.gz")
    package(trained_wine, bundle, version="1.0.0")
    registry.upload(bundle)
    path = registry.fetch("wine")
    sidecar = f"{path}.sha256"
    assert os.path.exists(sidecar)
    with open(sidecar) as f:
        assert f.read().strip() == _sha256_file(path)


def test_fetch_quarantines_corrupt_bundle_and_falls_back(trained_wine,
                                                         tmp_path):
    """A bundle whose bytes no longer match its sidecar is quarantined on
    fetch (never handed to a loader) and the fetch falls back to the
    newest older good version, counted on the failure and recovery
    series."""
    registry = ForgeRegistry(str(tmp_path / "reg"))
    for version in ("1.0.0", "1.1.0"):
        bundle = str(tmp_path / f"b{version}.forge.tar.gz")
        package(trained_wine, bundle, version=version)
        registry.upload(bundle)
    _corrupt(registry._bundle_path("wine", "1.1.0"))
    fails = obs_metrics.snapshot_failures("forge")
    recov = obs_metrics.recoveries("forge_fallback")
    f0, r0 = fails.value, recov.value
    path = registry.fetch("wine")  # falls back, does not raise
    assert path.endswith("1.0.0.forge.tar.gz")
    assert fails.value - f0 == 1 and recov.value - r0 == 1
    # the corrupt file is out of the serving set for good
    assert registry.list() == {"wine": ["1.0.0"]}
    qdir = os.path.join(str(tmp_path / "reg"), "wine", "quarantine")
    assert sorted(os.listdir(qdir)) == [
        "1.1.0.forge.tar.gz", "1.1.0.forge.tar.gz.sha256"]
    # the survivor still serves
    model_path = extract_model(path, str(tmp_path / "serve"))
    model = ExportedModel.load(model_path, device="numpy")
    data, _ = _data()
    assert model(data[:2]).shape == (2, 3)
    # a fetch of a named corrupt version raises instead of substituting
    bundle = str(tmp_path / "b2.forge.tar.gz")
    package(trained_wine, bundle, version="1.2.0")
    registry.upload(bundle)
    _corrupt(registry._bundle_path("wine", "1.2.0"), data=b"\0\0\0\0")
    with pytest.raises(SnapshotCorrupt):
        registry.fetch("wine", "1.2.0")
    # nothing left to fall back to: SnapshotCorrupt, not silence
    _corrupt(registry._bundle_path("wine", "1.0.0"), data=b"\xff" * 4)
    with pytest.raises(SnapshotCorrupt, match="no version"):
        registry.fetch("wine")


def test_fetch_legacy_bundle_pins_sidecar_on_first_read(trained_wine,
                                                        tmp_path):
    registry = ForgeRegistry(str(tmp_path / "reg"))
    bundle = str(tmp_path / "b.forge.tar.gz")
    package(trained_wine, bundle, version="1.0.0")
    registry.upload(bundle)
    path = registry._bundle_path("wine", "1.0.0")
    os.unlink(f"{path}.sha256")  # an upload from before the sidecars
    fetched = registry.fetch("wine")
    assert os.path.exists(f"{fetched}.sha256")  # pinned on first read
    _corrupt(path, data=b"\xde\xad")  # and enforced from then on
    with pytest.raises(SnapshotCorrupt):
        registry.fetch("wine")


def test_fleet_model_corrupt_chaos_site(trained_wine, tmp_path):
    """``fleet.model_corrupt`` makes a fetch treat the newest bundle as
    digest-corrupt: quarantine and fallback, fired in the port."""
    registry = ForgeRegistry(str(tmp_path / "reg"))
    for version in ("1.0.0", "2.0.0"):
        bundle = str(tmp_path / f"b{version}.forge.tar.gz")
        package(trained_wine, bundle, version=version)
        registry.upload(bundle)
    recov = obs_metrics.recoveries("forge_fallback")
    r0 = recov.value
    root.common.engine.faults = {"fleet.model_corrupt": {"at": [1]}}
    path = registry.fetch("wine")
    assert path.endswith("1.0.0.forge.tar.gz")  # fell back past 2.0.0
    assert registry.list() == {"wine": ["1.0.0"]}
    assert root.common.engine.faults.counts() == {"fleet.model_corrupt": 1}
    assert recov.value - r0 == 1
    assert registry.fetch("wine").endswith("1.0.0.forge.tar.gz")


def test_http_fetch_refuses_corrupt_bundle(trained_wine, tmp_path):
    """The HTTP path rides the same check: a fully corrupt registry
    answers 410 and streams no corrupt bytes."""
    registry = ForgeRegistry(str(tmp_path / "reg"))
    bundle = str(tmp_path / "b.forge.tar.gz")
    package(trained_wine, bundle, version="1.0.0")
    registry.upload(bundle)
    _corrupt(registry._bundle_path("wine", "1.0.0"))
    server = ForgeServer(registry, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/fetch?name=wine",
                timeout=30)
        assert exc_info.value.code == 410
    finally:
        server.stop()


def test_latest_version_semver_ordering(trained_wine, tmp_path):
    """Numeric-aware and a release over its pre-release: 2.0.0 beats
    2.0.0-rc1; a longer numeric version beats a shorter one."""
    registry = ForgeRegistry(str(tmp_path / "reg"))
    for version in ("2.0.0-rc1", "2.0.0", "1.10.0", "2.0.0.1"):
        bundle = str(tmp_path / f"m{version}.forge.tar.gz")
        package(trained_wine, bundle, version=version)
        registry.upload(bundle)
    assert registry.latest_version("wine") == "2.0.0.1"
    os.unlink(registry.fetch("wine", "2.0.0.1"))
    assert registry.latest_version("wine") == "2.0.0"
    registry.fetch("wine")  # must not raise


# -- bundles across the packages ------------------------------------------------
def _ref_trained():
    ref_prng.seed_all(31)
    wf = ref_wine.build(max_epochs=3)
    wf.initialize(device=RefNumpyDevice())
    wf.run()
    return wf


def test_reference_bundle_fetched_and_served_by_the_port(tmp_path):
    bundle = str(tmp_path / "ref.forge.tar.gz")
    ref_forge.package(_ref_trained(), bundle, version="3.1.0")
    registry = ForgeRegistry(str(tmp_path / "reg"))
    assert registry.upload(bundle)["version"] == "3.1.0"
    server = ForgeServer(registry, port=0)
    try:
        fetched = ForgeClient(f"http://127.0.0.1:{server.port}").fetch(
            "wine", str(tmp_path / "down"))
    finally:
        server.stop()
    model_path = extract_model(fetched, str(tmp_path / "serve"))
    x, _ = ref_wine.make_data()
    want = RefExportedModel.load(model_path, device=RefNumpyDevice())(x[:17])
    for device in ("cpu", "numpy"):
        got = ExportedModel.load(model_path, device=device)(x[:17])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_port_bundle_read_by_the_reference(trained_wine, tmp_path):
    bundle = str(tmp_path / "port.forge.tar.gz")
    package(trained_wine, bundle, version="1.0.0", author="port")
    manifest = ref_forge.read_manifest(bundle)
    assert manifest == read_manifest(bundle)
    assert manifest["author"] == "port" and manifest["workflow"] == "wine"
    ref_registry = ref_forge.ForgeRegistry(str(tmp_path / "refreg"))
    ref_registry.upload(bundle)
    model_path = ref_forge.extract_model(ref_registry.fetch("wine"),
                                         str(tmp_path / "ref"))
    data, _ = _data()
    want = RefExportedModel.load(model_path,
                                 device=RefNumpyDevice())(data[:9])
    got = ExportedModel.load(model_path, device="cpu")(data[:9])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
