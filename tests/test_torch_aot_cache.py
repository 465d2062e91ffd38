"""The port's kernel-library store (``znicz_tpu_torch/serving/
aot_cache.py``) on the CPU, held to the contract the reference's
``tests/test_aot_cache.py`` states for its store: a wrong library never
loads (a key or digest mismatch is a miss and ``nvcc`` builds), a
stored library is the built one byte for byte, and every verdict is on
``znicz_aot_cache_total``.

There is no ``nvcc`` here: ``CUDA_HOME`` points at a fake one under
``tmp_path``, a shell script that answers ``--version``, appends the
name of each source it is asked to build to a log, and writes its
``-o`` file with ``gcc`` from a stub C file, a real shared object that
exports its own name.  The tests count builds in the log (none after a
hit, one after a quarantine) and give the build directory a fresh root
to stand for a second process on a fresh checkout.

The reference's ten tests, one by one:

- ``test_disabled_by_default``, ``test_serving_roundtrip_bitwise``
  (here: the libraries round trip byte for byte and load),
  ``test_warmup_counts_resident_programs`` (here: a warm build
  directory asks neither the store nor ``nvcc``),
  ``test_corrupt_entry_quarantined_and_refilled`` (rotted on disk and
  by the ``aotcache.corrupt`` site; and an entry ``ctypes`` cannot
  load), ``test_key_mismatch_is_a_miss``, ``test_size_bound_evicts_
  oldest``, ``test_publish_carries_programs`` and
  ``test_corrupt_pack_rejected_weights_survive`` have counterparts of
  the same intent;
- ``test_region_roundtrip_identical_weights`` becomes "a region step
  after a store hit is bit-equal" (on the CPU the step runs the plain
  versions; the card's replies after a hit are held bit-equal to a
  build's in ``chip_smoke.py`` phase 19);
- ``test_respecialize_guard_falls_back_on_sharding_change`` has no
  counterpart: it tests the reference's re-specialization of a
  deserialized XLA program when a mesh changes its input shardings, and
  the port has no deserialized program to re-specialize (a CUDA graph
  is captured at start and never persisted).
"""

from __future__ import annotations

import ctypes
import glob
import os
import stat

import numpy as np
import pytest

from conftest import make_blobs
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.ops import _cuda
from znicz_tpu_torch.serving import aot_cache
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

STEMS = [os.path.splitext(name)[0] for name in _cuda.SOURCES]

FAKE_NVCC = """#!/bin/sh
for a in "$@"; do
  if [ "$a" = "--version" ]; then echo "$FAKE_NVCC_VERSION"; exit 0; fi
done
out=""; src=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in *.cu) src="$a";; esac
  prev="$a"
done
stem=$(basename "$src" .cu)
echo "$stem" >> "$FAKE_NVCC_LOG"
exec gcc -shared -fPIC -DSTEM="\\"$stem\\"" -o "$out" "$FAKE_NVCC_STUB"
"""

STUB = 'const char *znicz_stub_name(void) { return STEM; }\n'


class Toolkit:
    """The fake toolkit's build log and a fresh build root a call."""

    def __init__(self, tmp_path, monkeypatch):
        self.tmp = tmp_path
        self.monkeypatch = monkeypatch
        self.log = tmp_path / "nvcc.log"
        self.roots = 0
        self.fresh_checkout()

    def builds(self) -> list[str]:
        return self.log.read_text().split() if self.log.exists() else []

    def fresh_checkout(self) -> None:
        """A new, empty build directory and no library loaded: a
        second process on a fresh checkout."""
        self.roots += 1
        self.monkeypatch.setattr(
            _cuda, "BUILD_ROOT", self.tmp / f"build{self.roots}")
        _cuda._libs.clear()


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    stub = tmp_path / "stub.c"
    stub.write_text(STUB)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(tmp_path / "nvcc.log"))
    monkeypatch.setenv("FAKE_NVCC_STUB", str(stub))
    monkeypatch.setenv("FAKE_NVCC_VERSION", "Cuda compilation tools, 12.4")
    monkeypatch.delenv("ZNICZ_AOT_CACHE", raising=False)
    reset_root()
    aot_cache._caches.clear()
    aot_cache._nvcc_versions.clear()
    yield Toolkit(tmp_path, monkeypatch)
    aot_cache._caches.clear()
    aot_cache._nvcc_versions.clear()
    _cuda._libs.clear()
    reset_root()


def _counter(family: str, **labels) -> float:
    fam = metrics.REGISTRY.get(family)
    if fam is None:
        return 0.0
    want = tuple(str(labels[n]) for n in fam.labelnames)
    return sum(float(child.value) for key, child in fam.items()
               if key == want)


def _outcomes(outcome: str) -> float:
    fam = metrics.REGISTRY.get("znicz_aot_cache_total")
    if fam is None:
        return 0.0
    return sum(float(child.value) for key, child in fam.items()
               if key[0].startswith("kernel:") and key[1] == outcome)


def _library_bytes(paths: dict) -> dict:
    return {stem: path.read_bytes() for stem, path in paths.items()}


def _stub_name(stem: str) -> str:
    fn = _cuda.library(stem).znicz_stub_name
    fn.restype = ctypes.c_char_p
    return fn().decode()


def test_disabled_by_default(toolkit):
    """No environment, no config: no store; every source is built, and
    nothing is written outside the build directory."""
    assert aot_cache.active_cache() is None
    assert aot_cache.status()["enabled"] is False
    paths = _cuda.build_all()
    assert sorted(toolkit.builds()) == sorted(STEMS)
    assert set(paths) == set(STEMS)
    assert not glob.glob(str(toolkit.tmp / "**" / "*.sha256"),
                         recursive=True)
    _cuda.build_all()
    assert len(toolkit.builds()) == len(STEMS), "a warm build rebuilt"


def test_libraries_round_trip_byte_for_byte(toolkit):
    """A fresh checkout over the same store loads every library from it
    (no ``nvcc`` build), each the built library byte for byte, and each
    one loads and answers as its own."""
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    built = _library_bytes(_cuda.build_all())
    assert sorted(toolkit.builds()) == sorted(STEMS)
    cache = aot_cache.active_cache()
    assert len(cache.entries()) == len(STEMS)
    assert all(meta["build_digest"] == _cuda.build_dir().name
               for _, meta in cache.entries())
    hits0 = _outcomes("hit")
    toolkit.fresh_checkout()
    loaded = _library_bytes(_cuda.build_all())
    assert len(toolkit.builds()) == len(STEMS), "a store hit ran nvcc"
    assert loaded == built
    assert _outcomes("hit") == hits0 + len(STEMS)
    assert all(_stub_name(stem) == stem for stem in STEMS)
    st = aot_cache.status()
    assert st["enabled"] and st["hits"] == len(STEMS)
    assert st["entries"] == len(STEMS) and "CUDA graphs" in st["holds"]


def test_a_warm_build_directory_asks_neither_store_nor_nvcc(toolkit):
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    _cuda.build_all()
    lookups = _outcomes("hit") + _outcomes("miss")
    _cuda.build_all()
    assert _outcomes("hit") + _outcomes("miss") == lookups
    assert len(toolkit.builds()) == len(STEMS)


@pytest.mark.parametrize("rot", ["on disk", "aotcache.corrupt"])
def test_a_corrupt_entry_is_quarantined_and_built_once(toolkit, rot):
    """A payload that fails its digest — rotted on disk, or by the drill
    site as it is read — is moved aside (counted, the evidence kept),
    ``nvcc`` builds exactly that library, and the store is refilled."""
    store = toolkit.tmp / "store"
    root.common.engine.aot_cache = str(store)
    built = _library_bytes(_cuda.build_all())
    cache = aot_cache.active_cache()
    victim_key, victim = cache.entries()[0]
    if rot == "on disk":
        blob = bytearray(open(cache._bin(victim_key), "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(cache._bin(victim_key), "wb").write(bytes(blob))
    else:
        root.common.engine.faults = {"aotcache.corrupt": {"at": [1]}}
    corrupt0 = _outcomes("corrupt")
    recov0 = _counter("znicz_recoveries_total", kind="aotcache_fallback")
    toolkit.fresh_checkout()
    paths = _cuda.build_all()
    assert toolkit.builds()[len(STEMS):] == [victim["stem"]]
    assert _outcomes("corrupt") == corrupt0 + 1
    assert _counter("znicz_recoveries_total",
                    kind="aotcache_fallback") == recov0 + 1
    assert glob.glob(str(store / "*.quarantined")), "no evidence kept"
    assert cache.has(victim_key), "the rebuilt library was not stored"
    assert _library_bytes(paths) == built
    assert _stub_name(victim["stem"]) == victim["stem"]


def test_an_entry_ctypes_cannot_load_is_quarantined(toolkit):
    """A payload whose digest checks but that is no shared object: the
    load fails, the entry is quarantined and ``nvcc`` builds it."""
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    _cuda.build_all()
    cache = aot_cache.active_cache()
    key, meta = cache.entries()[-1]
    junk = b"not a shared object"
    cache._atomic_write(cache._bin(key), junk)
    cache._atomic_write(cache._side(key),
                        (cache._digest(junk) + "\n").encode())
    toolkit.fresh_checkout()
    _cuda.build_all()
    assert toolkit.builds()[len(STEMS):] == [meta["stem"]]
    assert cache.corrupt == 1
    assert _stub_name(meta["stem"]) == meta["stem"]


@pytest.mark.parametrize("field", ["device", "nvcc", "torch", "sources"])
def test_a_key_mismatch_is_a_miss(toolkit, monkeypatch, field):
    """The store answers only the exact key: another card, compiler,
    torch or source tree finds nothing and ``nvcc`` builds all."""
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    _cuda.build_all()
    key = aot_cache.library_key(STEMS[0], _cuda.find_nvcc())
    if field == "device":
        monkeypatch.setattr(aot_cache, "device_fingerprint",
                            lambda: ("NVIDIA H100 80GB HBM3", "sm_90"))
    elif field == "nvcc":
        monkeypatch.setenv("FAKE_NVCC_VERSION", "Cuda compilation "
                                                "tools, 12.8")
        aot_cache._nvcc_versions.clear()
    elif field == "torch":
        import torch
        monkeypatch.setattr(torch, "__version__", "0.0.0")
    else:
        monkeypatch.setattr(_cuda, "NVCC_FLAGS",
                            _cuda.NVCC_FLAGS + ("-lineinfo",))
    assert aot_cache.library_key(STEMS[0], _cuda.find_nvcc()) != key
    misses0 = _outcomes("miss")
    toolkit.fresh_checkout()
    _cuda.build_all()
    assert len(toolkit.builds()) == 2 * len(STEMS)
    assert _outcomes("miss") == misses0 + len(STEMS)


def test_the_size_bound_evicts_the_oldest(toolkit):
    """``engine.aot_cache_bytes`` bounds the store: the oldest entries
    leave first and the newest survives its own put."""
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    probe = toolkit.tmp / "probe"
    paths = _cuda.build_all()
    size = max(p.stat().st_size for p in paths.values())
    root.common.engine.aot_cache_bytes = int(size * 2.5)
    aot_cache._caches.clear()  # the bound is read when the store opens
    cache = aot_cache.active_cache()
    keys = []
    for i, (stem, path) in enumerate(paths.items()):
        probe.write_bytes(path.read_bytes())
        keys.append(f"probe{i:02d}")
        cache.put(keys[-1], str(probe), f"kernel:{stem}",
                  meta={"stem": stem})
    assert cache.total_bytes() <= int(size * 2.5)
    assert not cache.has(keys[0]), "the oldest survived"
    assert cache.has(keys[-1]), "the newest was evicted"


def _workflow(name: str):
    data, labels = make_blobs(24, 3, 10)
    prng.seed_all(29)
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": 1})
    wf._max_fires = 10 ** 6
    wf.initialize(device="cpu")
    return wf


def _steps(n: int) -> list:
    wf = _workflow("aot_region")
    for _ in range(n):
        wf.step()
    return [u.weights.detach().numpy().copy() for u in wf.forwards]


def test_a_region_step_after_a_store_hit_is_bit_equal(toolkit):
    """Three training steps after the libraries were built, and three
    more in a fresh checkout that loaded them from the store: the same
    weights to the bit."""
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    _cuda.build_all()
    built = _steps(3)
    toolkit.fresh_checkout()
    _cuda.build_all()
    assert len(toolkit.builds()) == len(STEMS)
    for a, b in zip(built, _steps(3)):
        np.testing.assert_array_equal(a, b)


def _publish_twice(toolkit, store: str):
    from znicz_tpu_torch.resilience.publisher import publish_bundle
    root.common.engine.aot_cache = store
    wf = _workflow("aot_pub")
    pub = str(toolkit.tmp / "handoff")
    publish_bundle(wf, pub, prefix="m")  # the store is empty: no pack
    assert not glob.glob(os.path.join(pub, "*.programs.npz"))
    _cuda.build_all()
    _, v2 = publish_bundle(wf, pub, prefix="m")
    pack = aot_cache._pack_path(v2)
    assert os.path.exists(pack) and os.path.exists(pack + ".sha256")
    return pub, v2, pack


def test_publish_carries_the_libraries(toolkit):
    """``publish_bundle`` packs the store's libraries beside the weights;
    a watcher on a cold host imports them before it surfaces the bundle,
    and that host's first build runs no ``nvcc``."""
    from znicz_tpu_torch.resilience.publisher import PublicationWatcher
    pub, v2, _pack = _publish_twice(toolkit, str(toolkit.tmp / "pub"))
    built = _library_bytes(_cuda.build_all())
    root.common.engine.aot_cache = str(toolkit.tmp / "cold")
    got = PublicationWatcher(pub, prefix="m").poll()
    assert got is not None and got[1] == v2
    assert len(aot_cache.active_cache().entries()) == len(STEMS)
    toolkit.fresh_checkout()
    assert _library_bytes(_cuda.build_all()) == built
    assert len(toolkit.builds()) == len(STEMS), "the cold host ran nvcc"


def test_a_corrupt_pack_is_refused_and_the_weights_survive(toolkit):
    from znicz_tpu_torch.resilience.publisher import PublicationWatcher
    pub, v2, pack = _publish_twice(toolkit, str(toolkit.tmp / "pub"))
    blob = bytearray(open(pack, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(pack, "wb").write(bytes(blob))
    root.common.engine.aot_cache = str(toolkit.tmp / "cold")
    recov0 = _counter("znicz_recoveries_total", kind="aotcache_fallback")
    got = PublicationWatcher(pub, prefix="m").poll()
    assert got is not None and got[1] == v2, "the pack blocked the weights"
    assert not aot_cache.active_cache().entries()
    assert _counter("znicz_recoveries_total",
                    kind="aotcache_fallback") == recov0 + 1
    toolkit.fresh_checkout()
    _cuda.build_all()  # the kernels, built by nvcc
    assert len(toolkit.builds()) == 2 * len(STEMS)


def test_the_environment_turns_it_on_and_config_false_off(toolkit,
                                                          monkeypatch):
    monkeypatch.setenv("ZNICZ_AOT_CACHE", str(toolkit.tmp / "env_store"))
    assert aot_cache.active_cache().directory == str(
        toolkit.tmp / "env_store")
    root.common.engine.aot_cache = False
    assert aot_cache.active_cache() is None
    root.common.engine.aot_cache = True
    root.common.dirs.snapshots = str(toolkit.tmp / "snaps")
    monkeypatch.delenv("ZNICZ_AOT_CACHE")
    assert aot_cache.active_cache().directory == str(
        toolkit.tmp / "snaps" / "aot_cache")


def test_engine_stats_carry_the_store(toolkit):
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.serving import ServingEngine
    wf = _workflow("aot_stats")
    path = str(toolkit.tmp / "m.npz")
    wf.export_forward(path)
    root.common.engine.aot_cache = str(toolkit.tmp / "store")
    with ServingEngine(ExportedModel.load(path, device="cpu",
                                          max_batch=2),
                       max_batch=2) as eng:
        st = eng.stats()["aot_cache"]
    assert st["enabled"] and st["dir"] == str(toolkit.tmp / "store")
