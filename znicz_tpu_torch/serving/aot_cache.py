"""The kernel-library store: cold starts without ``nvcc`` (the port of
``znicz_tpu/serving/aot_cache.py``).

The reference persists the XLA programs a cold process would compile
(its bucket, region and decode programs), so that restart-to-first-
token is bound by I/O instead of the compiler.  On the card the port
compiles one thing at a cold start: ``nvcc`` building its kernel
sources (:func:`znicz_tpu_torch.ops._cuda.build_all`).  Its programs are
CUDA graphs captured at ``start()``, and CUDA cannot serialize an
instantiated graph, so there is nothing of them to persist: the store
holds the built kernel libraries, and :func:`status` says so.
AOTInductor packages would not port it either: they compile another
program, with Inductor's kernels where the port has its own.

Safety model, the reference's — a wrong library never loads:

- entries are **content-addressed**: the key is a sha256 over what
  shapes a library: the build digest (the sources, the shared headers
  and the flags, the digest :func:`~znicz_tpu_torch.ops._cuda.build_dir`
  takes), the library's name, ``nvcc --version``, the device's name and
  compute capability, ``torch.__version__`` and ``torch.version.cuda``.
  Any mismatch is a plain miss, and ``nvcc`` builds the library;
- every payload (the ``.so`` bytes) has a ``.sha256`` sidecar and is
  written atomically; a payload that fails its digest, or that
  ``ctypes.CDLL`` cannot load, is **quarantined** (renamed aside, never
  retried) and the library is built again with ``nvcc``, counted as
  ``znicz_aot_cache_total{outcome="corrupt"}`` and
  ``znicz_recoveries_total{kind="aotcache_fallback"}``.  A miss or a
  quarantine always ends in the hand-written kernel, never in a plain
  version.  The ``aotcache.corrupt`` drill site rots a payload's bytes
  as it is read;
- a size bound (``engine.aot_cache_bytes``) trims the oldest entries.

Enablement, the reference's: ``root.common.engine.aot_cache`` is a
directory, ``True`` (a directory under the snapshots directory) or
``False`` (off, whatever the environment says); when the tree has no
decision, ``ZNICZ_AOT_CACHE`` names the directory.  Unset everywhere,
the store is off and ``build_all`` behaves as it always did.

Publication: :func:`publish_programs` packs the store's libraries of
the current build digest as ``<prefix>_v<version>.programs.npz`` (with
a ``.sha256``) beside a published bundle, and
:class:`~znicz_tpu_torch.resilience.publisher.PublicationWatcher`
imports a verified pack (:func:`import_programs`) before it surfaces
the bundle, so a replica on a fresh host starts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import subprocess
import threading

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["AotCache", "active_cache", "library_key", "build_digest",
           "publish_programs", "import_programs", "status"]

#: default size bound of the store (the oldest entries leave past it)
DEFAULT_MAX_BYTES = 2 << 30

#: what ``status()`` says of the reference's other program families
PROGRAMS = ("kernel libraries only: the bucket, region and decode "
            "programs are CUDA graphs captured at start(), which CUDA "
            "cannot serialize")

_lock = threading.Lock()
_caches: dict[str, "AotCache"] = {}
_nvcc_versions: dict[str, str] = {}


# ----------------------------------------------------------------------
# key material
# ----------------------------------------------------------------------
def build_digest() -> str:
    """The digest of the kernel sources, their shared headers and the
    flags: the name of :func:`~znicz_tpu_torch.ops._cuda.build_dir`."""
    from znicz_tpu_torch.ops import _cuda
    return _cuda.build_dir().name


def nvcc_version(nvcc: str) -> str:
    """``nvcc --version``'s output, once a process per compiler path;
    raises when the compiler cannot say."""
    with _lock:
        known = _nvcc_versions.get(nvcc)
    if known is not None:
        return known
    got = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=120)
    if got.returncode != 0:
        raise RuntimeError(f"{nvcc} --version exited {got.returncode}: "
                           f"{got.stdout}{got.stderr}")
    with _lock:
        _nvcc_versions[nvcc] = got.stdout.strip()
    return got.stdout.strip()


def device_fingerprint() -> tuple[str, str]:
    """The card's name and compute capability (``("none", "none")``
    without one)."""
    import torch
    if not torch.cuda.is_available():
        return "none", "none"
    major, minor = torch.cuda.get_device_capability(0)
    return torch.cuda.get_device_name(0), f"sm_{major}{minor}"


def library_key(stem: str, nvcc: str) -> str:
    """The content address of the library of ``csrc/<stem>.cu``."""
    import torch
    fields = {
        "family": "kernel-library",
        "build": build_digest(),
        "stem": str(stem),
        "nvcc": nvcc_version(nvcc),
        "device": list(device_fingerprint()),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }
    text = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
class AotCache(Logger):
    """Content-addressed library store: ``<key>.bin`` (the ``.so``
    bytes), a ``<key>.sha256`` sidecar and ``<key>.json`` metadata an
    entry, and an advisory ``manifest.json`` rollup.  Thread-safe;
    every write is a temporary file and a rename, so processes sharing
    one directory never see a torn entry."""

    def __init__(self, directory: str,
                 max_bytes: int | None = None) -> None:
        super().__init__()
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_bytes = int(
            root.common.engine.get("aot_cache_bytes", DEFAULT_MAX_BYTES)
            if max_bytes is None else max_bytes)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.puts = 0

    # -- paths ----------------------------------------------------------
    def _bin(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.bin")

    def _side(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.sha256")

    def _meta(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.json")

    @staticmethod
    def _digest(payload: bytes) -> str:
        return hashlib.sha256(payload).hexdigest()

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    # -- observability --------------------------------------------------
    def total_bytes(self) -> int:
        total = 0
        try:
            for name in os.listdir(self.directory):
                if name.endswith(".bin"):
                    total += os.path.getsize(
                        os.path.join(self.directory, name))
        except OSError:
            pass
        return total

    def entries(self) -> list[tuple[str, dict]]:
        """``(key, meta)`` of every complete entry, oldest first."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in sorted(names):
            if not name.endswith(".json") or name == "manifest.json":
                continue
            key = name[:-len(".json")]
            if not os.path.exists(self._bin(key)):
                continue
            try:
                with open(self._meta(key)) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {}
            out.append((key, meta))
        out.sort(key=lambda kv: kv[1].get("seq", 0))
        return out

    def has(self, key: str) -> bool:
        return os.path.exists(self._bin(key)) \
            and os.path.exists(self._side(key))

    def _set_bytes_gauge(self) -> None:
        _metrics.aot_cache_bytes().set(float(self.total_bytes()))

    def _write_manifest(self) -> None:
        rollup = {key: meta for key, meta in self.entries()}
        try:
            self._atomic_write(
                os.path.join(self.directory, "manifest.json"),
                json.dumps(rollup, indent=1, sort_keys=True).encode())
        except OSError:
            pass  # advisory: each entry describes itself

    # -- the hot paths --------------------------------------------------
    def load(self, key: str, site: str, dest: str) -> bool:
        """Place the library stored under ``key`` at ``dest`` and load
        it: True on a hit.  False on a miss, or after quarantining an
        entry that fails its digest or that ``ctypes.CDLL`` cannot load;
        either way the caller builds the library."""
        from znicz_tpu_torch.resilience import faults as _faults
        try:
            with open(self._bin(key), "rb") as f:
                payload = f.read()
            with open(self._side(key)) as f:
                want = f.read().strip()
        except OSError:
            _metrics.aot_cache_events(site, "miss").inc()
            with self._lock:
                self.misses += 1
            return False
        if _faults.fire("aotcache.corrupt", at_site=site) is not None:
            # the bytes rot after their sidecar was written: what the
            # digest check must catch
            mid = len(payload) // 2
            payload = payload[:mid] + b"\xde\xad\xbe\xef" \
                + payload[mid + 4:]
        if self._digest(payload) != want:
            self._quarantine(key, site, "sha256 mismatch")
            return False
        tmp = f"{dest}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        try:
            ctypes.CDLL(tmp)
        except OSError as exc:
            os.remove(tmp)
            self._quarantine(key, site, f"ctypes cannot load it: {exc}")
            return False
        os.replace(tmp, dest)
        _metrics.aot_cache_events(site, "hit").inc()
        with self._lock:
            self.hits += 1
        return True

    def _quarantine(self, key: str, site: str, reason: str) -> None:
        """Move a bad entry aside (never retried, the evidence kept)."""
        self.warning("kernel store entry %s… quarantined (%s): nvcc "
                     "builds the library", key[:12], reason)
        for path in (self._bin(key), self._side(key), self._meta(key)):
            try:
                os.replace(path, f"{path}.quarantined")
            except OSError:
                pass
        _metrics.aot_cache_events(site, "corrupt").inc()
        _metrics.recoveries("aotcache_fallback").inc()
        from znicz_tpu_torch.observe import recorder as _recorder
        _recorder.record("aotcache_quarantine", key=key[:12],
                         site=site, reason=reason)
        with self._lock:
            self.corrupt += 1
        self._set_bytes_gauge()

    def put(self, key: str, library: str, site: str,
            meta: dict | None = None) -> bool:
        """Store the library file ``library`` under ``key``.  A write
        that fails leaves the store as it was (the library is built;
        nothing is lost)."""
        try:
            with open(library, "rb") as f:
                payload = f.read()
        except OSError as exc:
            self.warning("kernel store: cannot read %s: %s", library, exc)
            return False
        entry = dict(meta or {})
        entry.update({"site": site, "bytes": len(payload),
                      "sha256": self._digest(payload)})
        try:
            with self._lock:
                entry["seq"] = self.puts = self.puts + 1
            self._atomic_write(self._bin(key), payload)
            self._atomic_write(self._side(key),
                               (entry["sha256"] + "\n").encode())
            self._atomic_write(self._meta(key),
                               json.dumps(entry, sort_keys=True).encode())
        except OSError as exc:
            self.warning("kernel store write failed for %s: %s", site,
                         exc)
            return False
        self._trim()
        self._write_manifest()
        self._set_bytes_gauge()
        return True

    def _trim(self) -> None:
        """The size bound: the oldest entries leave until the payloads
        fit ``max_bytes``."""
        if self.max_bytes <= 0:
            return
        total = self.total_bytes()
        for key, _meta in self.entries():
            if total <= self.max_bytes:
                break
            try:
                size = os.path.getsize(self._bin(key))
            except OSError:
                continue
            for path in (self._bin(key), self._side(key),
                         self._meta(key)):
                try:
                    os.remove(path)
                except OSError:
                    pass
            total -= size
            self.debug("kernel store: evicted %s… (%d bytes, bound %d)",
                       key[:12], size, self.max_bytes)

    # -- publication packs ----------------------------------------------
    def matching_entries(self, digest: str) -> list[tuple[str, dict]]:
        """Entries built from the sources of build digest ``digest``."""
        return [(key, meta) for key, meta in self.entries()
                if meta.get("build_digest") == digest]

    def export_pack(self, path: str, digest: str) -> int:
        """Every entry of build digest ``digest`` packed into an
        ``.npz`` at ``path`` beside a ``.sha256`` sidecar; returns the
        entries packed (0: nothing written)."""
        arrays, meta = {}, {}
        for key, entry in self.matching_entries(digest):
            try:
                with open(self._bin(key), "rb") as f:
                    arrays[f"e_{key}"] = np.frombuffer(f.read(),
                                                       dtype=np.uint8)
            except OSError:
                continue
            meta[key] = entry
        if not meta:
            return 0
        arrays["pack_meta"] = np.frombuffer(
            json.dumps({"build_digest": digest, "entries": meta},
                       sort_keys=True).encode(), dtype=np.uint8)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        self._atomic_write(path, buf.getvalue())
        from znicz_tpu_torch.utils.snapshotter import _sha256_file
        self._atomic_write(f"{path}.sha256",
                           (_sha256_file(path) + "\n").encode())
        return len(meta)

    def import_pack(self, path: str) -> int:
        """Unpack a verified pack into this store, each entry's digest
        checked again and keys already here kept.  Returns the entries
        imported; raises on a pack whose entry fails its digest."""
        with np.load(path) as pack:
            meta = json.loads(bytes(pack["pack_meta"]).decode())
            staged = []
            for key, entry in meta["entries"].items():
                if self.has(key):
                    continue
                payload = bytes(pack[f"e_{key}"])
                if self._digest(payload) != entry.get("sha256"):
                    raise ValueError(f"programs pack {path}: entry "
                                     f"{key[:12]}… fails its sha256")
                staged.append((key, entry, payload))
        for key, entry, payload in staged:
            with self._lock:
                entry["seq"] = self.puts = self.puts + 1
            self._atomic_write(self._bin(key), payload)
            self._atomic_write(self._side(key),
                               (entry["sha256"] + "\n").encode())
            self._atomic_write(self._meta(key),
                               json.dumps(entry, sort_keys=True).encode())
        if staged:
            self._trim()
            self._write_manifest()
            self._set_bytes_gauge()
        return len(staged)


# ----------------------------------------------------------------------
# enablement
# ----------------------------------------------------------------------
def active_cache() -> AotCache | None:
    """The process's store, resolved on every call: the config tree
    decides, ``ZNICZ_AOT_CACHE`` when the tree has no decision, and
    config ``False`` beats both.  One instance a directory, so the
    tallies survive.  None: off."""
    cfg = root.common.engine.get("aot_cache", None)
    if cfg is False:
        return None
    path = None
    if isinstance(cfg, str):
        path = cfg
    elif cfg is True:
        path = os.environ.get("ZNICZ_AOT_CACHE") or os.path.join(
            str(root.common.dirs.snapshots), "aot_cache")
    elif cfg is None:
        path = os.environ.get("ZNICZ_AOT_CACHE") or None
    if not path:
        return None
    path = os.path.abspath(path)
    with _lock:
        cache = _caches.get(path)
        if cache is None:
            cache = _caches[path] = AotCache(path)
        return cache


def status() -> dict:
    """The ``stats()`` and status page's block: on or off, what the
    store holds and this process's verdicts."""
    cache = active_cache()
    if cache is None:
        return {"enabled": False, "holds": PROGRAMS}
    return {
        "enabled": True,
        "holds": PROGRAMS,
        "dir": cache.directory,
        "entries": len(cache.entries()),
        "bytes": cache.total_bytes(),
        "hits": cache.hits,
        "misses": cache.misses,
        "corrupt": cache.corrupt,
    }


# ----------------------------------------------------------------------
# publication
# ----------------------------------------------------------------------
def _pack_path(bundle_path: str) -> str:
    base = bundle_path[:-len(".npz")] \
        if bundle_path.endswith(".npz") else bundle_path
    return f"{base}.programs.npz"


def publish_programs(directory: str, prefix: str, version: int,
                     bundle_path: str) -> int:
    """Pack the store's libraries of the current build digest as
    ``<prefix>_v<version>.programs.npz`` beside ``bundle_path``; when
    the store holds none, the previous version's pack is carried
    forward if its build digest matches.  Returns the entries packed
    (0: no pack).  A publish never fails for want of a pack."""
    cache = active_cache()
    if cache is None:
        return 0
    try:
        digest = build_digest()
        pack = _pack_path(bundle_path)
        n = cache.export_pack(pack, digest)
        if n:
            return n
        prev = os.path.join(
            directory, f"{prefix}_v{version - 1:06d}.programs.npz")
        if version > 1 and os.path.exists(prev):
            with np.load(prev) as old:
                meta = json.loads(bytes(old["pack_meta"]).decode())
            if meta.get("build_digest") == digest:
                with open(prev, "rb") as f:
                    AotCache._atomic_write(pack, f.read())
                with open(f"{prev}.sha256") as f:
                    AotCache._atomic_write(f"{pack}.sha256",
                                           f.read().encode())
                return len(meta.get("entries", {}))
    except Exception as exc:  # noqa: BLE001 — packing is best-effort
        cache.warning("programs pack for v%d not published: %s",
                      version, exc)
    return 0


def import_programs(bundle_path: str) -> int:
    """Import the pack published beside ``bundle_path`` into the store,
    its digest checked.  A corrupt pack is refused (counted) and the
    weights still serve.  Returns the entries imported."""
    cache = active_cache()
    pack = _pack_path(bundle_path)
    if cache is None or not os.path.exists(pack):
        return 0
    try:
        from znicz_tpu_torch.utils.snapshotter import (SnapshotCorrupt,
                                                       _sha256_file)
        sidecar = f"{pack}.sha256"
        if not os.path.exists(sidecar):
            raise SnapshotCorrupt(f"{pack}: no sha256 sidecar")
        with open(sidecar) as f:
            want = f.read().strip()
        got = _sha256_file(pack)
        if got != want:
            raise SnapshotCorrupt(
                f"{pack}: sha256 {got[:12]}… != sidecar {want[:12]}…")
        return cache.import_pack(pack)
    except Exception as exc:  # noqa: BLE001 — a corrupt pack
        cache.warning("programs pack rejected (%s): nvcc builds what the "
                      "store lacks", exc)
        _metrics.snapshot_failures("programs").inc()
        _metrics.aot_cache_events("publish", "corrupt").inc()
        _metrics.recoveries("aotcache_fallback").inc()
        return 0
