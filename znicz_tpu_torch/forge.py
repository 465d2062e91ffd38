"""Forge: model-zoo packaging, publishing and fetching (port of
``znicz_tpu/forge.py``).

A **forge bundle** is one ``.forge.tar.gz`` holding:

- ``manifest.json``: name, version, author, description and the
  training metrics;
- ``model.npz``: the servable forward chain (the bundle of
  :func:`~znicz_tpu_torch.export.export_forward`; serve it with
  :class:`~znicz_tpu_torch.export.ExportedModel`);
- ``report.json``: the post-training report
  (:func:`~znicz_tpu_torch.publishing.gather_report`).

The format is the reference's (``"znicz-tpu-forge"``), so bundles cross
between the packages unchanged: the weights travel as the bundle itself.

:class:`ForgeRegistry` is the store (a directory, versioned);
:class:`ForgeServer` and :class:`ForgeClient` wrap it over HTTP
(the standard library's ``http.server`` and ``urllib``), so one host
publishes models to the rest of a site.

Integrity: every upload writes a ``.sha256`` sidecar (the
:mod:`znicz_tpu_torch.resilience.publisher` convention) and every
:meth:`ForgeRegistry.fetch` checks it before the bundle reaches a
loader.  A corrupt bundle is moved to the ``quarantine/`` subdirectory
(counted on ``znicz_snapshot_failures_total{op=forge}``) and, when no
version was asked for, the fetch falls back to the newest older good
version (``znicz_recoveries_total{kind=forge_fallback}``).  A bundle
without a sidecar gets one on its first checked read
(trust-on-first-fetch, then pinned).  The ``fleet.model_corrupt``
drill site injects exactly this failure."""

from __future__ import annotations

import json
import os
import re
import shutil
import tarfile
import tempfile
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from znicz_tpu_torch.utils.logger import Logger

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")


def _check_name(name: str, what: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid {what} '{name}' (letters, digits, "
                         f"'._-' only)")
    return name


def package(workflow, path: str, name: str | None = None,
            version: str = "1.0.0", author: str = "",
            description: str = "") -> str:
    """Package a trained workflow into a forge bundle at ``path``."""
    from znicz_tpu_torch.export import export_forward
    from znicz_tpu_torch.publishing import gather_report
    name = _check_name(name or workflow.name, "model name")
    _check_name(version, "version")
    report = gather_report(workflow)
    manifest = {
        "format": "znicz-tpu-forge",
        "name": name,
        "version": version,
        "author": author,
        "description": description,
        "workflow": workflow.name,
        "metrics": report.get("metrics", {}),
    }
    with tempfile.TemporaryDirectory() as tmp:
        model_path = os.path.join(tmp, "model.npz")
        export_forward(workflow, model_path)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(tmp, "report.json"), "w") as f:
            json.dump(report, f, indent=2, default=str)
        tmp_tar = f"{path}.{os.getpid()}.tmp"
        with tarfile.open(tmp_tar, "w:gz") as tar:
            for fname in ("manifest.json", "model.npz", "report.json"):
                tar.add(os.path.join(tmp, fname), arcname=fname)
        os.replace(tmp_tar, path)
    return path


def _tar_member(tar: tarfile.TarFile, name: str, bundle_path: str):
    try:  # extractfile raises KeyError for a missing member
        member = tar.extractfile(name)
    except KeyError:
        member = None
    if member is None:
        raise ValueError(f"{bundle_path}: no {name} "
                         f"(not a forge bundle)")
    return member


def read_manifest(bundle_path: str) -> dict:
    with tarfile.open(bundle_path, "r:gz") as tar:
        manifest = json.load(
            _tar_member(tar, "manifest.json", bundle_path))
    if manifest.get("format") != "znicz-tpu-forge":
        raise ValueError(f"{bundle_path}: not a forge bundle")
    return manifest


def extract_model(bundle_path: str, directory: str) -> str:
    """Extract the servable ``model.npz``; returns its path (load with
    :class:`znicz_tpu_torch.export.ExportedModel`)."""
    os.makedirs(directory, exist_ok=True)
    with tarfile.open(bundle_path, "r:gz") as tar:
        member = _tar_member(tar, "model.npz", bundle_path)
        out = os.path.join(directory, "model.npz")
        with open(out, "wb") as f:
            shutil.copyfileobj(member, f)
    return out


class ForgeRegistry(Logger):
    """A versioned bundle store: ``<dir>/<name>/<version>.forge.tar.gz``."""

    def __init__(self, directory: str) -> None:
        super().__init__()
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _bundle_path(self, name: str, version: str) -> str:
        return os.path.join(self.directory, _check_name(name, "name"),
                            f"{_check_name(version, 'version')}"
                            f".forge.tar.gz")

    def upload(self, bundle_path: str) -> dict:
        from znicz_tpu_torch.utils.snapshotter import _sha256_file
        manifest = read_manifest(bundle_path)
        dest = self._bundle_path(manifest["name"], manifest["version"])
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # atomic + exclusive publish: copy to tmp, then hard-link into
        # place — link fails if dest exists, closing the concurrent-
        # upload race that a check-then-replace would leave open
        tmp = f"{dest}.{os.getpid()}.tmp"
        shutil.copyfile(bundle_path, tmp)
        digest = _sha256_file(tmp)
        try:
            os.link(tmp, dest)
        except FileExistsError:
            raise FileExistsError(
                f"{manifest['name']} {manifest['version']} already "
                f"published (versions are immutable)") from None
        finally:
            os.unlink(tmp)
        # digest sidecar AFTER the bundle lands (publisher.py write
        # order): a concurrent fetch sees either a complete pair or a
        # sidecar-less file it will TOFU-verify
        side_tmp = f"{dest}.sha256.{os.getpid()}.tmp"
        with open(side_tmp, "w") as f:
            f.write(digest + "\n")
        os.replace(side_tmp, f"{dest}.sha256")
        self.info("published %s %s (sha256 %s…)", manifest["name"],
                  manifest["version"], digest[:12])
        return manifest

    def list(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {}
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if not os.path.isdir(full):
                continue
            versions = sorted(
                f[:-len(".forge.tar.gz")] for f in os.listdir(full)
                if f.endswith(".forge.tar.gz"))
            if versions:
                out[name] = versions
        return out

    def latest_version(self, name: str) -> str:
        versions = self.list().get(name)
        if not versions:
            raise KeyError(f"no published model '{name}'")
        # semver-flavored ordering: 1.10.0 > 1.9.0 (numeric-aware),
        # 2.0.0 > 2.0.0-rc1 (a release outranks its pre-release tags),
        # 2.0.1 > 2.0.0.  Segment ranks: string(0) < absent(1) <
        # numeric(2); versions are padded to equal length with the
        # 'absent' sentinel.
        split = {v: re.split(r"[._-]", v) for v in versions}
        width = max(len(parts) for parts in split.values())

        def key(v: str):
            parts = [(2, int(p), "") if p.isdigit() else (0, 0, p)
                     for p in split[v]]
            return parts + [(1, 0, "")] * (width - len(parts))
        return sorted(versions, key=key)[-1]

    def _verify(self, name: str, version: str, path: str) -> None:
        """Digest-check one bundle; raises ``SnapshotCorrupt`` on a
        mismatch (or when the ``fleet.model_corrupt`` chaos site says
        so).  A sidecar-less legacy bundle is hashed and pinned on
        first read (trust-on-first-fetch)."""
        from znicz_tpu_torch.resilience import faults as _faults
        from znicz_tpu_torch.utils.snapshotter import (SnapshotCorrupt,
                                                       _sha256_file)
        if _faults.fire("fleet.model_corrupt", name=name,
                        version=version) is not None:
            raise SnapshotCorrupt(
                f"{path}: injected digest corruption "
                f"(fleet.model_corrupt)")
        sidecar = f"{path}.sha256"
        got = _sha256_file(path)
        if not os.path.exists(sidecar):
            side_tmp = f"{sidecar}.{os.getpid()}.tmp"
            with open(side_tmp, "w") as f:
                f.write(got + "\n")
            os.replace(side_tmp, sidecar)
            self.info("pinned legacy bundle %s %s on first fetch "
                      "(sha256 %s…)", name, version, got[:12])
            return
        with open(sidecar) as f:
            want = f.read().strip()
        if got != want:
            raise SnapshotCorrupt(
                f"{path}: sha256 {got[:12]}… != sidecar {want[:12]}…")

    def _quarantine(self, name: str, path: str) -> str:
        """Move a corrupt bundle (+ sidecar) out of the serving set so
        no later fetch or latest_version can ever surface it again."""
        qdir = os.path.join(self.directory, name, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        os.replace(path, dest)
        sidecar = f"{path}.sha256"
        if os.path.exists(sidecar):
            os.replace(sidecar, f"{dest}.sha256")
        from znicz_tpu_torch.observe import recorder as _recorder
        _recorder.record("bundle_quarantine", model=name,
                         bundle=os.path.basename(path))
        return dest

    def fetch(self, name: str, version: str | None = None) -> str:
        """The digest-VERIFIED bundle path for ``name`` (newest
        version when ``version`` is None).  A bundle failing
        verification is quarantined; with no explicit version the
        fetch falls back to the newest older good version, raising
        ``SnapshotCorrupt`` only when nothing verifies."""
        from znicz_tpu_torch.observe import metrics as _metrics
        from znicz_tpu_torch.utils.snapshotter import SnapshotCorrupt
        explicit = version is not None
        fell_back = False
        last_exc: Exception | None = None
        while True:
            version = version if explicit else self.latest_version(name)
            path = self._bundle_path(name, version)
            if not os.path.exists(path):
                raise KeyError(f"no bundle {name} {version}")
            try:
                self._verify(name, version, path)
            except SnapshotCorrupt as exc:
                _metrics.snapshot_failures("forge").inc()
                quarantined = self._quarantine(name, path)
                self.warning("quarantined %s %s → %s: %s", name,
                             version, quarantined, exc)
                last_exc = exc
                if explicit:
                    raise
                if not self.list().get(name):
                    raise SnapshotCorrupt(
                        f"no version of '{name}' verifies "
                        f"(last: {last_exc})") from exc
                fell_back = True
                version = None
                continue
            if fell_back:
                _metrics.recoveries("forge_fallback").inc()
                self.info("fetch fell back to %s %s after "
                          "quarantining newer corrupt version(s)",
                          name, version)
            return path

    def manifest(self, name: str, version: str | None = None) -> dict:
        return read_manifest(self.fetch(name, version))


class ForgeServer(Logger):
    """HTTP front for a registry: ``GET /list``, ``GET
    /fetch?name=&version=``, ``POST /upload`` (bundle body)."""

    def __init__(self, registry: ForgeRegistry, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        super().__init__()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                server.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/list":
                    self._send(200, json.dumps(
                        registry.list()).encode())
                    return
                if parsed.path == "/fetch":
                    from znicz_tpu_torch.utils.snapshotter import \
                        SnapshotCorrupt
                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        path = registry.fetch(
                            q["name"][0],
                            q.get("version", [None])[0])
                    except SnapshotCorrupt as exc:
                        # never stream corrupt bytes to a client: the
                        # bundle was quarantined, nothing verifies
                        self._send(410, json.dumps(
                            {"error": str(exc)}).encode())
                        return
                    except (KeyError, ValueError) as exc:
                        self._send(404, json.dumps(
                            {"error": str(exc)}).encode())
                        return
                    # stream: bundles carry full weight dumps
                    size = os.path.getsize(path)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/gzip")
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    with open(path, "rb") as f:
                        shutil.copyfileobj(f, self.wfile)
                    return
                self._send(404, b'{"error": "unknown path"}')

            def do_POST(self):
                if self.path != "/upload":
                    self._send(404, b'{"error": "unknown path"}')
                    return
                length = int(self.headers.get("Content-Length", 0))
                tmp = tempfile.NamedTemporaryFile(
                    suffix=".forge.tar.gz", delete=False)
                try:
                    # chunked spool to disk, not a whole-blob buffer
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        tmp.write(chunk)
                        remaining -= len(chunk)
                    tmp.close()
                    manifest = registry.upload(tmp.name)
                    self._send(200, json.dumps(manifest).encode())
                except (ValueError, FileExistsError,
                        tarfile.TarError) as exc:
                    self._send(400, json.dumps(
                        {"error": str(exc)}).encode())
                finally:
                    os.unlink(tmp.name)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="forge", daemon=True)
        self._thread.start()
        self.info("forge @ http://%s:%d/", self.host, self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


class ForgeClient(Logger):
    """Talk to a remote :class:`ForgeServer`."""

    def __init__(self, base_url: str, timeout: float = 30.0) -> None:
        super().__init__()
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def list(self) -> dict[str, list[str]]:
        with urllib.request.urlopen(f"{self.base_url}/list",
                                    timeout=self.timeout) as resp:
            return json.load(resp)

    def fetch(self, name: str, directory: str,
              version: str | None = None) -> str:
        query = {"name": name}
        if version:
            query["version"] = version
        url = (f"{self.base_url}/fetch?"
               f"{urllib.parse.urlencode(query)}")
        os.makedirs(directory, exist_ok=True)
        dest = os.path.join(
            directory, f"{name}-{version or 'latest'}.forge.tar.gz")
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            with open(dest, "wb") as f:
                shutil.copyfileobj(resp, f)
        return dest

    def upload(self, bundle_path: str) -> dict:
        size = os.path.getsize(bundle_path)
        with open(bundle_path, "rb") as f:  # streamed request body
            req = urllib.request.Request(
                f"{self.base_url}/upload", data=f,
                headers={"Content-Type": "application/gzip",
                         "Content-Length": str(size)})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout) as resp:
                    return json.load(resp)
            except urllib.error.HTTPError as exc:
                detail = exc.read().decode(errors="replace")
                raise RuntimeError(
                    f"upload rejected ({exc.code}): {detail}") from exc
