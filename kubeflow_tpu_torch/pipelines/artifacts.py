"""Content-addressed artifact store — a copy of the store half of
``kubeflow_tpu/pipelines/artifacts.py`` (the port imports nothing of the
JAX package). Artifacts are content-addressed (sha256) on the local
filesystem, so equal content has an equal uri and a blob's address is its
checksum.

The layout on disk is the JAX store's, byte for byte, so either package
reads a root the other wrote:

- ``<root>/<2 hex>/<62 hex>`` — one blob per sha256 digest (``cas://``);
- ``<root>/named/<name>/<version>`` — a registered version, holding the
  ``cas://`` uri it is bound to (versions are immutable);
- tree manifests — a blob ``b"T" + json({"kftpu_tree": {relpath:
  digest}})`` (sorted keys) over per-file blobs, materialized under
  ``<root>/trees/<digest>`` with a ``.complete`` commit marker.

Values are stored as a 1-byte codec tag + payload: JSON for plain data,
pickle for other Python objects, and "T" for directory-tree manifests.

``artifact://`` is the platform's cross-subsystem storage scheme:

- ``artifact://<sha256-digest>``      content address (any artifact)
- ``artifact://<name>@<version>``     named register entry
- ``artifact://<name>``               newest registered version

``serve/storage.py`` resolves it against the store rooted at
``$KFTPU_ARTIFACT_ROOT`` (or an explicit root), and the remote KV tier
(``serve/kvtier.py``) keeps its spilled pages in a store of the same type
under ``$KFTPU_KV_REMOTE_ROOT``. The lineage helpers of the JAX module
(``publish_model``/``publish_file`` and their pipeline-task records) need
the pipelines executor and metadata store, which the port does not have.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import tempfile
from typing import Any, Optional

SCHEME = "cas://"
ARTIFACT_SCHEME = "artifact://"
ROOT_ENV = "KFTPU_ARTIFACT_ROOT"

_HEX_DIGEST = re.compile(r"^[0-9a-f]{64}$")
_NAME_OK = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")
_TREE_KEY = "kftpu_tree"       # manifest sentinel (see _manifest_of)
_MARKER = ".complete"          # materialization commit marker


def _version_key(v: str):
    """Dotted-numeric versions sort numerically, others lexically after."""
    try:
        return (0, tuple(int(p) for p in v.split(".")), "")
    except ValueError:
        return (1, (), v)


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest[2:])

    def put_bytes(self, data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        path = self._path(digest)
        if not os.path.exists(path):
            # Atomic publish: same-content races converge on the same digest.
            # The retry covers GC's empty-dir rmdir landing between makedirs
            # and mkstemp (the dir vanishes; recreate and go again). Loop
            # until the dir holds still: repeated GC cycles can re-race the
            # window any number of times, and each retry is two
            # cheap syscalls — losing a write to win a cleanup race is the
            # wrong trade at any retry count.
            while True:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                try:
                    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
                    break
                except FileNotFoundError:
                    continue
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        else:
            # Dedup hit: refresh mtime so the GC grace window protects this
            # blob through the caller's write→register window even when the
            # bytes were first stored long ago (a dangling old blob re-used
            # by a new tree must read as young to a concurrent sweep).
            try:
                os.utime(path)
            except OSError:
                pass   # concurrent sweep took it; caller's exists checks rule
        return SCHEME + digest

    def get_bytes(self, uri: str) -> bytes:
        with open(self.path_for(uri), "rb") as f:
            return f.read()

    def path_for(self, uri: str) -> str:
        if not uri.startswith(SCHEME):
            raise ValueError(f"not a cas uri: {uri!r}")
        return self._path(uri[len(SCHEME):])

    def exists(self, uri: str) -> bool:
        try:
            return os.path.exists(self.path_for(uri))
        except ValueError:
            return False

    # -- typed values ----------------------------------------------------------

    def put_value(self, value: Any) -> str:
        try:
            payload = b"J" + json.dumps(value, sort_keys=True).encode()
        except (TypeError, ValueError):
            payload = b"P" + pickle.dumps(value)
        return self.put_bytes(payload)

    def get_value(self, uri: str) -> Any:
        data = self.get_bytes(uri)
        if data[:1] == b"J":
            return json.loads(data[1:])
        if data[:1] == b"P":
            return pickle.loads(data[1:])
        if data[:1] == b"T":
            return json.loads(data[1:])[_TREE_KEY]   # {relpath: digest}
        raise ValueError(f"unknown artifact codec {data[:1]!r}")

    # -- directory trees (orbax checkpoints, staged bundles) -------------------

    def put_tree(self, src_dir: str) -> str:
        """Store a directory as per-file blobs + a "T"-codec manifest.

        Files are content-addressed individually, so checkpoints that share
        shards (e.g. consecutive orbax steps with unchanged leaves) store
        the changed bytes only. Whole-file reads are fine at this store's
        scale (local disk, no egress); a streaming hasher is the upgrade
        path if blobs outgrow memory."""
        files: dict[str, str] = {}
        src_dir = os.path.abspath(src_dir)
        if not os.path.isdir(src_dir):
            raise NotADirectoryError(f"put_tree: {src_dir} is not a directory")
        for dirpath, dirnames, filenames in os.walk(src_dir):
            dirnames.sort()
            for fn in sorted(filenames):
                if dirpath == src_dir and fn == _MARKER:
                    # Re-publishing a materialized tree must not capture the
                    # store's own commit marker (it would sort first in the
                    # manifest and masquerade as a committed layout).
                    continue
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, src_dir)
                with open(p, "rb") as f:
                    files[rel] = self.put_bytes(f.read())[len(SCHEME):]
        payload = b"T" + json.dumps({_TREE_KEY: files},
                                    sort_keys=True).encode()
        return self.put_bytes(payload)

    def _manifest_of(self, uri: str) -> Optional[dict[str, str]]:
        """The tree manifest, or None for non-tree artifacts. Raw blobs are
        untagged, so tree-ness requires the full contract — "T{" prefix AND
        a JSON object holding exactly the sentinel key. A text file that
        merely starts with "T" fails the two-byte check without reading the
        body (a multi-GB corpus must not be slurped just to say "not a
        tree"); a file that IS byte-equal to a manifest has the manifest's
        digest and behaves identically by CAS construction."""
        with open(self.path_for(uri), "rb") as f:
            head = f.read(2)
            if head != b"T{":
                return None
            data = head[1:] + f.read()
        try:
            doc = json.loads(data)
        except ValueError:
            return None
        if isinstance(doc, dict) and set(doc) == {_TREE_KEY} \
                and isinstance(doc[_TREE_KEY], dict):
            return doc[_TREE_KEY]
        return None

    def is_tree(self, uri: str) -> bool:
        return self._manifest_of(uri) is not None

    def materialize_tree(self, uri: str, dest: Optional[str] = None) -> str:
        """Lay a tree artifact out as a real directory and return its path.

        Default dest is ``<root>/trees/<digest>`` — content-addressed, so
        materialization is idempotent and shared across consumers (a served
        model and a warm restart hit the same dir). Files hardlink to the
        CAS blobs (copy-via-tmp fallback for filesystems that refuse
        links, so a killed copy never lands at the final name); the marker
        file commits the layout, so a killed materialization re-runs
        instead of serving a half-written checkpoint."""
        files = self._manifest_of(uri)
        if files is None:
            raise ValueError(
                f"{uri} is not a tree artifact; model storageUris need a "
                "publish_model/put_tree artifact")
        if dest is None:
            dest = os.path.join(self.root, "trees", uri[len(SCHEME):])
        marker = os.path.join(dest, _MARKER)
        if os.path.exists(marker):
            return dest
        os.makedirs(dest, exist_ok=True)
        for rel, digest in files.items():
            blob = self._path(digest)
            out = os.path.join(dest, rel)
            if os.path.exists(out):
                continue   # link/replace are atomic: existing = complete
            os.makedirs(os.path.dirname(out), exist_ok=True)
            try:
                os.link(blob, out)
            except OSError:
                import shutil

                # tmp lives OUTSIDE dest: a killed copy must not leave a
                # stray inside a directory the marker later commits as a
                # complete checkpoint.
                staging = os.path.join(self.root, ".tmp")
                os.makedirs(staging, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=staging)
                os.close(fd)
                shutil.copyfile(blob, tmp)
                os.replace(tmp, out)
        with open(marker, "w") as f:
            f.write(uri)
        return dest

    # -- named register (name@version → digest) --------------------------------

    def register(self, name: str, version: str, uri: str) -> str:
        """Bind ``name@version`` to a stored artifact; returns the
        ``artifact://name@version`` uri. Versions are immutable — rebinding
        to different content raises (same content is a no-op), matching the
        registry contract serving relies on for rollback-by-version."""
        if not _NAME_OK.match(name) or _HEX_DIGEST.match(name):
            raise ValueError(f"bad artifact name {name!r}")
        if name == "gc":
            # Reserved: `kftpu artifacts gc` is the GC verb (git-style);
            # an artifact named "gc" would be CLI-unreachable and one typo
            # away from a destructive sweep.
            raise ValueError("'gc' is a reserved artifact name")
        if not _NAME_OK.match(version):
            raise ValueError(f"bad artifact version {version!r}")
        # Refresh the blob's mtime BEFORE the exists check: registering a
        # pre-existing, currently-dangling digest races a concurrent GC in
        # another process (the in-process GC lock can't see it) — between
        # its mark and sweep this blob is garbage, and only the grace
        # window protects it. The utime puts it back inside that window;
        # doing it first means a sweep can beat the utime (register then
        # fails loudly below) but can never beat a register that already
        # returned.
        try:
            os.utime(self.path_for(self.resolve(uri)))
        except (OSError, ValueError, FileNotFoundError):
            pass    # missing/invalid: the exists check below rules
        if not self.exists(uri):
            raise FileNotFoundError(f"register {name}@{version}: {uri} "
                                    "is not in the store")
        entry = os.path.join(self.root, "named", name, version)
        os.makedirs(os.path.dirname(entry), exist_ok=True)
        # Write-then-link keeps first-writer-wins atomic across processes
        # AND crash-safe: the entry appears fully written or not at all (an
        # O_EXCL-create-then-write window would let a crash bind the
        # version to an empty string forever, unrepairable under the
        # immutability rule). A concurrent same-version register with
        # different content must LOSE loudly, not silently flip what a
        # deployed storageUri resolves to.
        # Dot-prefixed temp: a crash must not leave a file versions() would
        # list as a phantom "latest".
        fd, tmp = tempfile.mkstemp(prefix=".reg-", dir=os.path.dirname(entry))
        try:
            with os.fdopen(fd, "w") as f:
                f.write(uri)
            try:
                os.link(tmp, entry)
            except FileExistsError:
                with open(entry) as f:
                    existing = f.read().strip()
                if existing != uri:
                    raise ValueError(
                        f"{name}@{version} is already bound to {existing}; "
                        "versions are immutable, register a new one") from None
            except OSError:
                # Filesystems that refuse hardlinks (materialize_tree's
                # copy-fallback case). The immutability check must still
                # run — EPERM can fire before the EEXIST the link path
                # relies on, and blindly replacing would silently rebind a
                # deployed version. Window left: a crash between this read
                # and the replace of a brand-new entry (atomic-but-
                # last-writer rather than first-writer — degraded mode).
                if os.path.exists(entry):
                    with open(entry) as f:
                        existing = f.read().strip()
                    if existing != uri:
                        raise ValueError(
                            f"{name}@{version} is already bound to "
                            f"{existing}; versions are immutable, register "
                            "a new one") from None
                else:
                    os.replace(tmp, entry)
                    tmp = None
        finally:
            if tmp is not None:
                os.unlink(tmp)
        return f"{ARTIFACT_SCHEME}{name}@{version}"

    def versions(self, name: str) -> list[str]:
        """Registered versions of ``name``, ascending by version ORDER:
        dotted-numeric versions compare numerically ("10" after "9",
        "1.10" after "1.9"), non-numeric ones lexicographically after all
        numeric ones — deterministic regardless of filesystem timestamp
        granularity (mtime ordering silently served the OLDER model when
        two registrations landed in one mtime quantum)."""
        if not _NAME_OK.match(name):
            raise ValueError(f"bad artifact name {name!r}")
        d = os.path.join(self.root, "named", name)
        try:
            entries = [v for v in os.listdir(d)
                       if not v.startswith(".")
                       and os.path.isfile(os.path.join(d, v))]
        except FileNotFoundError:
            return []
        return sorted(entries, key=_version_key)

    def names(self) -> list[str]:
        """All registered artifact names (the register's catalog). Only
        names with at least one committed version count — a crash between
        mkdir and the version link must not surface a phantom entry that
        lists here but 404s on lookup."""
        d = os.path.join(self.root, "named")
        try:
            return sorted(n for n in os.listdir(d)
                          if os.path.isdir(os.path.join(d, n))
                          and self.versions(n))
        except FileNotFoundError:
            return []

    def describe(self, uri: str) -> dict:
        """Shape summary of any artifact uri: its content address, whether
        it is a tree (model checkpoint) or a blob (dataset/tokenizer), and
        its stored size — what a registry listing shows without
        materializing anything."""
        cas = self.resolve(uri)
        if not self.exists(cas):
            raise FileNotFoundError(f"{uri} ({cas}) is not in the store")
        manifest = self._manifest_of(cas)
        if manifest is None:
            return {"uri": cas, "kind": "blob",
                    "bytes": os.path.getsize(self.path_for(cas))}
        # Stored size: distinct blobs only — identical shards dedup in the
        # CAS, and the size column must reflect what the store holds.
        return {"uri": cas, "kind": "tree", "files": len(manifest),
                "bytes": sum(os.path.getsize(self._path(d))
                             for d in set(manifest.values()))}

    def lookup(self, name: str, version: Optional[str] = None) -> str:
        """name[@version] → cas:// uri (highest version when none given)."""
        if not _NAME_OK.match(name):
            # Also the path-traversal gate: storage_uri / dataset_uri are
            # user-facing and flow straight here — a name like "../.." or
            # "/etc" must never reach os.path.join.
            raise ValueError(f"bad artifact name {name!r}")
        if version is None:
            all_v = self.versions(name)
            if not all_v:
                raise FileNotFoundError(f"no registered artifact {name!r}")
            version = all_v[-1]
        elif not _NAME_OK.match(version):
            raise ValueError(f"bad artifact version {version!r}")
        entry = os.path.join(self.root, "named", name, version)
        try:
            with open(entry) as f:
                return f.read().strip()
        except FileNotFoundError:
            raise FileNotFoundError(
                f"artifact {name}@{version} is not registered "
                f"(known versions: {self.versions(name) or 'none'})") from None

    # -- artifact:// resolution -----------------------------------------------

    def resolve(self, uri: str) -> str:
        """Any artifact uri → the underlying cas:// content address."""
        if uri.startswith(SCHEME):
            return uri
        if not uri.startswith(ARTIFACT_SCHEME):
            raise ValueError(f"not an artifact uri: {uri!r}")
        ref = uri[len(ARTIFACT_SCHEME):]
        if _HEX_DIGEST.match(ref):
            return SCHEME + ref
        name, sep, version = ref.partition("@")
        if sep and not _NAME_OK.match(version):
            raise ValueError(f"bad version in {uri!r}")
        return self.lookup(name, version if sep else None)

    def localize(self, uri: str) -> str:
        """Resolve to a local filesystem path: tree artifacts materialize to
        a directory, blob artifacts return the CAS file itself (read-only —
        consumers that mutate must copy, which train staging does anyway)."""
        cas = self.resolve(uri)
        if not self.exists(cas):
            raise FileNotFoundError(f"{uri} ({cas}) is not in the store")
        if self.is_tree(cas):
            return self.materialize_tree(cas)
        return self.path_for(cas)


def artifact_store_from_env(root: Optional[str] = None) -> ArtifactStore:
    """The store every subsystem shares: explicit root, or the
    ``KFTPU_ARTIFACT_ROOT`` env the control plane injects into workers."""
    root = root or os.environ.get(ROOT_ENV)
    if not root:
        raise RuntimeError(
            "artifact:// uri but no artifact store: set KFTPU_ARTIFACT_ROOT "
            "or pass artifact_root (the control plane injects the env into "
            "workers automatically)")
    return ArtifactStore(root)
