"""Model registry: immutable versioned snapshots the serve plane pins (r19).

Until now the serve plane could only HOT-TRACK the single live training
run — every replica follows the PS head, so there was no way to stage,
pin, or roll back a model.  This module is the missing versioned layer
(the TensorFlow paper's checkpointed-session capability, rebuilt for the
flat-param serving substrate):

- :class:`ModelRegistry` — a directory of immutable ``(model_name,
  version)`` snapshots.  ``publish`` writes the flat parameter vector
  plus a MANIFEST (flat-param spec, training step, dtype, source run);
  the manifest is written ATOMICALLY (tmp file, flush+fsync, rename,
  directory fsync) and LAST, so a version either exists completely or
  not at all — a crash mid-publish leaves no half-readable version, and
  a reader that sees the manifest sees everything it names.
- **Pins** — a replica serving a version PINS it (lease-style: an owner
  file with a TTL, renewed on the replica's refresh cadence), and
  :meth:`gc` NEVER deletes a pinned version no matter what
  ``keep_last_n`` says — retention can shrink history, it cannot yank a
  model out from under a live replica.

The port's copy of ``distributed_tensorflow_examples_tpu/serve/registry.py``
with the same on-disk format: a version either package publishes loads in
the other.

Version ids are immutable: re-publishing an existing version is refused
loudly (a deploy pipeline must mint a NEW version to change bytes — that
is what makes "replica X serves v3" a meaningful statement).  Everything
is plain files under one root, shareable by every process on a host (or
a shared filesystem) with no extra service.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

import numpy as np

from ..parallel import tenancy

log = logging.getLogger("dtx.registry")

#: Manifest schema version (tests pin it).
MANIFEST_SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")
_VERSION_DIR_RE = re.compile(r"^v(\d{6})$")


class RegistryError(RuntimeError):
    """A registry operation failed (unknown version, immutability
    violation, malformed manifest)."""


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename into it is durable — the half of
    atomic-publish a bare ``os.replace`` does not give you."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(path: str, manifest: dict) -> None:
    """The ONE manifest writer: tmp file, flush+fsync, atomic rename,
    directory fsync — on EVERY exit path the tmp handle is closed, and
    the destination is either the complete old content or the complete
    new content, durably.  Every registry publish path must route through
    here (pinned by dtxlint's ``registry-manifest`` lifecycle check)."""
    tmp = path + ".tmp"
    f = open(tmp, "w")
    try:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    finally:
        f.close()
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class ModelRegistry:
    """Filesystem-backed registry of immutable ``(name, version)`` model
    snapshots.  Layout::

        <root>/<name>/v000001/params.npy      the flat param vector
        <root>/<name>/v000001/manifest.json   written LAST, atomically
        <root>/<name>/v000001/pins/<owner>.json   lease-style pin files

    A version without a ``manifest.json`` is invisible (a crashed
    publish); a version with one is complete and immutable.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _model_dir(self, name: str) -> str:
        if not _NAME_RE.match(name):
            raise RegistryError(
                f"model name {name!r} must match {_NAME_RE.pattern}"
            )
        return os.path.join(self.root, name)

    def _version_dir(self, name: str, version: int) -> str:
        if version < 1:
            raise RegistryError(f"version must be >= 1, got {version}")
        return os.path.join(self._model_dir(name), f"v{int(version):06d}")

    # -- read side -----------------------------------------------------------

    def models(self) -> list[str]:
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [
            e for e in entries
            if _NAME_RE.match(e) and os.path.isdir(os.path.join(self.root, e))
        ]

    def versions(self, name: str) -> list[int]:
        """Published (manifest-complete) versions, ascending."""
        out = []
        try:
            entries = os.listdir(self._model_dir(name))
        except OSError:
            return []
        for e in sorted(entries):
            m = _VERSION_DIR_RE.match(e)
            if m and os.path.exists(
                os.path.join(self._model_dir(name), e, "manifest.json")
            ):
                out.append(int(m.group(1)))
        return out

    def latest(self, name: str) -> int | None:
        vs = self.versions(name)
        return vs[-1] if vs else None

    def manifest(self, name: str, version: int) -> dict:
        path = os.path.join(self._version_dir(name, version), "manifest.json")
        try:
            with open(path) as f:
                m = json.load(f)
        except OSError as e:
            raise RegistryError(
                f"no published version {name}/v{version} under {self.root}"
            ) from e
        except ValueError as e:
            raise RegistryError(
                f"manifest for {name}/v{version} is not valid JSON"
            ) from e
        for key in ("name", "version", "step", "num_elems", "dtype"):
            if key not in m:
                raise RegistryError(
                    f"manifest for {name}/v{version} lacks {key!r}"
                )
        return m

    def load(self, name: str, version: int) -> tuple[int, np.ndarray, dict]:
        """``(step, flat_params, manifest)`` for a published version.  The
        flat vector is validated against the manifest's spec — a truncated
        or wrong-dtype blob fails HERE, not as garbage attention later."""
        m = self.manifest(name, version)
        path = os.path.join(
            self._version_dir(name, version), m.get("params_file", "params.npy")
        )
        flat = np.load(path)
        if flat.shape != (int(m["num_elems"]),) or str(flat.dtype) != m["dtype"]:
            raise RegistryError(
                f"{name}/v{version}: params blob is {flat.shape}/{flat.dtype}, "
                f"manifest says ({m['num_elems']},)/{m['dtype']}"
            )
        return int(m["step"]), flat, m

    # -- publish -------------------------------------------------------------

    def publish(
        self, name: str, flat, *, step: int, version: int | None = None,
        source: str = "", extra: dict | None = None,
    ) -> int:
        """Publish one immutable snapshot; returns the version id.
        ``version=None`` mints ``latest + 1``.  Re-publishing an existing
        version is refused (immutability is the whole point).  The params
        blob lands first (fsync'd), the manifest last (atomic + fsync'd),
        so a reader never sees a manifest whose blob is missing or
        partial."""
        flat = np.ascontiguousarray(np.asarray(flat).reshape(-1))
        if version is None:
            version = (self.latest(name) or 0) + 1
        vdir = self._version_dir(name, int(version))
        manifest_path = os.path.join(vdir, "manifest.json")
        if os.path.exists(manifest_path):
            raise RegistryError(
                f"{name}/v{version} is already published — registry versions "
                "are immutable; publish a new version instead"
            )
        os.makedirs(vdir, exist_ok=True)
        params_tmp = os.path.join(vdir, "params.npy.tmp")
        f = open(params_tmp, "wb")
        try:
            np.save(f, flat)
            f.flush()
            os.fsync(f.fileno())
        finally:
            f.close()
        os.replace(params_tmp, os.path.join(vdir, "params.npy"))
        _fsync_dir(vdir)
        manifest = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "name": name,
            "version": int(version),
            "step": int(step),
            "num_elems": int(flat.size),
            "dtype": str(flat.dtype),
            "params_file": "params.npy",
            "source": source,
            "created_unix": time.time(),
        }
        if extra:
            manifest["extra"] = dict(extra)
        write_manifest(manifest_path, manifest)
        log.info(
            "registry: published %s/v%d (step %d, %d elems) under %s",
            name, version, step, flat.size, self.root,
        )
        return int(version)

    def publish_from_checkpoint(
        self, manager, template, name: str, *, version: int | None = None,
        source: str = "checkpoint",
    ) -> int:
        """Publish the NEWEST checkpoint a ``train.checkpoint.
        CheckpointManager`` holds: restore into ``template`` (a
        TrainState, whose tensors take the checkpoint's values), flatten
        the params half in registry order, publish.  Raises when the
        manager holds no checkpoint."""
        from ..train.checkpoint import flat_params_of

        restored = manager.restore_latest(template)
        if restored is None:
            raise RegistryError(
                f"checkpoint manager holds no step to publish as {name!r}"
            )
        step = manager.latest_step()
        return self.publish(
            name, flat_params_of(restored), step=int(step or 0), version=version,
            source=source,
        )

    # -- pins (lease-style refcount) ----------------------------------------

    def _pins_dir(self, name: str, version: int) -> str:
        return os.path.join(self._version_dir(name, version), "pins")

    def pin(
        self, name: str, version: int, owner: str, *, ttl_s: float = 60.0,
        tenant: str = tenancy.DEFAULT_TENANT,
    ) -> None:
        """Pin a version on behalf of ``owner`` (a serving replica's
        role): refresh on the replica's poll cadence — an expired pin no
        longer protects, so a crashed replica cannot block GC forever
        (the same self-healing posture as membership leases).

        The pin file is keyed by the TENANT-QUALIFIED owner (r20): two
        tenants' replicas sharing both a snapshot and a role name (e.g.
        both pinning the shared base model as ``serve0``) hold two
        distinct pins — one tenant's unpin/GC sweep can never unprotect
        the version out from under the other tenant's live replica."""
        if not _NAME_RE.match(owner):
            raise RegistryError(
                f"pin owner {owner!r} must match {_NAME_RE.pattern}"
            )
        owner = tenancy.qualify(tenant, owner)
        self.manifest(name, version)  # pinning an unpublished version is a bug
        pins = self._pins_dir(name, version)
        os.makedirs(pins, exist_ok=True)
        write_manifest(
            os.path.join(pins, f"{owner}.json"),
            {"owner": owner, "expires_unix": time.time() + float(ttl_s)},
        )

    def unpin(
        self, name: str, version: int, owner: str, *,
        tenant: str = tenancy.DEFAULT_TENANT,
    ) -> None:
        owner = tenancy.qualify(tenant, owner)
        try:
            os.unlink(os.path.join(self._pins_dir(name, version), f"{owner}.json"))
        except OSError:
            pass  # idempotent

    def pinned_by(self, name: str, version: int) -> list[str]:
        """Owners holding an UNEXPIRED pin on this version (expired pin
        files are pruned as they are seen)."""
        pins = self._pins_dir(name, version)
        out = []
        try:
            entries = sorted(os.listdir(pins))
        except OSError:
            return []
        now = time.time()
        for e in entries:
            if not e.endswith(".json") or e.endswith(".tmp"):
                continue
            path = os.path.join(pins, e)
            try:
                with open(path) as f:
                    p = json.load(f)
                if float(p.get("expires_unix", 0)) > now:
                    out.append(p.get("owner", e[: -len(".json")]))
                else:
                    os.unlink(path)
            except (OSError, ValueError):
                continue
        return out

    # -- retention -----------------------------------------------------------

    def gc(self, name: str, *, keep_last_n: int) -> list[int]:
        """Delete all but the newest ``keep_last_n`` versions — EXCEPT any
        version a live (unexpired) pin protects.  Returns the versions
        deleted.  The manifest is unlinked FIRST, so a concurrent reader
        racing the delete sees 'not published' (the same state as
        pre-publish), never a manifest whose blob is gone."""
        if keep_last_n < 1:
            raise RegistryError(f"keep_last_n must be >= 1, got {keep_last_n}")
        versions = self.versions(name)
        deleted = []
        for v in versions[:-keep_last_n]:
            owners = self.pinned_by(name, v)
            if owners:
                log.info(
                    "registry gc: keeping %s/v%d past keep_last_n=%d — "
                    "pinned by %s", name, v, keep_last_n, owners,
                )
                continue
            vdir = self._version_dir(name, v)
            try:
                os.unlink(os.path.join(vdir, "manifest.json"))
            except OSError:
                continue  # raced another gc
            for sub, _dirs, files in os.walk(vdir, topdown=False):
                for fn in files:
                    try:
                        os.unlink(os.path.join(sub, fn))
                    except OSError:
                        pass
                try:
                    os.rmdir(sub)
                except OSError:
                    pass
            deleted.append(v)
        if deleted:
            log.info("registry gc: deleted %s versions %s", name, deleted)
        return deleted
