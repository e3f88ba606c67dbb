"""Rolling deploys and canary decisions over version-pinned replicas: the
port of ``distributed_tensorflow_examples_tpu/serve/deploy.py``, over the
port's :class:`~serve.model_server.ModelReplicaServer` and
:class:`~serve.client.ServePool`.

The deploy story the model registry unlocks: a serve pool flips from
registry version A to version B with ZERO failed predicts, through the
same ordering the autoscaler uses for scale-down (lease-release-before-
stop, pool ejection/rotation, predict purity):

- :class:`RollingDeploy` owns a set of in-process version-PINNED
  replicas.  ``canary`` starts ONE replica at the new version (it loads,
  pins, leases and only then joins routing); ``promote`` replaces the
  remaining old-version replicas one at a time, START-THEN-STOP (surge):
  the replacement is model-loaded and routable BEFORE its predecessor
  releases its lease and drains, so capacity never dips below the pool
  size, and a predict caught on a stopping replica retries on a peer.
  ``rollback`` stops the new version's replicas the same way (guarded: it
  refuses to stop the last replica standing).
- :func:`canary_verdict` is the promote-or-rollback policy over
  :meth:`serve.ServePool.version_stats`: canary error rate and p99
  against the stable lane's, with a minimum-evidence floor so one lucky
  (or unlucky) request cannot decide a deploy.

The controller is in-process (the autoscaler's shape); every ordering
invariant lives here.
"""

from __future__ import annotations

import logging
import threading

from ..utils import faults

log = logging.getLogger("dtx.deploy")


def canary_verdict(
    stable: dict | None, canary: dict | None, *, min_requests: int = 20,
    max_err_ratio: float = 0.02, p99_factor: float = 3.0,
) -> str:
    """``"promote"`` / ``"rollback"`` / ``"hold"`` from two
    ``version_stats()`` rows.  Policy: below ``min_requests`` canary
    answers the evidence is insufficient (hold); a canary error RATIO
    above ``max_err_ratio`` — or a canary p99 beyond ``p99_factor`` x the
    stable p99 — rolls back; otherwise promote."""
    if not canary:
        return "hold"
    total = canary.get("ok", 0) + canary.get("err", 0)
    if total < min_requests:
        return "hold"
    if canary.get("err", 0) > max_err_ratio * total:
        return "rollback"
    c_p99 = canary.get("latency_p99_ms", 0.0)
    s_p99 = (stable or {}).get("latency_p99_ms", 0.0)
    if s_p99 > 0 and c_p99 > p99_factor * s_p99:
        return "rollback"
    return "promote"


class RollingDeploy:
    """Drive version flips over a live in-process replica set.

    ``make_server(index, version)`` builds one version-PINNED replica
    (closing over init_fn/predict_fn/registry_dir and any knobs); the
    controller owns the returned servers' lifecycles.  ``on_change`` (if
    given) is called with the current address list after EVERY topology
    change — wire it to ``ServePool.set_addrs`` for a static pool;
    lease-following pools (``LeaseServeDiscovery``) need nothing.

    Zero-failed-flip ordering, per replacement:

    1. construct the replacement (it loads + PINS its version — a replica
       that cannot load fails construction, aborting the flip with the
       old set intact);
    2. ``wait_for_model`` (paranoia: pin mode loads synchronously);
    3. announce the grown set (``on_change``; the lease the replica
       acquired in its constructor covers discovery-based pools);
    4. stop the predecessor — ``ModelReplicaServer.stop`` releases its
       membership lease FIRST, then drains the core, so routing drops it
       before its port goes dark and an in-flight predict just retries
       on a peer;
    5. announce the shrunk set.
    """

    def __init__(
        self, make_server, *, replicas: int = 3, version: int,
        on_change=None, model_ready_s: float = 60.0,
    ):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self._make = make_server
        self._on_change = on_change
        self._ready_s = float(model_ready_s)
        self._lock = threading.Lock()
        self._next_index = 0
        self._servers: list = []  # [(server, version)]
        self.flips = 0
        self.rollbacks = 0
        for _ in range(replicas):
            self._start_one(int(version))
        self._announce()

    # -- surface -------------------------------------------------------------

    def addrs(self) -> list[tuple[str, int]]:
        with self._lock:
            return [("127.0.0.1", s.port) for s, _v in self._servers]

    def versions(self) -> dict[str, int]:
        """``{addr: pinned version}`` of the live set."""
        with self._lock:
            return {f"127.0.0.1:{s.port}": v for s, v in self._servers}

    def _announce(self) -> None:
        if self._on_change is not None:
            self._on_change(self.addrs())

    def _start_one(self, version: int):
        with self._lock:
            index = self._next_index
            self._next_index += 1
        server = self._make(index, int(version))
        if not server.wait_for_model(self._ready_s):
            server.stop()
            raise TimeoutError(
                f"replacement replica (v{version}) never loaded its model"
            )
        with self._lock:
            self._servers.append((server, int(version)))
        return server

    # -- the deploy verbs ----------------------------------------------------

    def canary(self, version: int) -> tuple[str, int]:
        """Start ONE replica pinned at ``version`` alongside the current
        set; returns its address.  Pair with
        ``ServePool.set_canary(version, weight)`` to route a weighted
        fraction at it, and :func:`canary_verdict` to decide."""
        server = self._start_one(version)
        self._announce()
        faults.log_event(
            "deploy_canary_up", version=int(version), port=server.port,
        )
        return ("127.0.0.1", server.port)

    def promote(self, version: int) -> int:
        """Roll every replica NOT already at ``version`` onto it,
        one surge replacement at a time; returns how many were replaced.
        On any failure the flip stops with the set still fully serving
        (old and already-flipped replicas intact)."""
        replaced = 0
        while True:
            with self._lock:
                old = next(
                    ((s, v) for s, v in self._servers if v != int(version)),
                    None,
                )
            if old is None:
                break
            old_server, old_version = old
            self._start_one(version)  # surge: grow BEFORE shrinking
            self._announce()
            with self._lock:
                self._servers = [
                    (s, v) for s, v in self._servers if s is not old_server
                ]
            old_server.stop()  # lease-release-before-stop lives in stop()
            self._announce()
            replaced += 1
            faults.log_event(
                "deploy_replica_flipped", from_version=int(old_version),
                to_version=int(version),
            )
        if replaced:
            self.flips += 1
            faults.log_event(
                "deploy_promoted", version=int(version), replaced=replaced,
            )
        return replaced

    def rollback(self, version: int) -> int:
        """Stop every replica pinned at ``version`` (the failed canary /
        half-promoted set); returns how many stopped.  Refuses to stop
        the last replica standing — a rollback must degrade to the stable
        set, never to an empty pool."""
        stopped = 0
        while True:
            with self._lock:
                victim = next(
                    (s for s, v in self._servers if v == int(version)),
                    None,
                )
                if victim is None or len(self._servers) <= 1:
                    break
                self._servers = [
                    (s, v) for s, v in self._servers if s is not victim
                ]
            victim.stop()
            self._announce()
            stopped += 1
        if stopped:
            self.rollbacks += 1
            faults.log_event(
                "deploy_rolled_back", version=int(version), stopped=stopped,
            )
        return stopped

    def close(self) -> None:
        with self._lock:
            servers, self._servers = list(self._servers), []
        for s, _v in servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — teardown stops the rest
                log.exception("deploy close: replica stop failed")


def make_pinned_factory(
    param_shapes, predict_fn, ps_addrs=(), *, registry_dir: str,
    model_name: str = "default", **server_kw,
):
    """The standard ``make_server`` for :class:`RollingDeploy`: each
    replica binds an ephemeral port, pins ``(model_name, version)`` from
    ``registry_dir`` and (when ``ps_addrs`` is non-empty) leases itself
    into the membership registry as ``<role>-rd<i>``.  ``param_shapes``
    is the parameter tree the registry's flat vector unflattens into
    (where the JAX factory takes an ``init_fn``); ``server_kw`` reaches
    the replica (``device=``, batcher knobs)."""
    from . import model_server as msrv_lib

    base_role = faults.current_role() or "serve"

    def make(i: int, version: int) -> msrv_lib.ModelReplicaServer:
        return msrv_lib.ModelReplicaServer(
            param_shapes, predict_fn, list(ps_addrs), port=0,
            role=f"{base_role}-rd{i}", registry_dir=registry_dir,
            model_name=model_name, model_version=int(version), **server_kw,
        )

    return make
