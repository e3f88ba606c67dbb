"""Autoscaling serve pool: replicas grow and shrink against measured load.
The port of ``distributed_tensorflow_examples_tpu/serve/autoscale.py``.

``--serve_hosts`` pins a replica set at launch.  This module closes the
elasticity loop the membership leases (``parallel/membership.py``) enable:

- :class:`ServeAutoscaler` owns a set of in-process
  :class:`~serve.model_server.ModelReplicaServer` replicas and sizes it
  against MEASURED load: the batcher's in-system depth and the served p99
  that each replica already records.  Scale-up adds a replica (which
  announces itself in the lease registry and starts hot-tracking the PS
  with zero coordination); scale-down stops the newest replica AFTER
  dropping it from discovery, so clients rotate off it first, and a
  predict caught in flight on a stopping replica retries on a peer
  (:class:`serve.ServePool`'s ejection/rotation; predict is pure).
- :class:`LeaseServeDiscovery` is the client half: it polls the lease
  registry for ``kind="serve"`` members and reconciles a ``ServePool``
  onto the live set (``ServePool.set_addrs``).

Decisions are damped (``settle_polls`` consecutive over/under-load polls
before acting) so one bursty batch can't flap the pool.
"""

from __future__ import annotations

import logging
import threading
import time

from ..utils import faults, telemetry

log = logging.getLogger("dtx.autoscale")

_OBS_UP = telemetry.REGISTRY.counter("autoscale/scale_ups")
_OBS_DOWN = telemetry.REGISTRY.counter("autoscale/scale_downs")


class ServeAutoscaler:
    """Grow/shrink an in-process replica set against queue depth and p99.

    ``make_server(index) -> ModelReplicaServer``   replica factory (the
        caller closes over init_fn/predict_fn/ps_addrs and any knobs);
        the autoscaler owns the returned servers' lifecycles.
    ``min_replicas`` / ``max_replicas``            pool bounds.
    ``queue_high``      mean in-system requests per replica above which
                        the pool is overloaded (scale up).
    ``queue_low``       mean depth below which the pool is idle (scale
                        down, never under ``min_replicas``).
    ``p99_high_ms``     optional latency SLO: a measured p99 above it
                        counts as overload even at low queue depth.
    ``settle_polls``    consecutive polls a condition must hold before
                        acting (damping).
    """

    def __init__(
        self,
        make_server,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        queue_high: float = 8.0,
        queue_low: float = 1.0,
        p99_high_ms: float | None = None,
        settle_polls: int = 3,
        poll_s: float = 1.0,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"bad replica bounds [{min_replicas}, {max_replicas}]"
            )
        self._make = make_server
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p99_high_ms = p99_high_ms
        self.settle_polls = max(1, int(settle_polls))
        self.poll_s = float(poll_s)
        self.scale_ups = 0
        self.scale_downs = 0
        self._hot_polls = 0
        self._cold_polls = 0
        self._lock = threading.Lock()
        self._servers: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        for _ in range(self.min_replicas):
            self._grow_locked()

    # -- pool surface --------------------------------------------------------

    def addrs(self) -> list[tuple[str, int]]:
        with self._lock:
            return [("127.0.0.1", s.port) for s in self._servers]

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._servers)

    # -- the control loop ----------------------------------------------------

    def _measurements(self) -> tuple[float, float]:
        """(mean in-system depth per replica, max p99 ms) across the
        pool, read from the replicas' own instruments — no scrape round
        trip for an in-process pool."""
        with self._lock:
            servers = list(self._servers)
        if not servers:
            return 0.0, 0.0
        depth = sum(s._batcher.stats()["inflight"] for s in servers)
        p99 = max(
            s.latency.percentile_scalars("serve").get(
                "serve/latency_p99_ms", 0.0
            )
            for s in servers
        )
        return depth / len(servers), p99

    def poll_once(self) -> str:
        """One control decision: 'up', 'down' or 'hold' (tests drive this
        directly for determinism; the background loop just paces it)."""
        depth, p99 = self._measurements()
        hot = depth > self.queue_high or (
            self.p99_high_ms is not None and p99 > self.p99_high_ms
        )
        cold = depth < self.queue_low
        self._hot_polls = self._hot_polls + 1 if hot else 0
        self._cold_polls = self._cold_polls + 1 if cold else 0
        with self._lock:
            n = len(self._servers)
        if self._hot_polls >= self.settle_polls and n < self.max_replicas:
            self._hot_polls = 0
            self.scale_up(depth=depth, p99=p99)
            return "up"
        if self._cold_polls >= self.settle_polls and n > self.min_replicas:
            self._cold_polls = 0
            self.scale_down(depth=depth)
            return "down"
        return "hold"

    def _grow_locked(self) -> None:
        self._servers.append(self._make(len(self._servers)))

    def scale_up(self, **why) -> tuple[str, int]:
        """Add one replica; returns its address.  The new replica leases
        itself into the registry and hot-tracks the PS — discovery (and
        dtxtop) sees it within one heartbeat, with zero coordination."""
        with self._lock:
            self._grow_locked()
            addr = ("127.0.0.1", self._servers[-1].port)
        self.scale_ups += 1
        _OBS_UP.inc()
        faults.log_event(
            "autoscale_up", replicas=self.num_replicas,
            **{k: round(float(v), 3) for k, v in why.items()},
        )
        return addr

    def scale_down(self, **why) -> tuple[str, int] | None:
        """Retire the newest replica: release its lease FIRST (discovery
        drops it from the rotation), then stop it.  A request caught
        in-flight retries on a peer — the pool's ejection/rotation makes
        the drain invisible to callers."""
        with self._lock:
            if len(self._servers) <= self.min_replicas:
                return None
            server = self._servers.pop()
        addr = ("127.0.0.1", server.port)
        server.stop()  # stop() releases the lease before closing conns
        self.scale_downs += 1
        _OBS_DOWN.inc()
        faults.log_event(
            "autoscale_down", replicas=self.num_replicas,
            **{k: round(float(v), 3) for k, v in why.items()},
        )
        return addr

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Run the control loop in the background (``poll_s`` cadence)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dtx-autoscale"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — sizing must never crash serving
                log.exception("autoscaler poll failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            servers, self._servers = list(self._servers), []
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass


def make_replica_factory(param_shapes, predict_fn, ps_addrs, **server_kw):
    """The standard ``make_server`` for :class:`ServeAutoscaler`: each
    replica binds an ephemeral port, leases itself as ``<role>-es<i>``
    (elastic-serve) and inherits the caller's batcher/refresh knobs
    (``device=`` too).  ``param_shapes`` is the parameter tree the PS
    vector unflattens into (where the JAX factory takes an ``init_fn``).

    Registry pinning composes: pass ``registry_dir=`` + ``model_version=``
    through ``server_kw`` and every autoscaled replica pins the SAME
    immutable version, so demand-driven scale-up cannot drift a versioned
    pool (version flips are :class:`serve.deploy.RollingDeploy`'s job)."""
    from .model_server import ModelReplicaServer

    base_role = faults.current_role() or "serve"

    def make(i: int) -> ModelReplicaServer:
        return ModelReplicaServer(
            param_shapes, predict_fn, list(ps_addrs), port=0,
            role=f"{base_role}-es{i}", **server_kw,
        )

    return make


class LeaseServeDiscovery:
    """Follows the lease registry's ``kind="serve"`` members and
    reconciles a :class:`serve.ServePool` onto the live set — the client
    half of the elastic pool.  Keeps the LAST non-empty set when the
    registry momentarily answers empty mid-failover (an empty rotation
    would fail requests a degraded-but-alive pool could still serve)."""

    def __init__(
        self, ps_addrs, pool, *, poll_s: float = 1.0,
        role: str | None = None, follow_epoch: bool = True,
        layout_version: int = 0,
    ):
        from ..parallel import membership

        self.pool = pool
        self.updates = 0

        def _reconcile(_m=None) -> None:
            watcher = getattr(self, "_watcher", None)
            if watcher is None:  # first poll racing the ctor's assignment
                return
            live = sorted(
                m["addr"] for m in watcher.members() if m.get("addr")
            )
            addrs = [
                a
                for a in (membership.unpack_addr(x) for x in live)
                if a is not None
            ]
            if addrs:
                self.pool.set_addrs(addrs)
                self.updates += 1

        # follow_epoch: the registry moves with a live PS reshard; chasing
        # the committed epoch keeps replica discovery alive across an
        # N -> M transition.
        self._watcher = membership.LeaseWatcher(
            list(ps_addrs), kind="serve", poll_s=poll_s,
            on_join=_reconcile, on_leave=_reconcile, role=role,
            follow_epoch=follow_epoch, layout_version=layout_version,
        )

    def poll_once(self) -> None:
        self._watcher.poll_once()

    def close(self) -> None:
        self._watcher.close()
