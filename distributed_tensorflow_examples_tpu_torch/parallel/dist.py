"""The process world: the port of
``distributed_tensorflow_examples_tpu/parallel/dist.py``.

One process is one rank and owns one device.  :func:`resolve_cluster`
reads the world as the JAX resolver does: explicit arguments first, then
``TF_CONFIG`` (chief before worker in the rank order; a ``ps`` or
``evaluator`` task has no seat, and the ``Experiment`` prints and exits
0).  :func:`initialize` joins ``torch.distributed`` with the coordinator
(the first chief/worker task) as ``tcp://host:port``; a run with no
cluster information stays single-process and creates no group, as the
JAX package skips ``jax.distributed.initialize``.

The backend is chosen by one rule, :func:`backend_for`, never by a
fallback: a CPU rank takes ``gloo``; CUDA ranks take ``nccl`` when each
local rank has a card of its own, and ``gloo`` when local ranks share a
card (NCCL refuses two ranks on one device).  A failing NCCL start
raises.  Each rank's device is ``cuda:(local_rank % device_count)``, or
the CPU when the caller asks for it.

The watchdog is the JAX one: every rank overwrites ``dtx/hb/<rank>`` in
the coordinator's TCP store every ``interval_s``; a monitor thread
declares a peer whose beat stopped advancing dead and exits
``EXIT_PEER_LOST`` so ``utils.supervisor`` restarts the task.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import threading
import time

import torch
import torch.distributed as tdist

from ..utils import device as device_lib

log = logging.getLogger("dtx.dist")

#: Exit code of a process whose watchdog declared a peer dead.
EXIT_PEER_LOST = 83


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """The resolved identity of this process (the JAX ``ClusterConfig``,
    plus the chief/worker task addresses in rank order)."""

    coordinator_address: str | None  # host:port of rank 0
    num_processes: int | None
    process_id: int | None
    source: str  # "args" | "tf_config" | "auto"
    task_type: str | None = None
    hosts: tuple[str, ...] = ()  # host:port of every chief/worker task (TF_CONFIG)

    @property
    def is_ps_task(self) -> bool:
        """A ``ps`` or ``evaluator`` task: no seat in the world; the
        process exits 0."""
        return self.task_type in ("ps", "evaluator")

    def local_ranks(self) -> tuple[int, int]:
        """(local rank, local world): this task's place among the tasks on
        its host.  Explicit arguments name no hosts: all ranks are local."""
        if not self.hosts:
            return int(self.process_id or 0), int(self.num_processes or 1)
        here = _host(self.hosts[self.process_id])
        same = [i for i, h in enumerate(self.hosts) if _host(h) == here]
        return same.index(self.process_id), len(same)


def _host(address: str) -> str:
    return address.rpartition(":")[0] or address


def resolve_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> ClusterConfig:
    """Explicit arguments win; else ``TF_CONFIG``; else nothing
    (``source="auto"``: one process)."""
    if coordinator_address or num_processes is not None or process_id is not None:
        return ClusterConfig(coordinator_address, num_processes, process_id, "args")
    tf_config = os.environ.get("TF_CONFIG")
    if tf_config:
        try:
            cfg = json.loads(tf_config)
            cluster = cfg.get("cluster", {})
            task = cfg.get("task", {})
            workers = list(cluster.get("chief", [])) + list(cluster.get("worker", []))
            if cluster.get("ps"):
                log.warning(
                    "TF_CONFIG lists %d ps tasks: synchronous data parallelism needs "
                    "no parameter servers; counting only chief/worker tasks as "
                    "processes.", len(cluster["ps"]),
                )
            task_type = task.get("type")
            index = int(task.get("index", 0))
            if task_type == "worker" and "chief" in cluster:
                index += len(cluster["chief"])
            if workers:
                if task_type not in (None, "chief", "worker"):
                    return ClusterConfig(workers[0], len(workers), None, "tf_config",
                                         task_type, tuple(workers))
                return ClusterConfig(workers[0], len(workers), index, "tf_config",
                                     task_type, tuple(workers))
        except (ValueError, KeyError) as e:
            log.warning("ignoring malformed TF_CONFIG: %s", e)
    return ClusterConfig(None, None, None, "auto")


def backend_for(device: torch.device, local_world: int, device_count: int) -> str:
    """The collective backend of a rank on ``device`` with ``local_world``
    ranks on its host and ``device_count`` cards: ``gloo`` on the CPU;
    ``nccl`` when every local rank has a card of its own; ``gloo`` when
    local ranks share a card."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no collective backend for a {device.type} rank")
    return "nccl" if local_world <= device_count else "gloo"


@dataclasses.dataclass(frozen=True)
class _World:
    cluster: ClusterConfig
    backend: str
    device: torch.device


_world: _World | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> ClusterConfig:
    """Join the process group (idempotent).  ``device`` is the caller's
    request (``None`` = the card, ``"cpu"``); the rank's own device is
    :func:`device` afterwards.  A single-process run (no cluster
    information) and a ``ps``/``evaluator`` task create no group."""
    global _world
    cfg = resolve_cluster(coordinator_address, num_processes, process_id)
    if _world is not None:
        return cfg
    if cfg.is_ps_task:
        log.warning("TF_CONFIG task type %r has no seat in the world; not joining "
                    "(the caller exits 0).", cfg.task_type)
        return cfg
    if cfg.source == "auto":
        return cfg
    if not cfg.coordinator_address or cfg.num_processes is None or cfg.process_id is None:
        raise ValueError(
            "an explicit cluster needs coordinator_address, num_processes and "
            f"process_id; got {cfg}"
        )
    requested = device_lib.resolve(device)
    local_rank, local_world = cfg.local_ranks()
    count = torch.cuda.device_count() if requested.type == "cuda" else 0
    backend = backend_for(requested, local_world, count)
    dev = requested
    if requested.type == "cuda" and requested.index is None:
        dev = torch.device("cuda", local_rank % count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info(
        "process group: backend %s (%s rank, %d local rank(s) on %d card(s)), rank %d "
        "of %d on %s, coordinator tcp://%s", backend, dev.type, local_world, count,
        cfg.process_id, cfg.num_processes, dev, cfg.coordinator_address,
    )
    tdist.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        rank=cfg.process_id, world_size=cfg.num_processes,
        **({"device_id": dev} if backend == "nccl" else {}),
    )
    _world = _World(cfg, backend, dev)
    return cfg


def is_initialized() -> bool:
    return _world is not None


def backend() -> str | None:
    """The group's backend, or None without a group."""
    return _world.backend if _world is not None else None


def device() -> torch.device:
    """This rank's device (requires :func:`initialize` to have joined)."""
    if _world is None:
        raise RuntimeError("no process group: call dist.initialize() first")
    return _world.device


def process_index() -> int:
    return tdist.get_rank() if _world is not None else 0


def process_count() -> int:
    return tdist.get_world_size() if _world is not None else 1


def is_chief() -> bool:
    """Rank 0, the reference's ``task_index == 0`` chief: it alone writes
    metrics, checkpoints and the FINAL line."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Every rank reaches this point before any goes on (a no-op on one
    process)."""
    if _world is None:
        return
    log.debug("barrier %s", name)
    if _world.backend == "nccl":
        tdist.barrier(device_ids=[_world.device.index])
    else:
        tdist.barrier()


# ----------------------------------------------------------------------------
# Failure detection: the peer-heartbeat watchdog
# ----------------------------------------------------------------------------


class _StoreClient:
    """``set``/``get`` on a connection of its own to the coordinator's TCP
    store (the process group holds another)."""

    def __init__(self, address: str):
        host, _, port = address.rpartition(":")
        self.store = tdist.TCPStore(host, int(port), is_master=False,
                                    timeout=datetime.timedelta(seconds=30))

    def set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def get(self, key: str) -> str | None:
        if not self.store.check([key]):
            return None
        return self.store.get(key).decode()


_watchdog_thread = None
_watchdog_stop = None
_watchdog_client = None
_watchdog_beat = None


def start_watchdog(
    *,
    interval_s: float = 2.0,
    grace_s: float = 10.0,
    startup_grace_s: float = 120.0,
    on_failure=None,
    _client=None,
    _idx=None,
    _count=None,
) -> bool:
    """Detect dead peers and fail fast instead of hanging in a collective
    (the JAX ``start_watchdog``).  A peer whose beat reads ``"done"`` left
    cleanly (:func:`stop_watchdog`); one that never beats within
    ``startup_grace_s`` is dead too.  ``on_failure(dead)`` replaces the
    default ``os._exit(EXIT_PEER_LOST)``.  Returns True when started (a
    world of 2 or more).  ``_client`` (an object with ``set(key, value)``
    and ``get(key) -> str | None``), ``_idx`` and ``_count`` are test
    seams."""
    global _watchdog_thread, _watchdog_stop, _watchdog_client, _watchdog_beat
    if _watchdog_thread is not None:
        return True
    idx = process_index() if _idx is None else _idx
    count = process_count() if _count is None else _count
    if count < 2:
        return False
    if _client is not None:
        beat_client = monitor_client = _client
    else:
        address = _world.cluster.coordinator_address
        beat_client, monitor_client = _StoreClient(address), _StoreClient(address)
    if grace_s < 3 * interval_s:
        log.warning("watchdog: grace_s=%.1f < 3x interval_s=%.1f; clamping to %.1f",
                    grace_s, interval_s, 3 * interval_s)
        grace_s = 3 * interval_s
    stop = threading.Event()

    def _beat():
        seq, misses = 0, 0
        while not stop.is_set():
            seq += 1
            try:
                beat_client.set(f"dtx/hb/{idx}", str(seq))
                misses = 0
            except Exception as e:  # keep beating while the process lives
                misses += 1
                if misses <= 3 or misses % 30 == 0:
                    log.warning("watchdog: heartbeat publish failed %dx (%s); retrying",
                                misses, e)
            stop.wait(interval_s)

    def _fail(dead: list[int]):
        log.critical(
            "watchdog: peer heartbeat lost for rank(s) %s; exiting %d for supervisor "
            "restart (the whole job restarts and auto-resumes from the last "
            "checkpoint).", dead, EXIT_PEER_LOST,
        )
        os._exit(EXIT_PEER_LOST)

    fail = on_failure or _fail

    def _monitor():
        last: dict[int, str] = {}
        t0 = time.monotonic()
        misses = 0
        while not stop.is_set():
            stop.wait(grace_s)
            if stop.is_set():
                return
            try:
                now = {p: monitor_client.get(f"dtx/hb/{p}") for p in range(count) if p != idx}
                misses = 0
            except Exception as e:
                misses += 1
                if misses >= 3:
                    log.warning("watchdog: store unreachable 3x (%s); monitor disabled", e)
                    return
                continue
            dead = [
                p for p, seq in now.items()
                if seq != "done" and (
                    (seq is not None and last.get(p) == seq)
                    or (seq is None and time.monotonic() - t0 > startup_grace_s)
                )
            ]
            if dead:
                fail(dead)
                return
            last.update({p: s for p, s in now.items() if s is not None})

    _watchdog_stop = stop
    _watchdog_client = beat_client
    _watchdog_thread = threading.Thread(target=_monitor, daemon=True, name="dtx-watchdog")
    _watchdog_beat = threading.Thread(target=_beat, daemon=True, name="dtx-heartbeat")
    _watchdog_beat.start()
    _watchdog_thread.start()
    log.info("watchdog up: %d peers, beat %.1fs, grace %.1fs", count - 1, interval_s, grace_s)
    return True


def stop_watchdog(*, _client=None, _idx=None) -> None:
    """Stop beating and announce a clean departure (peers must not read
    this process's silence as a crash)."""
    global _watchdog_thread, _watchdog_stop, _watchdog_client, _watchdog_beat
    if _watchdog_stop is not None:
        _watchdog_stop.set()
        _watchdog_beat.join(timeout=30)  # no beat may land after "done"
        client = _client if _client is not None else _watchdog_client
        if client is not None:
            try:
                client.set(f"dtx/hb/{process_index() if _idx is None else _idx}", "done")
            except Exception:
                pass  # the store is gone already
    _watchdog_thread = _watchdog_stop = _watchdog_client = _watchdog_beat = None
