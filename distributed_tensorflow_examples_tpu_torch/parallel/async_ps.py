"""Async / sync-replicas parameter-server EMULATION in one process: the port
of the thread mode of ``distributed_tensorflow_examples_tpu/parallel/
async_ps.py`` (``AsyncPSConfig``, ``AsyncPSTrainer``).

The reference's W2 config is asynchronous SGD: each worker applies its
gradient to the PS-hosted variables immediately, with no aggregation and no
staleness gate (SURVEY.md section 3.2); its W1 config is the opposite pole,
``SyncReplicasOptimizer``: accumulators average ``replicas_to_aggregate``
gradients, drop stale ones, and a chief pushes tokens that gate the workers
(section 3.1, D5).

As in the JAX package, worker threads time-share one device:

- The parameters are hosted on the host (the PS role): one flat float32
  master vector (pinned when the device is a GPU) whose slices are the
  leaves of the parameter tree, in the JAX package's leaf order (sorted
  keys, ``bridge.flat_param_spec``).  The optimizer updates that master
  copy in place on the host (``train/optim.py``), as update number
  ``global_step`` (a schedule reads its rate at that count).
- After each apply the chief copies the master vector to the device once
  (one host-to-device copy) and publishes that copy, with its step, as
  the snapshot workers compute against.  The snapshot never changes once
  published, so a gradient is computed at exactly the parameters of the
  ``global_step`` it reports, and no number differs from computing at the
  host copy.
- Each worker computes its gradient on the device (``torch.autograd.grad``
  with respect to the snapshot's leaves; threads never share a ``.grad``),
  copies it to the host as one flat float32 array and hands it to the
  native service (``native/accumulator.cc``): the flat accumulator in sync
  mode, the gradient queue in async mode.  The chief takes or pops, applies
  and publishes.  Every blocking native call releases the interpreter lock.

Semantics kept from the JAX module: whole gradients move atomically (one
flat accumulator, numerically the reference's per-variable accumulators for
equal counts); async applies each gradient individually, in arrival order,
with an optional ``max_staleness`` floor; the fixed round-robin interleave
makes an async run reproducible; a worker's exception cancels the services
and is raised from ``run()``; params, optimizer state and step are
checkpointed under ``ckpt_dir/<step>/`` and restored by ``run()``.  One
ordering differs: in sync mode the chief moves the accumulator's step on
right after its ``take`` instead of after the apply, so a gradient of the
old step that arrives while the apply runs is dropped as stale instead of
joining the next average.

Cross-process mode (the second half of this module): the same emulation
over the socket service (``native/ps_server.cc`` behind
``parallel/ps_service.py``), one process per task as the reference
launched it.  :func:`host_ps_task` hosts the service in a host-only PS
process (it never touches the card); :class:`RemotePSChief` runs the
chief's loop with the host-side apply above, publishing each step's
parameters to the service's param store where the emulation copied them to
the device; :func:`remote_worker_loop` is a worker process: it pulls the
published parameters (versioned, into pinned memory, one non-blocking copy
to the card), computes its gradient on the card and pushes it back as one
flat float32 array.  The clients reconnect and replay through PS outages,
a restarted PS is reseeded by the chief, and workers keep a membership
lease on the coordinator, as in the JAX package.  The parameters may be
sharded over N PS servers (``parallel/ps_shard.py``) and each shard
replicated as a primary/backup pair (``--ps_replicas=2``): a client whose
primary dies fails over to the backup, which holds the same state token,
so the chief reseeds nothing.  A live reshard N -> M (``parallel/
reshard.py``) is adopted by the chief between two applies (verify,
republish, commit, swap, drain) and followed by every worker, which
rebuilds its whole client side onto the new epoch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .. import native
from ..bridge import flat_param_spec, flat_params_of
from ..data.pipeline import to_device
from ..train.checkpoint import CheckpointManager
from ..train.state import TrainState, as_state_leaves, leaves
from ..utils import device as device_lib
from ..utils import faults, telemetry, threefry

log = logging.getLogger("dtx.async_ps")


@dataclasses.dataclass
class AsyncPSConfig:
    num_workers: int = 2
    mode: str = "async"  # "async" (W2) | "sync_replicas" (W1/D5 semantics)
    replicas_to_aggregate: int | None = None  # sync mode; default num_workers
    max_staleness: int | None = None  # async mode: drop grads older than this
    #: Async mode only: replace free-running worker threads with a
    #: deterministic round-robin schedule — every applied gradient was
    #: computed one schedule slot per peer earlier, so applies still happen
    #: at STALE params (true W2 semantics) but the interleaving (and hence
    #: the trajectory) is exactly reproducible.  The CLI's
    #: ``--deterministic`` selects it.  Reproducibility is scoped to
    #: UNINTERRUPTED runs: pending gradients are not checkpointed, so a
    #: resumed run recomputes them at the restored params; two runs agree
    #: bitwise iff they share the same checkpoint/restart schedule.
    fixed_interleave: bool = False
    train_steps: int = 100
    ckpt_dir: str | None = None
    checkpoint_every: int = 50  # applied updates between saves
    #: Cross-process mode only — the PS client's fault posture.  Per-op
    #: deadline: blocking ops become bounded server-side waits the client
    #: re-issues, so a dead PS surfaces within ~one chunk.
    ps_op_timeout_s: float | None = 30.0
    #: How long a client keeps reconnecting (exponential backoff) before a
    #: PS outage becomes fatal (``PSDeadlineError``); covers one supervised
    #: PS restart.
    ps_reconnect_deadline_s: float = 60.0
    #: Cross-process mode only — payload encoding on the PS wire: "f32"
    #: (exact) or "bf16" (half the bytes; the server stores f32).
    ps_wire_dtype: str = "f32"
    #: Cross-process ASYNC workers only — double-buffer param pulls on a
    #: dedicated connection so the next pull overlaps this step's gradient
    #: (at most one step more staleness; sync mode never prefetches).
    ps_prefetch: bool = True
    #: Cross-process mode only — workers heartbeat a membership lease on
    #: the coordinator shard (``parallel/membership.py``), renewed at ttl/3.
    membership_leases: bool = True
    lease_ttl_s: float = 10.0
    #: Live resharding: whether the chief ADOPTS a pending layout epoch
    #: announced on the coordinator (shard tasks started with
    #: ``--ps_reshard_to``), and whether workers follow committed epochs.
    reshard_watch: bool = True
    #: Epoch-poll cadence of every follower (the chief's pending poll, a
    #: worker's committed poll); each unchanged poll is one O(header) trip.
    reshard_poll_s: float = 0.5
    #: How long the chief waits for every new-layout shard to present a
    #: synced snapshot before ABORTING the transition (a joiner killed
    #: mid-transition fails this probe and the old topology serves on).
    reshard_ready_timeout_s: float = 60.0
    #: How long a retired layout's servers wait out their remaining client
    #: connections before they stop anyway.
    reshard_drain_s: float = 20.0
    #: The tenant this run belongs to: its PS objects live under the
    #: tenant's key namespace and its leases are tenant-scoped ("default"
    #: = untagged, byte-identical frames).
    tenant: str = "default"


def _loss_and_grads(loss_fn, params, wrt, model_state, batch, rng, device):
    """The loss (read on the host, which waits for the backward) and the
    gradient of the numpy ``batch`` at ``params``, one tensor per leaf of
    ``wrt`` (the leaves of ``params``)."""
    loss, _aux = loss_fn(params, model_state, to_device(batch, device), rng)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, grads)]
    return float(loss.detach()), grads


def _flat_to_host(grads: list) -> np.ndarray:
    """A gradient as one flat float32 host array in leaf order (one
    device-to-host copy, into pinned memory on a GPU)."""
    flat = torch.cat([g.detach().reshape(-1).float() for g in grads])
    host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=flat.is_cuda)
    host.copy_(flat)
    return host.numpy()


def _device_tree(unflatten, flat, device):
    """The parameter tree of the flat vector ``flat`` on ``device``, its
    leaves views of one buffer that take gradients: (tree, leaves)."""
    tree = unflatten(flat, device)
    return tree, [leaf.requires_grad_(True) for leaf in leaves(tree)]


class AsyncPSTrainer:
    """Host-hosted parameters ("PS role"), device-computed gradients, native
    accumulator/token coordination.

    ``loss_fn(params, model_state, batch, rng) -> (loss, (model_state,
    metrics))`` is the framework-standard callable; ``optimizer`` one of
    ``train/optim.py``'s; ``init_params`` a tree of numpy arrays or tensors;
    ``seed`` the run's key (worker w's step i draws from
    ``fold_in(fold_in(key(seed), w), i)``).  ``run(batch_fns)`` takes one
    iterator of numpy batches per worker (the per-worker data shard).
    """

    def __init__(
        self,
        cfg: AsyncPSConfig,
        loss_fn: Callable,
        optimizer,
        init_params: Any,
        *,
        model_state: Any = None,
        seed: int = 0,
        device=None,
    ):
        if cfg.mode not in ("async", "sync_replicas"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        self.cfg = cfg
        self.optimizer = optimizer
        self.device = device_lib.resolve(device)
        self.seed = int(seed)
        self._loss_fn = loss_fn

        self.num_elems, self._unflatten = flat_param_spec(init_params)
        self._master = torch.empty(
            self.num_elems, dtype=torch.float32, pin_memory=self.device.type == "cuda"
        )
        self._master.copy_(torch.from_numpy(flat_params_of(init_params)))
        #: The host master copy as the parameter tree (views of one buffer).
        self.params = self._unflatten(self._master)
        self._param_leaves = leaves(self.params)
        self.opt_state = optimizer.init(self.params)
        self.model_state = as_state_leaves(model_state if model_state is not None else {},
                                           self.device)
        self.global_step = 0
        self._params_lock = threading.Lock()
        self._stop = threading.Event()
        self.history: list[tuple[int, int, float]] = []  # (worker, local_step, loss)
        #: Fixed-interleave only: (wid, computed_at, applied_at, dropped)
        #: per scheduled gradient — the apply-time staleness evidence.
        self.apply_log: list[tuple[int, int, int, bool]] = []
        self._history_lock = threading.Lock()
        self.total_dropped = 0
        #: Duplicate replays suppressed by the (worker, seq) dedup tables —
        #: 0 in one process, where no op is ever replayed.
        self.total_deduped = 0
        self._worker_excs: list[tuple[int, BaseException]] = []

        self._acc = self._gq = None
        if cfg.mode == "sync_replicas":
            # One FLAT accumulator: whole-gradient applies are atomic.
            self._acc = native.GradientAccumulator(self.num_elems)
        else:
            self._gq = native.GradientQueue(
                self.num_elems, capacity=max(4, 2 * cfg.num_workers)
            )
        self._tq = native.TokenQueue()
        self._ckpt = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self._publish(0)

    def _publish(self, step: int) -> None:
        """Copy the master vector to the device and make it, with ``step``,
        the snapshot workers read (the copy completes before this returns,
        so the next apply may write the master again)."""
        tree, grad_leaves = _device_tree(
            self._unflatten, self._master.to(self.device, copy=True), self.device)
        with self._params_lock:
            self._snap = (tree, grad_leaves, step)
            self.global_step = step

    # -- worker side ---------------------------------------------------------

    def _snapshot(self):
        with self._params_lock:
            return self._snap

    def _rng(self, wid: int, it: int):
        return threefry.fold_in(threefry.fold_in(threefry.key(self.seed), wid), it)

    def _grad(self, params, wrt, batch, rng) -> tuple[float, list]:
        return _loss_and_grads(self._loss_fn, params, wrt, self.model_state, batch, rng,
                               self.device)

    def _to_host(self, grads: list) -> np.ndarray:
        return _flat_to_host(grads)

    def _send(self, local_step: int, flat: np.ndarray) -> None:
        if self._acc is not None:
            self._acc.apply(local_step, flat)
        else:
            self._gq.push(local_step, flat)

    def _worker(self, wid: int, batches: Iterator):
        """Thread wrapper: a worker crash must not strand the chief in a
        blocking ``acc.take()``/``gq.pop()`` — record, cancel, re-raise from
        ``run()`` (the reference surfaced worker errors through sess.run)."""
        try:
            self._worker_body(wid, batches)
        except BaseException as e:  # noqa: BLE001 — propagated via run()
            self._worker_excs.append((wid, e))
            self._stop.set()
            self._cancel_services()

    def _cancel_services(self) -> None:
        for service in (self._tq, self._acc, self._gq):
            if service is not None:
                service.cancel()

    def _worker_body(self, wid: int, batches: Iterator):
        it = 0
        while not self._stop.is_set():
            if self.cfg.mode == "sync_replicas":
                token = self._tq.pop()
                if token is None:
                    return
                local_step = token
            else:
                local_step = None  # read after snapshot
            params, wrt, snap_step = self._snapshot()
            if local_step is None:
                local_step = snap_step
            try:
                batch = next(batches)
            except StopIteration:
                return
            loss, grads = self._grad(params, wrt, batch, self._rng(wid, it))
            with self._history_lock:
                self.history.append((wid, local_step, loss))
            self._send(local_step, self._to_host(grads))
            it += 1

    # -- chief / updater side ------------------------------------------------

    def _apply_update(self, flat: np.ndarray) -> None:
        """Update number ``global_step`` of the host master copy with the
        flat gradient ``flat``, then publish the next step's snapshot."""
        grads = leaves(self._unflatten(torch.from_numpy(flat)))
        for p, g in zip(self._param_leaves, grads):
            p.grad = g
        self.optimizer.update(self.opt_state, self.params, self.global_step)
        for p in self._param_leaves:
            p.grad = None
        self._publish(self.global_step + 1)

    def _take(self, n_agg: int):
        return self._acc.take(n_agg)

    def _pop(self):
        return self._gq.pop()

    def _chief_sync(self):
        n_agg = self.cfg.replicas_to_aggregate or self.cfg.num_workers
        self._acc.set_global_step(self.global_step)
        self._tq.push(self.global_step, self.cfg.num_workers)
        while self.global_step < self.cfg.train_steps:
            out = self._take(n_agg)
            if out is native.TIMED_OUT:
                # The socket chief's stall re-push (RemotePSChief): a token
                # or a drained average lost to a connection drop turns into
                # a delay, not a deadlock.
                faults.log_event("sync_stall_repush", step=self.global_step, n_agg=n_agg)
                self._tq.push(self.global_step, self.cfg.num_workers)
                continue
            if out is None:
                return
            # No gradient of this step may join the next average.
            self._acc.set_global_step(self.global_step + 1)
            self._apply_update(out)
            self._maybe_checkpoint()
            if self.global_step < self.cfg.train_steps:
                self._tq.push(self.global_step, self.cfg.num_workers)

    def _chief_async(self):
        # Each gradient applies individually, in arrival order — the W2
        # semantics (no coalescing; see module docstring).
        while self.global_step < self.cfg.train_steps:
            item = self._pop()
            if item is native.TIMED_OUT:  # the socket chief's bounded pop
                continue
            if item is None:
                return
            _, flat = item
            self._apply_update(flat)
            if self.cfg.max_staleness is not None:
                self._gq.set_min_step(self.global_step - self.cfg.max_staleness)
            self._maybe_checkpoint()

    # -- checkpoint/resume (section 5.4) --------------------------------------

    def _ckpt_state(self) -> TrainState:
        return TrainState(step=self.global_step, params=self.params, opt_state=self.opt_state,
                          model_state=self.model_state, seed=self.seed)

    def _maybe_checkpoint(self) -> None:
        # <=1 (incl. the CheckpointSaverHook convention of 0) = every step.
        every = max(1, self.cfg.checkpoint_every)
        if self.cfg.ckpt_dir and self.global_step % every == 0:
            self.save_checkpoint()

    def save_checkpoint(self) -> None:
        """Synchronous save of params + opt_state + step (chief thread only;
        ``train/checkpoint.py``: written aside, then renamed into place)."""
        self._ckpt.save(self.global_step, self._ckpt_state())

    def restore_latest(self) -> bool:
        """Restore newest checkpoint under ``cfg.ckpt_dir`` if any; returns
        whether a restore happened.  ``run()`` calls this automatically."""
        restored = self._ckpt.restore_latest(self._ckpt_state()) if self._ckpt else None
        if restored is None:
            return False
        self.model_state = as_state_leaves(restored.model_state, self.device)
        self._publish(restored.step)
        log.info("async-PS resumed from step %d", self.global_step)
        return True

    # -- run -----------------------------------------------------------------

    def _run_async_fixed(self, batch_fns: list[Iterator]) -> Any:
        """Deterministic async schedule (cfg.fixed_interleave): one pending
        gradient per worker, applied round-robin — each apply uses a
        gradient computed while the other workers' applies advanced the
        params, i.e. genuinely STALE (staleness ~ num_workers-1), but the
        order is fixed, so two runs produce bitwise-identical params.
        ``apply_log`` records (wid, computed_at, applied_at, dropped) for
        every scheduled gradient.  No native service is involved: pending
        gradients stay on the device until their apply."""
        n = self.cfg.num_workers
        if self.cfg.max_staleness is not None and self.cfg.max_staleness < n - 1:
            # Steady-state staleness of the rotation IS n-1; a tighter bound
            # would deterministically drop the SAME trailing workers' every
            # gradient — silent 100% starvation, unlike thread mode where
            # random interleaving makes drops transient.
            raise ValueError(
                f"fixed_interleave with max_staleness="
                f"{self.cfg.max_staleness} < num_workers-1={n - 1} would "
                "starve trailing workers deterministically; raise the bound "
                "or drop --deterministic"
            )
        its = [0] * n
        pending: list[tuple[int, int, list]] = []

        def compute(wid: int) -> bool:
            try:
                batch = next(batch_fns[wid])
            except StopIteration:
                return False
            params, wrt, step = self._snapshot()
            loss, grads = self._grad(params, wrt, batch, self._rng(wid, its[wid]))
            self.history.append((wid, step, loss))
            pending.append((wid, step, grads))
            its[wid] += 1
            return True

        for w in range(n):
            compute(w)
        while self.global_step < self.cfg.train_steps and pending:
            wid, local_step, grads = pending.pop(0)
            # Apply-time staleness is bounded by n-1 and the guard above
            # requires max_staleness >= n-1, so this schedule never drops.
            self.apply_log.append((wid, local_step, self.global_step, False))
            self._apply_update(self._to_host(grads))
            self._maybe_checkpoint()
            compute(wid)
        if self.cfg.ckpt_dir:
            self.save_checkpoint()
        log.info("async-PS fixed-interleave run done: %d applied steps", self.global_step)
        return self.params

    def run(self, batch_fns: list[Iterator]) -> Any:
        """Train to ``train_steps`` applied updates; returns the final
        params (the host master copy's tree)."""
        if len(batch_fns) != self.cfg.num_workers:
            raise ValueError(
                f"need {self.cfg.num_workers} batch iterators, got {len(batch_fns)}"
            )
        self.restore_latest()
        if self.global_step >= self.cfg.train_steps:
            return self.params
        if self.cfg.mode == "async" and self.cfg.fixed_interleave:
            return self._run_async_fixed(batch_fns)
        workers = [
            threading.Thread(target=self._worker, args=(i, batch_fns[i]), daemon=True,
                             name=f"ps-worker-{i}")
            for i in range(self.cfg.num_workers)
        ]
        for w in workers:
            w.start()
        try:
            if self.cfg.mode == "sync_replicas":
                self._chief_sync()
            else:
                self._chief_async()
        finally:
            self._stop.set()
            self._cancel_services()
            for w in workers:
                w.join(timeout=10)
        if self._worker_excs:
            wid, exc = self._worker_excs[0]
            raise RuntimeError(f"async-PS worker {wid} failed") from exc
        if self.cfg.ckpt_dir:
            self.save_checkpoint()
        service = self._acc if self._acc is not None else self._gq
        self.total_dropped = service.dropped
        self.total_deduped = service.deduped
        log.info(
            "async-PS run done: %d applied steps, %d stale grads dropped",
            self.global_step,
            self.total_dropped,
        )
        return self.params


# ----------------------------------------------------------------------------
# Cross-process mode: the same emulation over native/ps_server.cc
# ----------------------------------------------------------------------------


def _client_kw(cfg: AsyncPSConfig) -> dict:
    return dict(op_timeout_s=cfg.ps_op_timeout_s,
                reconnect_deadline_s=cfg.ps_reconnect_deadline_s, wire_dtype=cfg.ps_wire_dtype,
                tenant=cfg.tenant)


def _replica_major_list(replica_addrs) -> list[tuple[str, int]]:
    """A pool's per-shard replica lists back in the flat replica-major order
    (replica r of shard i at entry ``r * shards + i``)."""
    return [a for rl in zip(*replica_addrs) for a in rl] if replica_addrs else []


class RemotePSChief(AsyncPSTrainer):
    """Chief PROCESS of the socket emulation: the host-side apply of
    :class:`AsyncPSTrainer`, publishing each step to the param store of the
    PS service, and the chief loop against EXTERNAL worker processes
    running :func:`remote_worker_loop` (:meth:`run_chief`).

    ``ps_addrs``: the PS shard servers (``--job_name=ps`` processes running
    :func:`host_ps_task`), replica-major when ``ps_replicas=2`` (shards * 2
    entries: the primaries, then the backups); the chief signals
    ``ps_shutdown`` to every one of them when training ends, so the PS
    tasks exit 0.  Without it the chief hosts the servers in-process, one
    per entry of ``ports`` (0 = ephemeral; ``port`` is the one-server
    shorthand, ``--ps_tasks=0``), and pairs each shard's two replicas
    itself.  ``listen_all`` binds them on all interfaces (unauthenticated:
    trusted networks only).  ``layout_version`` pins every connection to
    the shard-topology epoch.  Step tokens stay on shard 0 (the
    coordinator).

    Fault posture: each shard's client carries per-op deadlines and a
    reconnect budget; a replicated shard fails over to its backup inside
    that client, with no reseed.  When a reconnect lands on a NEW, empty
    server incarnation (every replica of the shard lost its state) the
    chief reseeds THAT shard (:meth:`_reseed_ps_state`): republishes its
    slice of the params, restores its accumulator's step or the queue's
    staleness floor, and re-pushes the step's tokens if it is the
    coordinator.  A sync ``take`` stalled for ``sync_stall_repush_s``
    re-pushes the step's tokens (a token or a drained average lost to a
    drop becomes a delay, not a deadlock).

    Live resharding: between two applies the chief polls the coordinator's
    PENDING record and adopts it (:meth:`_adopt_record`);
    :meth:`reshard_to` starts the next layout's servers of the chief-hosted
    topology itself."""

    sync_stall_repush_s = 30.0
    #: The bounded gradient pop of the async loop (between two of its
    #: reshard-record polls).
    async_pop_s = 2.0

    def __init__(self, cfg, loss_fn, optimizer, init_params, *, port: int = 0,
                 ports: list[int] | None = None,
                 ps_addrs: list[tuple[str, int]] | None = None, listen_all: bool = False,
                 ps_replicas: int = 1, layout_version: int = 0, **kw):
        from . import ps_service, ps_shard

        #: Chief reseeds performed (the last-resort path): zero across a
        #: primary kill with replicas, and across a whole live reshard.
        self.reseeds = 0
        #: Committed layout-epoch transitions this chief performed, and the
        #: applied step at each.
        self.reshards = 0
        self.reshard_steps: list[int] = []
        #: Per applied step: the take or pop's wait, the host update +
        #: publish's ms, and when it ended.
        self.wait_ms: list[float] = []
        self.apply_ms: list[float] = []
        self.apply_done: list[float] = []
        self.ps_replicas = int(ps_replicas)
        self._role = faults.current_role() or "chief0"
        self._client_kw = _client_kw(cfg)
        self._owns_server = ps_addrs is None
        self._listen_all = listen_all
        if self._owns_server:
            all_ports = list(ports) if ports else [port]
            n = len(all_ports) // self.ps_replicas
            bound = [
                ps_service.start_server(
                    p, loopback_only=not listen_all, shard_id=i % n, shard_count=n,
                    layout_version=layout_version)
                for i, p in enumerate(all_ports)
            ]
            if self.ps_replicas > 1:
                # Ephemeral ports force start-then-pair: wire each shard's two
                # cold servers as peers, then have the backup adopt the
                # primary's state TOKEN through one REPL_SYNC (both are empty,
                # but the pair must share one state lineage, or the first
                # failover would read the backup as a state loss).
                for primary, backup in ps_shard.replica_major(bound, n, self.ps_replicas):
                    ps_service.set_server_peer(primary, ("127.0.0.1", backup))
                    ps_service.set_server_peer(backup, ("127.0.0.1", primary))
                    ps_service.resync_server(backup, wait_s=10.0)
            #: Every in-process server this chief hosts now (all replicas).
            self.owned_ports = bound
            ps_addrs = [("127.0.0.1", p) for p in bound]
        n = len(ps_addrs) // self.ps_replicas
        #: The primaries' ports, shard order.
        self.ports = [p for _, p in ps_addrs[:n]]
        self.port = self.ports[0]
        self._group = ps_shard.ShardedPSClients(
            ps_addrs, role=self._role, replicas=self.ps_replicas,
            layout_version=layout_version, **self._client_kw)
        self._layout = self._group.layout_for(flat_param_spec(init_params)[0])
        # Before the base constructor, which publishes step 0 through it.
        self._pstore = ps_shard.ShardedParamStore(self._group, "params", self._layout)
        self._next_reshard_poll = 0.0
        self._drain_threads: list[threading.Thread] = []
        super().__init__(cfg, loss_fn, optimizer, init_params, **kw)
        # The socket proxies of the base's in-process services: the chief
        # drives the same transport as the workers.
        self._acc, self._gq = self._make_services(self._group, self._layout)
        self._tq = ps_service.RemoteTokenQueue(self._group.coordinator, "tokens")
        self._watch_reincarnations(self._group)

    def _make_services(self, group, layout):
        from . import ps_shard

        if self.cfg.mode == "sync_replicas":
            return ps_shard.ShardedAccumulator(group, "acc", layout), None
        return None, ps_shard.ShardedGradientQueue(
            group, "gq", layout, capacity=max(4, 2 * self.cfg.num_workers))

    def _watch_reincarnations(self, group) -> None:
        for i, c in enumerate(group.clients):
            c.on_reincarnation(lambda i=i: self._reseed_ps_state(i))

    @property
    def layout_version(self) -> int:
        return self._layout.version

    # -- the base loops' hooks -------------------------------------------------

    def _publish(self, step: int) -> None:
        """Publish the host master copy as step ``step`` to the PS param
        store (the workers pull it from there)."""
        self.global_step = step
        self._pstore.set(step, self._master.numpy())

    def _apply_update(self, flat: np.ndarray) -> None:
        t0 = time.perf_counter()
        super()._apply_update(flat)
        self.apply_done.append(time.perf_counter())
        self.apply_ms.append((self.apply_done[-1] - t0) * 1e3)

    def _take(self, n_agg: int):
        self._reshard_tick()
        t0 = time.perf_counter()
        out = self._acc.take(n_agg, timeout_s=self.sync_stall_repush_s)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def _pop(self):
        self._reshard_tick()
        t0 = time.perf_counter()
        out = self._gq.pop(timeout_s=self.async_pop_s)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    # -- live resharding: the chief's side of the epoch transition ------------

    def _reshard_tick(self) -> None:
        """Adopt a PENDING layout epoch announced on the coordinator,
        time-gated to one O(header) poll per ``cfg.reshard_poll_s``.  Runs
        between two applies of either loop: the swap happens at a quiescent
        point of the chief's own state, never mid-gather."""
        from . import ps_service, reshard

        if not self.cfg.reshard_watch:
            return
        now = time.monotonic()
        if now < self._next_reshard_poll:
            return
        self._next_reshard_poll = now + self.cfg.reshard_poll_s
        try:
            rec = reshard.poll_pending(self._group.coordinator)
        except (ps_service.PSError, OSError, ValueError):
            return  # the coordinator is failing over: poll again next tick
        if rec is None or rec["version"] <= self._layout.version:
            return
        self._adopt_record(rec)

    def _adopt_record(self, rec: dict) -> bool:
        """Verify -> republish -> commit -> swap -> drain: the whole epoch
        transition, driven by one pending record.  Returns True when the new
        layout was committed; a failed verify ABORTS the pending record
        loudly and keeps the old topology serving (a transition completes
        or aborts, never half-applies)."""
        from . import ps_service, ps_shard, reshard

        version, total = rec["version"], self.num_elems
        faults.log_event("reshard_adopting", version=version, shards=rec["shards"],
                         step=self.global_step)
        if rec["num_elems"] != total:
            log.error("reshard v%d names %d elems but this run trains %d: aborting the "
                      "transition", version, rec["num_elems"], total)
            self._reshard_abort(version)
            return False
        # VERIFY: dial every new shard (epoch-pinned HELLO) and wait for a
        # synced snapshot.  A joiner killed mid-transition fails here.
        new_group = None
        try:
            new_group = ps_shard.ShardedPSClients.for_record(
                rec, role=self._role, **self._client_kw)
            new_layout = new_group.layout_for(total)
            new_pstore = ps_shard.ShardedParamStore(new_group, "params", new_layout)
            deadline = time.monotonic() + self.cfg.reshard_ready_timeout_s
            while new_pstore.get()[0] < 0:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"new layout v{version} never presented a synced snapshot within "
                        f"{self.cfg.reshard_ready_timeout_s}s")
                time.sleep(0.1)
            # Republish the CURRENT params at the CURRENT step onto the new
            # layout: the swap must never serve the step the joiners synced at.
            new_pstore.set(self.global_step, self._master.numpy())
            # The coordination objects on the new topology; the dedup tag
            # space re-scopes with them (fresh servers, fresh tables).
            new_tq = ps_service.RemoteTokenQueue(new_group.coordinator, "tokens")
            new_acc, new_gq = self._make_services(new_group, new_layout)
            if new_acc is not None:
                new_acc.set_global_step(self.global_step)
            elif self.cfg.max_staleness is not None:
                new_gq.set_min_step(self.global_step - self.cfg.max_staleness)
            # Plant the record on the NEW coordinator too, so late or
            # restarted members discover the committed topology from either end.
            blob = reshard.pack_record(
                version, rec["addrs"], total, replicas=rec["replicas"],
                from_version=rec["from"]["version"], from_addrs=rec["from"]["addrs"],
                from_replicas=rec["from"]["replicas"])
            new_group.coordinator.reshard_announce(version, blob)
            new_group.coordinator.reshard_commit(version)
        except Exception as e:  # noqa: BLE001 — abort, keep the old topology
            log.error("reshard v%d failed verification: %s", version, e)
            faults.log_event("reshard_aborted", version=version, error=type(e).__name__)
            telemetry.REGISTRY.inc("ps_chief/reshard_aborts")
            if new_group is not None:
                new_group.close()
            self._reshard_abort(version)
            return False
        # COMMIT on the old coordinator: every polling client now swaps.
        old_group, old_layout = self._group, self._layout
        old_replica_addrs = _replica_major_list(old_group.replica_addrs)
        try:
            old_group.coordinator.reshard_commit(version)
        except Exception:  # noqa: BLE001
            # The old coordinator died at the worst moment: the new topology
            # is already committed on its own coordinator, so finish the
            # swap; old clients heal through their own recovery paths.
            log.exception("old-coordinator commit failed; swapping anyway")
        # SWAP the chief's own state.
        self._group, self._layout = new_group, new_layout
        self._pstore, self._tq = new_pstore, new_tq
        self._acc, self._gq = new_acc, new_gq
        if new_acc is not None and self.global_step < self.cfg.train_steps:
            self._tq.push(self.global_step, self.cfg.num_workers)
        self._watch_reincarnations(new_group)
        self.reshards += 1
        self.reshard_steps.append(self.global_step)
        telemetry.REGISTRY.inc("ps_chief/reshards")
        faults.log_event("reshard_committed", version=version, shards=rec["shards"],
                         step=self.global_step)
        # DRAIN the old layout: one round of tokens on the OLD queue unblocks
        # a sync worker parked in a token pop, so its next iteration polls the
        # epoch and swaps; cancel every waiter parked on the old layout; close
        # our own legs (they must not hold the drain open); then retire the
        # old servers.
        if self.cfg.mode == "sync_replicas":
            try:
                ps_service.RemoteTokenQueue(old_group.coordinator, "tokens").push(
                    self.global_step, self.cfg.num_workers)
            except Exception:  # noqa: BLE001 — the old coordinator may be gone
                pass
        try:
            old_group.cancel_all()
        except Exception:  # noqa: BLE001
            pass
        old_group.fail_fast()
        old_group.close()
        self._drain_old_layout(old_layout, old_replica_addrs)
        return True

    def _reshard_abort(self, version: int) -> None:
        try:
            self._group.coordinator.reshard_abort(version)
        except Exception:  # noqa: BLE001 — best effort; the record may be gone
            log.exception("reshard abort signal failed")

    def _drain_old_layout(self, old_layout, old_replica_addrs) -> None:
        """Retire the old layout's servers: in-process ones (the chief-hosted
        topology) stop once their connections drain; external tasks get the
        DRAIN shutdown token (``ps_shutdown`` value 1: ``host_ps_task``
        flags itself draining, waits out its clients and exits 0)."""
        from . import ps_service

        self.ports = [p for _, p in self._group.addrs]
        self.port = self.ports[0]
        if self._owns_server:
            old_ports = list(self.owned_ports)
            self.owned_ports = [p for _, p in _replica_major_list(self._group.replica_addrs)]

            def _drain() -> None:
                for p in old_ports:
                    ps_service.set_server_draining(p, True)
                deadline = time.monotonic() + self.cfg.reshard_drain_s
                while time.monotonic() < deadline and any(
                        ps_service.server_live_conns(p) > 0 for p in old_ports):
                    time.sleep(0.2)
                for p in old_ports:
                    ps_service.stop_server(p)
                faults.log_event("reshard_old_stopped", ports=old_ports)

            t = threading.Thread(target=_drain, daemon=True, name="dtx-reshard-drain")
            t.start()
            self._drain_threads.append(t)
            return
        for h, p in old_replica_addrs:
            try:
                c = ps_service.PSClient(h, p, timeout_s=5.0)
                try:
                    ps_service.RemoteTokenQueue(c, "ps_shutdown").push(1)
                finally:
                    c.close()
            except Exception:  # noqa: BLE001
                log.info("drain signal not delivered to %s:%d", h, p)

    def reshard_to(self, new_shards: int, ports: list[int] | None = None,
                   adopt: bool = False) -> bool:
        """In-process N -> M reshard of the chief-hosted topology: start
        ``new_shards`` fresh in-process servers on the next layout epoch,
        sync their slices from the live old layout over ranged REPL_SYNC,
        and ANNOUNCE the transition on the coordinator; the chief loop's own
        ``_reshard_tick`` adopts it at its next quiescent point (callable
        from any thread while training runs).  ``adopt=True`` runs the
        adoption inline instead, only safe when the chief loop is NOT
        running.  External clusters never call this: their joiners are
        ``--ps_reshard_to`` tasks, whose pending record the chief adopts."""
        from . import ps_service, reshard

        if not self._owns_server:
            raise RuntimeError(
                "reshard_to() drives the chief-hosted topology only; external clusters "
                "start --ps_reshard_to tasks instead")
        old_version = self._layout.version
        version = max(old_version, 0) + 1
        ports = list(ports) if ports else [0] * new_shards
        bound = [
            ps_service.start_server(p, loopback_only=not self._listen_all, shard_id=j,
                                    shard_count=new_shards, layout_version=version)
            for j, p in enumerate(ports)
        ]
        new_addrs = [("127.0.0.1", p) for p in bound]
        meta = reshard.discover_old_layout(self._group.replica_addrs, old_version=old_version)
        for j, addr in enumerate(new_addrs):
            reshard.install_assembled(
                addr,
                reshard.assemble_for_shard(self._group.replica_addrs, j, new_shards,
                                           old_version=old_version, layout_meta=meta),
                layout_version=version)
        blob = reshard.pack_record(
            version, new_addrs, self.num_elems, from_version=old_version,
            from_addrs=_replica_major_list(self._group.replica_addrs),
            from_replicas=self.ps_replicas)
        self._group.coordinator.reshard_announce(version, blob)
        if adopt:
            return self._adopt_record(reshard.parse_record(blob))
        return True

    # -- fault recovery --------------------------------------------------------

    def _reseed_ps_state(self, shard: int = 0) -> None:
        """Run after a reconnect re-created the (empty) objects on a
        restarted shard server: push back the volatile state only the chief
        can reconstruct, for THAT shard alone (the other shards' servers,
        and every worker's versioned cache of them, are untouched).  With
        replicas this is the last resort: it fires only when a shard lost
        its state on EVERY replica (the client's state-token check skips it
        otherwise), so ``reseeds`` stays 0 across any single-replica
        incident.  In-flight worker gradients of the old incarnation are
        lost (the reference's stale-drop posture), and re-pushed tokens may
        admit an extra gradient per worker, which the staleness gate drops."""
        self.reseeds += 1
        telemetry.REGISTRY.inc("ps_chief/reseeds")
        faults.log_event("chief_reseed", step=self.global_step, mode=self.cfg.mode,
                         shard=shard)
        self._pstore.set_shard(shard, self.global_step, self._master.numpy())
        if self.cfg.mode == "sync_replicas":
            self._acc.set_global_step_shard(shard, self.global_step)
            if shard == 0 and self.global_step < self.cfg.train_steps:
                self._tq.push(self.global_step, self.cfg.num_workers)
        elif self.cfg.max_staleness is not None:
            self._gq.set_min_step_shard(shard, self.global_step - self.cfg.max_staleness)

    def live_workers(self) -> list[dict]:
        """The live workers per the coordinator's lease registry (empty when
        nobody heartbeats: ``--membership_leases=false``)."""
        from . import membership

        return membership.live_members(self._group.coordinator, "worker",
                                       tenant=self.cfg.tenant)

    # -- run -----------------------------------------------------------------

    def run_chief(self):
        """Run the chief loop against the worker processes; returns the
        final params.  Cancels every blocked waiter at the end, so the
        workers' pending pops return None and they exit; with external PS
        tasks, signals each replica of each shard ``ps_shutdown`` last."""
        from . import ps_service

        self.restore_latest()
        self._publish(self.global_step)
        try:
            if self.global_step < self.cfg.train_steps:
                if self.cfg.mode == "sync_replicas":
                    self._chief_sync()
                else:
                    self._chief_async()
        finally:
            # Unblock the workers first and unconditionally: a remote call
            # before cancel_all could raise on a broken transport and strand
            # every worker in a blocking pop.
            try:
                self._publish(self.global_step)  # async workers observe done-ness
            except Exception:
                log.exception("final publish failed")
            try:
                self._group.cancel_all()  # workers may wait on any shard
            except Exception:
                log.exception("cancel_all failed (server already down?)")
            service = self._acc if self.cfg.mode == "sync_replicas" else self._gq
            try:
                self.total_dropped = service.dropped
                self.total_deduped = service.deduped
            except Exception:
                self.total_dropped = self.total_deduped = -1  # transport gone
        if self.cfg.ckpt_dir:
            self.save_checkpoint()
        if not self._owns_server:
            # Release the PS tasks LAST, after the counter reads.  Every
            # replica task of every shard waits on its own server's
            # ps_shutdown queue, and a shard's client may have failed over
            # away from a task that still needs the signal, so each replica
            # ADDRESS gets a direct, short-lived, fail-fast dial (a task may
            # already be gone).
            self._group.fail_fast()
            for host, port in _replica_major_list(self._group.replica_addrs):
                try:
                    c = ps_service.PSClient(host, port, timeout_s=5.0)
                    try:
                        ps_service.RemoteTokenQueue(c, "ps_shutdown").push(0)
                    finally:
                        c.close()
                except Exception:
                    log.info("ps_shutdown not delivered to %s:%d (PS already down)",
                             host, port)
        self._group.close()
        log.info("remote async-PS chief done: %d applied steps, %d stale drops",
                 self.global_step, self.total_dropped)
        n, done = len(self.apply_done), self.apply_done
        log.info("PS_CHIEF_STATS %s", json.dumps({
            "device": str(self.device), "applied": self.global_step,
            "stale_dropped": self.total_dropped, "deduped": self.total_deduped,
            "reseeds": self.reseeds, "reshards": self.reshards,
            "reshard_steps": self.reshard_steps,
            "layout_version": self.layout_version, "shards": self._layout.num_shards,
            "replicas": self.ps_replicas,
            "median_apply_ms": float(np.median(self.apply_ms)) if n else None,
            "median_wait_ms": float(np.median(self.wait_ms)) if self.wait_ms else None,
            # The second half of the run's applies, clear of start-up.
            "applies_per_s_second_half": (n - n // 2) / (done[-1] - done[n // 2 - 1])
            if n >= 4 else None,
            # When each apply ended (s from the first), for gap analyses.
            "apply_done_s": [round(t - done[0], 6) for t in done] if n else [],
            **_wire_bytes(), **_hand_kernel_launches(),
        }))
        return self.params

    def close(self) -> None:
        """Stop the in-process servers (``--ps_tasks=0``) once the run's
        last reader is done with them."""
        from . import ps_service

        if self._owns_server:
            for t in self._drain_threads:
                t.join(timeout=self.cfg.reshard_drain_s + 5.0)
            for p in self.owned_ports:
                ps_service.stop_server(p)


def host_ps_task(
    port: int, *, loopback_only: bool = True, shard_id: int = 0, shard_count: int = 1,
    layout_version: int = 0, peer: tuple[str, int] | None = None, peer_role: str = "",
    sync_wait_s: float = 0.0, coordinator_addrs: list[tuple[str, int]] | None = None,
    reshard_from: dict | None = None, lease_ttl_s: float = 10.0,
    drain_timeout_s: float = 20.0,
) -> int:
    """Dedicated PS-task body (``--job_name=ps``): host the C++ state
    service on ``port`` and block until the chief signals ``ps_shutdown``
    (the analog of ``server.join()``, except that it RETURNS when training
    ends).  Returns the bound port.  A host-only process: it never touches
    the card.

    (``shard_id``, ``shard_count``) and ``layout_version`` are the task's
    shard identity, HELLO-validated on every shard-aware connection.
    ``peer`` names the other replica of the same shard: the start pulls its
    full state (REPL_SYNC, bounded by ``sync_wait_s``) before serving, so a
    supervised RESTART rejoins with the survivor's state and state token
    (clients reconnect without any chief reseed), and state-mutating ops
    forward to it while serving.  ``peer_role`` (the peer task's fault
    role) arms ``partition`` fault specs.

    Arms the process's ``die`` fault specs off the server's request counter
    (forwarded mirror traffic counts too); under ``--ps_restarts`` a
    supervisor restarts the task and the clients reconnect into the fresh
    incarnation.  A supervised child exits when its supervisor dies rather
    than serve on as an orphan.

    ``reshard_from`` makes the task a JOINER of a layout-epoch transition
    (``--ps_reshard_to``): before serving it assembles its slice of every
    param-store object from the OLD layout, installs it, announces the
    transition as the old coordinator's PENDING record, and heartbeats a
    ``psv<V>s<j>`` lease (kind "ps") on the NEW coordinator.  Keys:
    ``addrs`` (the old replica-major list), ``shards``/``replicas``/
    ``version`` (the old topology), ``new_addrs`` (the target topology;
    this task serves entry ``shard_id``), ``wait_published_s``.

    A replicated task exits 0 on its own when its peer is gone and no client
    is connected for ~20 s (an orphan restarted after the run), or when its
    peer is alive but neither has a client, the registry at
    ``coordinator_addrs`` shows no live non-PS member and no pending record
    claims it for ~60 s (the idle pair after a double restart).  A DRAIN
    shutdown (token 1) waits out the remaining clients for up to
    ``drain_timeout_s``."""
    import socket

    from . import membership, ps_service, reshard
    from .ps_shard import replica_major

    bound = ps_service.start_server(
        port, loopback_only=loopback_only, shard_id=shard_id, shard_count=shard_count,
        layout_version=layout_version, peer=peer, sync_wait_s=sync_wait_s)
    heartbeat = None
    if reshard_from is not None:
        old_replicas = int(reshard_from.get("replicas") or 1)
        old_version = int(reshard_from.get("version") or 0)
        old_addrs = list(reshard_from["addrs"])
        new_addrs = list(reshard_from["new_addrs"])
        old_by_shard = replica_major(old_addrs, int(reshard_from.get("shards") or 1),
                                     old_replicas)
        try:
            meta = reshard.join_new_shard(
                ("127.0.0.1", bound), shard_id, shard_count, layout_version, old_by_shard,
                old_version=old_version,
                wait_published_s=float(reshard_from.get("wait_published_s") or 60.0))
        except (ConnectionError, OSError) as e:
            # A joiner RESTARTED after the commit finds the old tier drained:
            # if its own topology is already committed, serve empty (the
            # chief's reincarnation path reseeds this shard); anything else
            # is a failed join and fails the task loudly.
            committed = 0
            try:
                probe = ps_service.PSClient(new_addrs[0][0], new_addrs[0][1], timeout_s=5.0)
                try:
                    committed, _ = probe.reshard_poll(0)
                finally:
                    probe.close()
            except Exception:  # noqa: BLE001
                pass
            if committed != layout_version:
                ps_service.stop_server(bound)
                raise
            log.warning("reshard joiner shard %d: old layout gone but v%d already "
                        "committed; serving empty, the chief's reseed heals (%s)",
                        shard_id, layout_version, e)
            meta = None
        if meta is not None:
            num_elems = meta["num_elems"].get(
                "params", max(meta["num_elems"].values(), default=0))
            blob = reshard.pack_record(
                layout_version, new_addrs, num_elems, from_version=old_version,
                from_addrs=old_addrs, from_replicas=old_replicas)
            try:
                c = ps_service.PSClient(
                    old_by_shard[0][0][0], old_by_shard[0][0][1], timeout_s=10.0,
                    addrs=old_by_shard[0] if old_replicas > 1 else None)
                try:
                    c.reshard_announce(layout_version, blob)
                finally:
                    c.close()
            except ps_service.PSError as e:
                # Another joiner (or the chief) already moved the record past
                # pending: announce is idempotent only below the commit.
                log.info("reshard announce v%d: %s", layout_version, e)
            faults.log_event("reshard_join_synced", shard=shard_id, version=layout_version,
                             num_elems=num_elems)
        try:
            heartbeat = membership.LeaseHeartbeat(
                [new_addrs[0]], f"psv{layout_version}s{shard_id}", kind="ps",
                addr=f"{new_addrs[shard_id][0]}:{new_addrs[shard_id][1]}", ttl_s=lease_ttl_s)
        except Exception:  # noqa: BLE001 — visibility only, never fatal
            log.warning("reshard joiner lease unavailable", exc_info=True)

    def _partition(spec) -> bool:
        if peer_role and not spec.matches_peer(peer_role):
            return False
        return ps_service.set_server_partitioned(bound, True)

    faults.arm_process_faults(request_count_fn=ps_service.server_request_count,
                              partition_fn=_partition if peer is not None else None)
    log.info("PS task serving on port %d (shard %d/%d, layout v%d%s), incarnation %d "
             "(blocking until chief shutdown)", bound, shard_id, shard_count, layout_version,
             f", peer {peer[0]}:{peer[1]}" if peer else "", ps_service.server_incarnation())
    client = ps_service.PSClient("127.0.0.1", bound, timeout_s=10.0)
    supervised = os.environ.get("DTX_PS_SUPERVISED") == "1"
    ppid0 = os.getppid()
    cancelled = orphan_polls = desert_polls = 0
    # The registry the idle-pair exit consults; created lazily, fail-fast: a
    # scrape failure is no evidence and resets the count.
    desert_client = None
    coord = (coordinator_addrs or [("127.0.0.1", bound)])[0]
    own_addr_in = None
    if reshard_from is not None:
        na = reshard_from["new_addrs"][shard_id]
        own_addr_in = (str(na[0]), int(na[1]))

    def _cluster_deserted() -> bool:
        """True when the coordinator's registry shows NO live non-PS lease
        AND no pending reshard record claims this server; any scrape
        failure answers False."""
        nonlocal desert_client
        try:
            if desert_client is None:
                desert_client = ps_service.PSClient(coord[0], coord[1], timeout_s=2.0)
            if any(m["kind"] != "ps"
                   for m in membership.parse_leases(desert_client.lease_list())):
                return False
            v, blob = desert_client.reshard_poll(0, pending=True)
            if v > 0 and blob:
                addrs = reshard.parse_record(blob)["addrs"]
                if own_addr_in in addrs or ("127.0.0.1", bound) in addrs:
                    return False  # a claimed joiner mid-transition
            return True
        except Exception:  # noqa: BLE001 — registry unreachable: no evidence
            if desert_client is not None:
                desert_client.close()
                desert_client = None
            return False

    try:
        tq = ps_service.RemoteTokenQueue(client, "ps_shutdown")
        while True:
            # Bounded pops keep this thread responsive (fault triggers,
            # signals) and the idle polling a trickle.
            try:
                token = tq.pop(timeout_s=2.0)
            except ps_service.PSError as e:
                if not isinstance(e.__cause__, TimeoutError):
                    raise
                # The server runs in this process, so a pop that outran its
                # socket timeout means this process was starved (a loaded
                # host), not that the service died: dial it again.  Exiting
                # here would restart the replica while its peer may be
                # restarting too, and lose the shard's state (fault C9).  The
                # checks of an idle pop below still run (supervisor gone,
                # orphan, idle pair), and a server that no longer answers
                # fails the dial and ends the task.
                log.warning("PS task: the shutdown watch timed out on its own server "
                            "(%s); reconnecting", e)
                client.close()
                client = ps_service.PSClient("127.0.0.1", bound, timeout_s=10.0)
                tq = ps_service.RemoteTokenQueue(client, "ps_shutdown")
                token = ps_service.TIMED_OUT
            if token is ps_service.TIMED_OUT:
                if supervised and os.getppid() != ppid0:
                    log.warning("PS task: supervisor died; exiting")
                    break
                # A replicated task restarted AFTER training ended can miss
                # the chief's ps_shutdown (its clients failed over to the
                # peer and never came back).  Orphan: the peer is gone and
                # nobody but our own shutdown client is connected.
                if peer is not None and ps_service.server_live_conns(bound) <= 1:
                    try:
                        socket.create_connection(peer, timeout=0.5).close()
                    except OSError:
                        desert_polls = 0
                        orphan_polls += 1
                        if orphan_polls >= 10:
                            log.warning("PS task: peer gone and no clients for ~%ds; "
                                        "orphaned replica exiting", 2 * orphan_polls)
                            break
                        continue
                    orphan_polls = 0
                    # Idle pair: the peer is alive, but neither has a client
                    # and the registry shows the run is over.
                    if _cluster_deserted():
                        desert_polls += 1
                        if desert_polls >= 30:
                            log.warning("PS task: peer alive but no client, no live "
                                        "member lease and no reshard claim for ~%ds; "
                                        "idle replica pair exiting", 2 * desert_polls)
                            break
                    else:
                        desert_polls = 0
                else:
                    orphan_polls = desert_polls = 0
                continue
            if token is not None:
                if token == 1:
                    # DRAIN shutdown: a reshard retired this layout.  Flag
                    # draining, wait out the remaining client connections as
                    # they swap to the new epoch, then exit 0.
                    if heartbeat is not None:
                        heartbeat.close()
                        heartbeat = None
                    ps_service.set_server_draining(bound, True)
                    faults.log_event("ps_draining", port=bound)
                    deadline = time.monotonic() + drain_timeout_s
                    while (time.monotonic() < deadline
                           and ps_service.server_live_conns(bound) > 1):
                        time.sleep(0.2)
                    log.info("PS task: drained (conns=%d); retired layout exiting",
                             ps_service.server_live_conns(bound))
                break
            # cancel_all reaches this queue too (the chief cancels before
            # its final counter reads): give the shutdown push a grace
            # window rather than tear the service down under the chief.
            cancelled += 1
            if cancelled >= 10:
                log.warning("PS task: repeated cancels without shutdown; exiting")
                break
            time.sleep(0.5)
    finally:
        # Every exit releases the lease heartbeat and the clients: a leaked
        # heartbeat would advertise a dead PS task forever.
        if desert_client is not None:
            desert_client.close()
        if heartbeat is not None:
            heartbeat.close()
        client.close()
        ps_service.stop_server(bound)
    return bound


def _await_published(pstore, wait_budget_s: float):
    """Latest published snapshot from ``pstore``, waiting out the window
    where a restarted PS has an empty (step -1) param store until the
    chief's reseed lands; None when the budget expires first."""
    deadline = time.monotonic() + wait_budget_s
    step, flat = pstore.get()
    while step < 0:
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)
        step, flat = pstore.get()
    return step, flat


class ParamPrefetcher:
    """Double-buffered param pulls on a DEDICATED PS connection: while the
    worker computes the gradient for step k, the background thread runs the
    pull for step k+1.

    ``kick()`` starts the next pull if none is pending (idempotent);
    ``get()`` blocks for the pending pull (kicking one if needed),
    re-raising any error the background fetch hit; after an error the
    store's cache is invalidated and the next ``get()`` starts afresh.
    ``None`` from ``get()``: the published snapshot never became valid
    within the wait budget."""

    def __init__(self, client, pstore, *, wait_budget_s: float):
        self._client, self._pstore = client, pstore
        self._wait_budget_s = wait_budget_s
        self._lock = threading.Lock()
        self._want = threading.Event()
        self._have = threading.Event()
        self._pending = False
        self._result: tuple[int, np.ndarray] | None = None
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dtx-ps-prefetch")
        self._thread.start()

    def _loop(self):
        while True:
            self._want.wait()
            self._want.clear()
            if self._closed:
                return
            try:
                r, e = _await_published(self._pstore, self._wait_budget_s), None
            except BaseException as exc:  # noqa: BLE001 — re-raised in get()
                r, e = None, exc
                self._pstore.invalidate_cache()
            with self._lock:
                self._result, self._exc = r, e
            self._have.set()

    def kick(self) -> None:
        with self._lock:
            if self._pending or self._closed:
                return
            self._pending = True
        self._have.clear()
        self._want.set()

    def get(self):
        from . import ps_service

        self.kick()
        # The fetch is bounded by the client's own deadlines plus the
        # unpublished-store wait; the margin guards a wedged thread only.
        if not self._have.wait(timeout=self._wait_budget_s * 2 + 60.0):
            raise ps_service.PSDeadlineError("param prefetch thread stalled")
        with self._lock:
            r, e = self._result, self._exc
            self._result, self._exc = None, None
            self._pending = False
        if e is not None:
            raise e
        return r

    def close(self) -> None:
        self._closed = True
        self._want.set()
        self._client.close()


class _PinnedPull:
    """The pulled flat vector staged in one pinned host buffer and copied to
    the card with one non-blocking copy (a plain copy on the CPU)."""

    def __init__(self, num_elems: int, device: torch.device):
        self.device = device
        self.host = torch.empty(num_elems, dtype=torch.float32,
                                pin_memory=device.type == "cuda")

    def to_device(self, flat: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(flat, np.float32))
        # The previous step's copy out of this buffer finished before its
        # gradient came back to the host, so the buffer is free.
        self.host.copy_(torch.from_numpy(flat))
        return self.host.to(self.device, non_blocking=True)


def remote_worker_loop(
    host: str, port: int, wid: int, *, cfg: AsyncPSConfig, loss_fn: Callable,
    init_fn: Callable, batches: Iterator, model_state: Any = None, seed: int = 0,
    device=None, addrs: list[tuple[str, int]] | None = None, ps_replicas: int = 1,
    layout_version: int = 0, metrics_dir: str | None = None, metrics_every: int = 20,
) -> int:
    """Worker PROCESS body: pull the latest published params, compute a
    gradient on a local batch on ``device`` (the card unless ``cpu``),
    push it (accumulator in sync mode, gradient queue in async mode).
    Returns the number of gradients contributed.

    ``init_fn(seed)`` gives the parameter STRUCTURE (shapes, leaf order);
    values always come from the param store.  Worker ``wid``'s i-th
    gradient draws from ``fold_in(fold_in(key(seed), wid), i)``, as in the
    in-process emulation.  Sync mode pops a token, then pulls the params
    the chief published before pushing it; async mode pulls through a
    :class:`ParamPrefetcher` (``cfg.ps_prefetch``) and stops once the
    published step reaches ``train_steps``.

    ``addrs`` lists the PS shard servers (default the single ``(host,
    port)``), replica-major when ``ps_replicas=2``; pulls and pushes move
    as concurrent per-shard transfers, pinned to ``layout_version``.  The
    clients reconnect (or fail over to a shard's backup) through PS
    outages and their pushes are dedup-tagged with ``wid``; after a PS
    restart that lost a shard's state the worker waits for the chief's
    reseed instead of training on zeros.  A committed live reshard
    rebuilds the worker's whole client side onto the new epoch (new
    pools, a fresh dedup stream, the lease moved to the new coordinator).
    ``metrics_dir`` gets ``ps/pull_ms_shard<i>``/``ps/push_ms_shard<i>``
    scalars every ``metrics_every`` gradients."""
    from . import ps_service, ps_shard, reshard
    from ..utils.metrics import shard_scalars

    dev = device_lib.resolve(device)
    role = faults.current_role() or f"worker{wid}"
    if addrs is None:
        addrs = [(host, port)]
    template = init_fn(seed)
    if isinstance(template, tuple):
        template = template[0]
    total, unflatten = flat_param_spec(template)
    wait_s = max(cfg.ps_reconnect_deadline_s, 5.0)

    class _Epoch:
        """One layout epoch's client side, rebuilt whole on a committed
        reshard: new pools, new layout, fresh dedup-tag streams (the Remote*
        constructors announce ``*_RESET_WORKER`` and restart the sequence),
        so a replayed pre-epoch push can never collide with the new stream."""

        def __init__(self, e_addrs, e_replicas, e_version):
            self.prefetcher = None
            self.group = ps_shard.ShardedPSClients(
                list(e_addrs), role=role, worker_tag=wid, replicas=e_replicas,
                layout_version=e_version, **_client_kw(cfg))
            # Everything past the pool is one transaction: a failed object
            # ensure closes the pools, or a retried swap would leak sockets.
            try:
                self.layout = self.group.layout_for(total)
                self.pstore = self.pull_timing = ps_shard.ShardedParamStore(
                    self.group, "params", self.layout)
                self.tq = ps_service.RemoteTokenQueue(self.group.coordinator, "tokens")
                if cfg.mode == "sync_replicas":
                    self.sink = ps_shard.ShardedAccumulator(self.group, "acc", self.layout)
                else:
                    self.sink = ps_shard.ShardedGradientQueue(
                        self.group, "gq", self.layout, capacity=max(4, 2 * cfg.num_workers))
                    if cfg.ps_prefetch:
                        # Async only: the next snapshot streams on its own
                        # connections while this step's gradient computes.
                        pf_group = ps_shard.ShardedPSClients(
                            list(e_addrs), role=f"{role}_pf", replicas=e_replicas,
                            layout_version=e_version, **_client_kw(cfg))
                        try:
                            pf_store = ps_shard.ShardedParamStore(pf_group, "params",
                                                                  self.layout)
                        except BaseException:
                            pf_group.close()
                            raise
                        self.prefetcher = ParamPrefetcher(pf_group, pf_store,
                                                          wait_budget_s=wait_s)
                        self.pull_timing = pf_store
                # The committed-epoch poll rides the coordinator connection.
                self.follower = reshard.EpochFollower(self.group.coordinator, e_version,
                                                      cfg.reshard_poll_s)
            except BaseException:
                self.close()
                raise

        def close(self):
            if self.prefetcher is not None:
                self.prefetcher.close()
            self.group.close()

    E = _Epoch(addrs, ps_replicas, layout_version)
    heartbeat = writer = None
    contributed = reshards_followed = 0
    by_epoch: dict[str, int] = {}  # layout version -> gradients contributed
    # Everything below runs under one finally: an exception anywhere must
    # still release the lease (a leaked heartbeat advertises a dead worker).
    try:
        if cfg.membership_leases:
            from . import membership

            heartbeat = membership.LeaseHeartbeat(
                E.group.coordinator_replica_addrs, role, kind="worker", ttl_s=cfg.lease_ttl_s,
                role=role, op_timeout_s=cfg.ps_op_timeout_s,
                reconnect_deadline_s=cfg.ps_reconnect_deadline_s, tenant=cfg.tenant)
            # A ``leave`` fault releases the lease on its way out.
            faults.register_leave_hook(heartbeat.close)
        if metrics_dir:
            from ..utils.metrics import MetricsWriter

            writer = MetricsWriter(metrics_dir)
        model_state = as_state_leaves(model_state if model_state is not None else {}, dev)
        staging = _PinnedPull(total, dev)

        def maybe_swap_epoch(force: bool = False) -> bool:
            """Follow a committed reshard: rebuild the epoch's client side
            onto the record's topology; True when a swap happened.  A failed
            rebuild keeps the current epoch serving and retries next poll."""
            nonlocal E, reshards_followed
            if not cfg.reshard_watch:
                return False
            rec = E.follower.poll(force=force)
            if rec is None:
                return False
            if rec["num_elems"] != total:
                log.error("worker %d: reshard v%d names %d elems, this run trains %d; "
                          "ignoring the record", wid, rec["version"], rec["num_elems"], total)
                return False
            old_version = E.layout.version
            try:
                new_e = _Epoch(rec["addrs"], rec["replicas"], rec["version"])
            except (ps_service.PSError, OSError, RuntimeError) as e:
                E.follower.version = old_version  # retry next poll
                faults.log_event("worker_epoch_swap_failed", role=role,
                                 version=rec["version"], error=type(e).__name__)
                return False
            old, E = E, new_e
            old.close()
            reshards_followed += 1
            if heartbeat is not None:
                heartbeat.retarget(E.group.coordinator_replica_addrs)
            faults.log_event("worker_epoch_swapped", role=role, version=rec["version"],
                             shards=E.layout.num_shards)
            return True

        log.info("PS worker %d computing its gradients on %s", wid, dev)
        times = {"token_ms": [], "pull_ms": [], "grad_ms": [], "push_ms": []}
        it = 0
        while True:
            # Every remote call is inside the guard: the chief exiting
            # (socket closed mid-recv) ends the worker cleanly.
            try:
                maybe_swap_epoch()
                t0 = time.perf_counter()
                if cfg.mode == "sync_replicas":
                    token = E.tq.pop()
                    if token is None:
                        # Cancelled: the chief is done, or the OLD layout was
                        # retired under us.  A forced epoch poll tells them
                        # apart: swap and continue, or exit.
                        if maybe_swap_epoch(force=True):
                            continue
                        break
                    local_step = token
                    t1 = time.perf_counter()
                    got = _await_published(E.pstore, wait_s)
                else:
                    t1 = t0
                    got = (E.prefetcher.get() if E.prefetcher
                           else _await_published(E.pstore, wait_s))
                t2 = time.perf_counter()
                if got is None:
                    log.warning("worker %d: no republished params; exiting", wid)
                    break
                step, flat = got
                if cfg.mode != "sync_replicas":
                    if step >= cfg.train_steps:
                        break
                    local_step = max(step, 0)
                    if E.prefetcher:
                        E.prefetcher.kick()  # the next pull under this gradient
            except (ps_service.PSError, ConnectionError, OSError):
                break
            params, wrt = _device_tree(unflatten, staging.to_device(flat), dev)
            try:
                batch = next(batches)
            except StopIteration:
                break
            rng = threefry.fold_in(threefry.fold_in(threefry.key(seed), wid), it)
            _loss, grads = _loss_and_grads(loss_fn, params, wrt, model_state, batch, rng, dev)
            flat_g = _flat_to_host(grads)
            t3 = time.perf_counter()
            try:
                if cfg.mode == "sync_replicas":
                    E.sink.apply(local_step, flat_g)
                elif E.sink.push(local_step, flat_g) is None:
                    # Cancelled: the chief is done, or this epoch was retired
                    # (the chief cancels the old layout's waiters at drain);
                    # the un-pushed gradient is lost like a stale drop.
                    if maybe_swap_epoch(force=True):
                        continue
                    break
            except (ps_service.PSError, ConnectionError, OSError):
                break  # the chief finished and tore the service down
            contributed += 1
            by_epoch[str(E.layout.version)] = by_epoch.get(str(E.layout.version), 0) + 1
            it += 1
            for key, ms in (("token_ms", (t1 - t0) * 1e3), ("pull_ms", (t2 - t1) * 1e3),
                            ("grad_ms", (t3 - t2) * 1e3), ("push_ms", E.sink.last_push_ms[0])):
                times[key].append(ms)
            if writer is not None and contributed % max(1, metrics_every) == 0:
                writer.scalars(local_step, {
                    **shard_scalars("pull", E.pull_timing.last_pull_ms),
                    **shard_scalars("push", E.sink.last_push_ms),
                })
        log.info("PS_WORKER_STATS %s", json.dumps({
            "task": wid, "device": str(dev), "contributed": contributed,
            "reshards_followed": reshards_followed, "contributed_by_epoch": by_epoch,
            **{f"median_{k}": float(np.median(v)) if v else None for k, v in times.items()},
            **_wire_bytes(), **_hand_kernel_launches(),
        }))
    finally:
        if writer is not None:
            writer.close()
        if heartbeat is not None:
            heartbeat.close()  # releases the lease: the clean leave signal
        E.close()
    return contributed


def _hand_kernel_launches() -> dict:
    """This process's launches of the port's hand kernels (``ops.LAUNCHES``),
    for the stats lines: a run whose models use none reads 0."""
    from .. import ops

    return {"hand_kernel_launches": int(sum(ops.LAUNCHES.values()))}


def _wire_bytes() -> dict:
    """The bytes this process's PS clients sent and received (every byte
    between a client and a server crosses the wire once)."""
    return {k: telemetry.REGISTRY.counter(f"ps_client/{k}").value
            for k in ("bytes_tx", "bytes_rx")}
