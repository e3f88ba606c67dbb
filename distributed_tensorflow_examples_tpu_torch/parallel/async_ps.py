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
joining the next average.  The socket transport (``RemotePSChief`` and the
worker/PS processes) is the port's item A9b.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .. import native
from ..bridge import flat_param_spec, flat_params_of
from ..data.pipeline import to_device
from ..train.checkpoint import CheckpointManager
from ..train.state import TrainState, as_state_leaves, leaves
from ..utils import device as device_lib
from ..utils import threefry

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
        tree = self._unflatten(self._master.to(self.device, copy=True), self.device)
        grad_leaves = [leaf.requires_grad_(True) for leaf in leaves(tree)]
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
        """The loss (read on the host, which waits for the backward) and the
        gradient of ``batch`` at the snapshot ``params``, one tensor per
        leaf of ``wrt`` (the snapshot's leaves)."""
        loss, _aux = self._loss_fn(params, self.model_state, to_device(batch, self.device), rng)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, grads)]
        return float(loss.detach()), grads

    def _to_host(self, grads: list) -> np.ndarray:
        """The gradient as one flat float32 host array in leaf order (one
        device-to-host copy, into pinned memory on a GPU)."""
        flat = torch.cat([g.detach().reshape(-1).float() for g in grads])
        host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=flat.is_cuda)
        host.copy_(flat)
        return host.numpy()

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
        for _ in range(self.global_step, self.cfg.train_steps):
            item = self._pop()
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
