"""Disaggregated data service: remote input workers streaming ready batches
over the PS wire, the port of
``distributed_tensorflow_examples_tpu/data/data_service.py``, wire-
compatible with it both ways (a port client reads a JAX server's batches
byte for byte, and a JAX client a port server's).

The reference stack does ALL input processing in-process on each training
worker, which caps accelerator utilization the moment preprocessing outruns
one host: the problem tf.data service solves by moving the input pipeline
onto separate serving processes ("tf.data service: A Case for Disaggregating
ML Input Data Processing").  This module is that third leg of the training
stack (PS compute / transport / INPUT), on the port's own
``parallel/{wire,server_core,tenancy,retry,membership}.py`` and
``utils/{faults,telemetry}.py``:

- :class:`DataServiceServer`: a dispatcher+worker-style data server.  It
  owns **split assignment** (first-come-first-served splits, per-epoch
  at-least-once visitation tracking, one job per tenant) and streams
  decoded, batched data to training workers over the shared wire (same
  framing, HELLO version negotiation, scatter/gather ``sendmsg`` out,
  ``recv_into`` straight into the destination arrays on the client).
- :class:`DataServiceClient`: the resilient transport.  Per-op deadlines,
  exponential-backoff reconnect bounded by ``reconnect_deadline_s``, fault
  injection via ``DTX_FAULT_PLAN`` (client role ``<role>_ds``), and
  incarnation tracking, so a RESTARTED data server is detected and healed.
- :class:`RemoteDatasetSource`: the ``dsvc://host:port`` source of
  ``data/streams.py``, with double-buffered prefetch and split re-claim on
  reconnect, so a data server kill+restart heals mid-epoch.

Batches stay numpy dicts, as in JAX; ``data/pipeline.py``'s
``prefetch_to_device`` makes the pinned, non-blocking copy to the card.

Wire notes (vs the PS wire): frame layout and HELLO are shared
(``parallel/wire.py``), but payload lengths count **bytes**, not elements —
batches carry mixed-dtype fields (uint8 images, int32 labels, f32 floats)
as raw bytes after a small JSON schema header, so the bf16 payload encoding
is unsound here and HELLO accepts only the f32 code.  The HELLO answer
carries a ``dsvc`` service tag so a client dialing the wrong service fails
loudly instead of misparsing op codes.

Split protocol (the dispatcher role):

- A **split** is one shard file (or in-RAM chunk): the unit of assignment.
  Batches within a split are deterministic in ``(seed, split)`` — NOT the
  epoch — so a worker resuming a re-claimed split after a server restart
  gets byte-identical batches at the same indices.
- ``GET_SPLIT(worker, ack)`` first acknowledges the worker's previous split
  (idempotent), then assigns the next pending split first-come-first-served.
  The op is **replay-safe**: a worker that already holds an unacknowledged
  split is handed THAT split again, so a response lost to a connection drop
  cannot strand an assignment.  ``-3`` = nothing pending right now (peers
  still draining) — poll; ``-4`` = the requested epoch is over.
- ``CLAIM_SPLIT(worker, split)`` re-requests a specific split after a
  reconnect lands on a new server incarnation (assignment state lost):
  answered claimed / already-completed / taken-by-another-worker.
- The epoch **rolls only when every split is acknowledged** — per-epoch
  at-least-once visitation by construction.  In steady state a split is
  never assigned to two workers; assignments are reassigned only when the
  assignee's liveness (any op naming it) goes stale, and duplicates can
  occur only across a failover (at-least-once, like the PS path's token
  re-push).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Iterator, Sequence

import numpy as np

from ..parallel import retry, server_core, tenancy, wire
from ..utils import faults, telemetry
from . import filestream

log = logging.getLogger("dtx.data_service")

# Op codes (DSVC_*): aliases into the ONE registry (wire.DSVC_OPS).
# Disjoint from the PS server's range except the shared HELLO code point,
# so a frame sent to the wrong service is refused, never misinterpreted.
DSVC_HELLO = wire.DSVC_OPS["HELLO"]
DSVC_REGISTER = wire.DSVC_OPS["REGISTER"]
DSVC_GET_SPLIT = wire.DSVC_OPS["GET_SPLIT"]
DSVC_CLAIM_SPLIT = wire.DSVC_OPS["CLAIM_SPLIT"]
DSVC_GET_BATCH = wire.DSVC_OPS["GET_BATCH"]
DSVC_HEARTBEAT = wire.DSVC_OPS["HEARTBEAT"]
DSVC_STATS = wire.DSVC_OPS["STATS"]
DSVC_GET_EVAL = wire.DSVC_OPS["GET_EVAL"]
DSVC_SHUTDOWN = wire.DSVC_OPS["SHUTDOWN"]

#: Ops excluded from the request counter, derived from the one
#: control-plane registry (wire.CONTROL_OPS).
_DSVC_CONTROL_OPS = frozenset(
    wire.DSVC_OPS[n] for n in wire.CONTROL_OPS["dsvc"]
)

#: HELLO answer payload: the service tag a client must verify (one shared
#: registry in parallel/wire.py — r10).
SERVICE_TAG = wire.SERVICE_TAGS["dsvc"]

# Response statuses (non-assignment ops: 0 ok, >0 op-specific, <0 error) —
# aliases into wire.DSVC_STATUS, the one definition site.
OK = wire.DSVC_STATUS["OK"]
END_OF_SPLIT = wire.DSVC_STATUS["END_OF_SPLIT"]
CLAIM_DONE = wire.DSVC_STATUS["CLAIM_DONE"]
CLAIM_TAKEN = wire.DSVC_STATUS["CLAIM_TAKEN"]
WAIT = wire.DSVC_STATUS["WAIT"]
EPOCH_ROLLED = wire.DSVC_STATUS["EPOCH_ROLLED"]
ERR = wire.DSVC_STATUS["ERR"]


def _tenant_of_request(op: int, name: str, a: int, b: int) -> str:
    """The server core's per-tenant admission attribution (r20): the
    tenant rides the ``name`` operand as a ``,t=<tenant>`` tag — absent
    (= the default tenant) on every untagged client's frames."""
    return tenancy.untag_name(name)[1]


class DSVCError(RuntimeError):
    """A data-service op failed terminally (transport unrecoverable or the
    server rejected the request)."""


class DSVCDeadlineError(DSVCError):
    """Reconnect budget exhausted: the data server stayed unreachable past
    ``reconnect_deadline_s``."""


class DSVCRejectedError(DSVCError):
    """The server ANSWERED and rejected the op (r17): the transport is
    fine, and retrying the same request buys nothing.  ``ERR`` is the
    server core's loud handler-failure status — a handler exception lands
    here instead of a silent connection close the client would burn its
    reconnect budget retrying."""


def parse_spec(spec: str) -> tuple[str, int]:
    """``dsvc://host:port`` -> (host, port)."""
    if not spec.startswith("dsvc://"):
        raise ValueError(f"not a data-service spec: {spec!r}")
    host, _, port = spec[len("dsvc://"):].rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad data-service spec {spec!r} (want dsvc://host:port)")
    return host, int(port)


# ----------------------------------------------------------------------------
# Batch codec: JSON schema header + raw field bytes (zero-copy both ways).
# One shared definition in parallel/wire.py (r10: the serving wire carries
# the same field-dict payloads); these names stay as the stable import
# point for tests and hosting code.
# ----------------------------------------------------------------------------

encode_batch = wire.encode_batch
encoded_nbytes = wire.encoded_nbytes
read_batch = wire.read_batch


# ----------------------------------------------------------------------------
# Server — dispatcher (split assignment) + worker (batch serving) in one
# ----------------------------------------------------------------------------


class _TenantJob:
    """One tenant's dispatcher state machine over the SHARED split set
    (r20 multi-tenancy): each tenant consumes the same splits as its own
    independent job — its own epoch, pending order, assignments,
    visitation and liveness tables — so two training runs can draw from
    one data service without ever seeing each other's assignment state
    (the tf.data-service sharing argument: input workers exist to be
    shared across jobs).  The split CONTENT (decode cache, batch bytes)
    stays shared on the server; only the assignment plane is per-tenant.
    All fields are guarded by the owning server's ``_lock``."""

    def __init__(self, n_splits: int, order: list[int]):
        self.epoch = 0
        self.pending: deque[int] = deque(order)
        self.assigned: dict[int, tuple[int, float]] = {}  # split -> (worker, t)
        self.worker_split: dict[int, int] = {}  # worker -> unacked split
        self.completed: set[int] = set()
        self.visits = {i: 0 for i in range(n_splits)}
        self.last_seen: dict[int, float] = {}
        self.stale_members: set[int] = set()
        self.stale_marked = 0
        self.batches_served = 0
        self.splits_completed = 0
        self.assigned_total = 0
        self.acks = 0
        self.reassigned = 0
        self.epochs_completed = 0
        self.last_epoch_min_visits = 0
        self.registered: set[int] = set()

    def counters(self) -> dict:
        """The per-tenant stats row (caller holds the server lock)."""
        return {
            "epoch": self.epoch,
            "pending": len(self.pending),
            "assigned": len(self.assigned),
            "completed": len(self.completed),
            "registered_workers": len(self.registered),
            "batches_served": self.batches_served,
            "splits_completed": self.splits_completed,
            "assigned_total": self.assigned_total,
            "acks": self.acks,
            "reassigned": self.reassigned,
            "stale_marked": self.stale_marked,
            "epochs_completed": self.epochs_completed,
            "last_epoch_min_visits": self.last_epoch_min_visits,
        }


class DataServiceServer:
    """TCP data server on the unified server core (r17): one dispatcher
    state machine registered as a handler on ``parallel/server_core.py``
    (selector-driven I/O, bounded worker pool — idle connections cost no
    threads), batches decoded server-side (the disaggregation point —
    preprocessing cost lives HERE, not on the training host).

    ``splits``           shard file paths (``filestream`` formats) or in-RAM
                         ``{field: array}`` chunks; one split per entry.
    ``batch_size``       rows per served batch (the TRAINING worker's local
                         batch).
    ``decode_fn``        applied to every batch before serving ("ready
                         batches": decode/normalize/augment run on the data
                         server's cores).
    ``shuffle``          shuffle rows within a split, keyed on ``(seed,
                         split)`` only — deterministic across epochs AND
                         server restarts, so a re-claimed split resumes
                         byte-identically.  Epoch-to-epoch variation comes
                         from the per-epoch split ORDER, keyed on ``(seed,
                         epoch)``.
    ``eval_chunk``       optional held-out chunk served raw via GET_EVAL.
    ``reassign_after_s`` liveness window: an assigned split whose worker has
                         issued no op for this long may be handed to another
                         worker (at-least-once beats a lost worker wedging
                         the epoch).
    """

    def __init__(
        self,
        splits: Sequence,
        *,
        batch_size: int,
        decode_fn: Callable | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        eval_chunk: dict[str, np.ndarray] | None = None,
        port: int = 0,
        loopback_only: bool = True,
        reassign_after_s: float = 60.0,
        cache_splits: int = 4,
        info_extra: dict | None = None,
        handler_workers: int = 8,
        tenant_quotas: dict | None = None,
    ):
        if not splits:
            raise ValueError("data service needs at least one split")
        # Extra fields merged into the REGISTER answer — how hosting code
        # advertises pipeline settings clients should sanity-check (e.g.
        # serve_from_dir's seed/augment).
        self._info_extra = dict(info_extra or {})
        self._splits = list(splits)
        self._batch = batch_size
        self._decode = decode_fn
        self._shuffle = shuffle
        self._seed = seed
        self._drop_remainder = drop_remainder
        self._eval_chunk = eval_chunk
        self._reassign_after_s = reassign_after_s
        # Distinct per process start: a client comparing incarnations across
        # a reconnect detects a restarted (assignment-state-lost) server.
        self._incarnation = int.from_bytes(os.urandom(4), "little") | 1
        self._lock = threading.Lock()
        # Per-tenant dispatcher jobs (r20): each tenant iterates the SHARED
        # split set as its own job — own epoch/pending/assignment/liveness
        # state (including the r14 stale-member marks, so one tenant's
        # membership churn can never trigger another tenant's
        # reassignment).  The default job always exists: untagged frames
        # are the default tenant by construction, and single-tenant
        # behavior is byte-identical to pre-tenant servers.
        self._jobs: dict[str, _TenantJob] = {
            tenancy.DEFAULT_TENANT: _TenantJob(
                len(self._splits), self._epoch_order(0)
            ),
        }
        self._cache: OrderedDict[int, list] = OrderedDict()
        self._cache_cap = max(1, cache_splits)
        self.shutdown_requested = threading.Event()
        # The shared server runtime (r17): selector-driven I/O, a bounded
        # handler pool, per-connection write buffering and the request
        # counter all live in parallel/server_core.py — this class is the
        # dispatcher state machine plus one registered handler.
        self._core = server_core.ServerCore(
            port=port, loopback_only=loopback_only, name="dsvc",
            workers=handler_workers, tenant_quotas=tenant_quotas,
        )
        self._core.add_service(server_core.Service(
            "dsvc", self._handle,
            control_ops=_DSVC_CONTROL_OPS,
            counts_fn=self._counts_request,
            tenant_of=_tenant_of_request,
            error_status=ERR,
            # No DSVC request carries a payload: a frame announcing more
            # than this is a corrupt/hostile peer and drops at header
            # time, before a byte of it would be buffered.
            max_payload=1 << 20,
        ))
        self._core.start()
        self.port = self._core.port
        log.info(
            "data service serving %d splits on port %d (incarnation %d)",
            len(self._splits), self.port, self._incarnation,
        )

    # -- lifecycle -----------------------------------------------------------

    def request_count(self) -> int:
        """Requests handled so far — the ``die:after_reqs`` fault trigger
        for a data-service task (same contract as the PS server's).  The
        counter lives in the server core, which excludes the control-plane
        ops (wire.CONTROL_OPS) and the scraper's metadata-only probe."""
        return self._core.request_count()

    @staticmethod
    def _counts_request(op: int, name: str, a: int, b: int) -> bool:
        # The scraper's metadata-only REGISTER probe (negative worker id)
        # is uncounted — an op-level rule cannot carry it, so it stays
        # spelled out here as the core's per-service counts hook.
        return not (op == DSVC_REGISTER and a < 0)

    def stop(self) -> None:
        # The core drains (in-flight handlers finish, buffers flush) and
        # releases the port before returning — the same contract the old
        # hand-rolled accept loop kept for supervised same-port restarts.
        self._core.stop()

    # -- split plumbing ------------------------------------------------------

    def _epoch_order(self, epoch: int) -> list[int]:
        order = np.arange(len(self._splits))
        if self._shuffle:
            order = np.random.default_rng(
                (self._seed, epoch)
            ).permutation(order)
        return [int(i) for i in order]

    def _split_batches(self, si: int) -> list:
        """Ready (decoded, batch-sliced) batches of split ``si``, each
        pre-encoded as a wire buffer list; LRU-cached so the per-connection
        handlers share the decode work."""
        with self._lock:
            cached = self._cache.get(si)
            if cached is not None:
                self._cache.move_to_end(si)
                return cached
        src = self._splits[si]
        chunk = filestream.load_chunk(src) if isinstance(src, str) else {
            k: np.asarray(v) for k, v in src.items()
        }
        n = len(next(iter(chunk.values())))
        if self._shuffle:
            order = np.random.default_rng((self._seed, si)).permutation(n)
            chunk = {k: v[order] for k, v in chunk.items()}
        b = self._batch
        nb = n // b if self._drop_remainder else -(-n // b)
        batches = []
        for s in range(nb):
            raw = {k: v[s * b : (s + 1) * b] for k, v in chunk.items()}
            batches.append(encode_batch(self._decode(raw) if self._decode else raw))
        with self._lock:
            self._cache[si] = batches
            # Capacity adapts to the number of splits concurrently ASSIGNED
            # (across every tenant's job — the decode cache is the shared
            # resource): with more active workers than the configured
            # floor, a fixed cap would thrash — every interleaved
            # GET_BATCH re-decoding a whole shard to serve one batch.
            live = sum(len(j.assigned) for j in self._jobs.values())
            cap = max(self._cache_cap, live + 1)
            while len(self._cache) > cap:
                self._cache.popitem(last=False)
        return batches

    def _num_batches(self, si: int) -> int:
        return len(self._split_batches(si))

    # -- dispatcher state machine (all under self._lock; one _TenantJob
    # per tenant — the shared-split multiplexing point, r20) ------------------

    def _job_locked(self, tenant: str) -> _TenantJob:
        """The tenant's dispatcher job, created on first touch (caller
        holds ``self._lock``).  Every tenant iterates the same split set
        from epoch 0 with the same deterministic per-epoch order."""
        j = self._jobs.get(tenant)
        if j is None:
            j = self._jobs[tenant] = _TenantJob(
                len(self._splits), self._epoch_order(0)
            )
            log.info("data service: new tenant job %r", tenant)
        return j

    def _ack_locked(self, j: _TenantJob, worker: int, split: int) -> None:
        """Idempotent completion mark.  Also honors acks a RESTARTED server
        never assigned (the old incarnation did): the split is pulled out of
        pending so visited work is not re-served."""
        if not (0 <= split < len(self._splits)) or split in j.completed:
            return
        holder = j.assigned.get(split)
        if holder is not None and holder[0] != worker:
            return  # someone else owns it now (post-failover): their ack counts
        j.assigned.pop(split, None)
        if j.worker_split.get(worker) == split:
            del j.worker_split[worker]
        try:
            j.pending.remove(split)
        except ValueError:
            pass
        j.completed.add(split)
        j.visits[split] = max(j.visits[split], 1)
        j.splits_completed += 1
        j.acks += 1
        self._maybe_roll_locked(j)

    def _maybe_roll_locked(self, j: _TenantJob) -> None:
        if len(j.completed) < len(self._splits):
            return
        j.last_epoch_min_visits = min(j.visits.values())
        j.epochs_completed += 1
        j.epoch += 1
        j.completed.clear()
        j.assigned.clear()
        j.worker_split.clear()
        j.visits = {i: 0 for i in range(len(self._splits))}
        j.pending = deque(self._epoch_order(j.epoch))
        log.info("data service: epoch rolled to %d", j.epoch)

    def _assign_locked(self, j: _TenantJob, worker: int, split: int) -> None:
        j.assigned[split] = (worker, time.monotonic())
        j.worker_split[worker] = split
        j.visits[split] += 1
        j.assigned_total += 1

    def _handle_get_split(
        self, tenant: str, worker: int, ack: int,
        client_epoch: int | None, strict: bool,
    ):
        now = time.monotonic()
        with self._lock:
            j = self._job_locked(tenant)
            j.last_seen[worker] = now
            j.stale_members.discard(worker)  # it's back: unmark
            if ack >= 0 and (client_epoch is None or client_epoch == j.epoch):
                # Epoch-tagged acks: an ack for a split assigned in a
                # PREVIOUS epoch (a worker that stalled past reassignment
                # while the epoch rolled) must not mark the NEW epoch's
                # pending copy completed with zero deliveries — ignoring it
                # re-serves the split instead (at-least-once preserved).
                self._ack_locked(j, worker, ack)
            if strict and client_epoch != j.epoch:
                return EPOCH_ROLLED, {"epoch": j.epoch}
            # Replay safety: an unacked assignment is re-answered, so a
            # response lost mid-drop cannot strand a split on this worker.
            held = j.worker_split.get(worker)
            if held is not None and held not in j.completed:
                return held, {"epoch": j.epoch, "num_batches": None, "split": held}
            if j.pending:
                s = j.pending.popleft()
                self._assign_locked(j, worker, s)
                return s, {"epoch": j.epoch, "num_batches": None, "split": s}
            # Nothing pending: reassign only a STALE assignee's split (a
            # lost worker must not wedge the epoch); otherwise wait.  A
            # worker the membership layer declared departed (expired
            # lease, r14) is stale IMMEDIATELY — the elastic leave path
            # skips the liveness window entirely.  Staleness is scoped to
            # THIS tenant's job: another tenant's membership churn cannot
            # reassign here (r20 isolation).
            for s, (w, t0) in j.assigned.items():
                if w in j.stale_members or now - max(
                    j.last_seen.get(w, 0.0), t0
                ) > self._reassign_after_s:
                    if j.worker_split.get(w) == s:
                        # The stale worker no longer holds it: were it to
                        # come back, its GET_SPLIT must not re-answer s.
                        del j.worker_split[w]
                    self._assign_locked(j, worker, s)
                    j.reassigned += 1
                    faults.log_event(
                        "dsvc_reassign", split=s, from_worker=w, to_worker=worker,
                    )
                    return s, {"epoch": j.epoch, "num_batches": None, "split": s}
            return WAIT, {"epoch": j.epoch}

    def mark_worker_stale(self, worker: int, tenant: str | None = None) -> None:
        """Membership hook (r14): a worker whose lease EXPIRED is departed
        NOW — its assigned splits become reassignable on the next
        GET_SPLIT, without waiting out ``reassign_after_s``.  Idempotent;
        any later op from the worker clears the mark.  ``tenant`` scopes
        the mark to one tenant's job (r20: a tenant-tagged lease expiry
        must never reassign another tenant's splits); ``None`` — the
        pre-tenant signature — marks the worker in every job."""
        with self._lock:
            jobs = (
                list(self._jobs.values()) if tenant is None
                else [self._job_locked(tenant)]
            )
            for j in jobs:
                if worker not in j.stale_members:
                    j.stale_members.add(worker)
                    j.stale_marked += 1
        faults.log_event("dsvc_member_stale", worker=worker, tenant=tenant)

    def _handle_claim(self, tenant: str, worker: int, split: int):
        with self._lock:
            j = self._job_locked(tenant)
            j.last_seen[worker] = time.monotonic()
            j.stale_members.discard(worker)
            if not (0 <= split < len(self._splits)):
                return ERR, {}
            if split in j.completed:
                return CLAIM_DONE, {"epoch": j.epoch}
            holder = j.assigned.get(split)
            if holder is not None and holder[0] != worker:
                return CLAIM_TAKEN, {"epoch": j.epoch}
            try:
                j.pending.remove(split)
            except ValueError:
                pass
            if holder is None:
                self._assign_locked(j, worker, split)
            return OK, {"epoch": j.epoch, "num_batches": None, "split": split}

    def stats(self) -> dict:
        with self._lock:
            # Top-level dispatcher counters are the DEFAULT tenant's job —
            # the pre-tenant shape every existing consumer (tests, dtxtop,
            # loadsim verdicts) reads; a single-tenant server reports
            # exactly what it always did.  The per-tenant breakdown rides
            # in "tenants" (every job, default included).
            out = {
                "service": "dsvc",
                "role": faults.current_role(),
                "incarnation": self._incarnation,
                "num_splits": len(self._splits),
                **self._jobs[tenancy.DEFAULT_TENANT].counters(),
                "tenants": {t: j.counters() for t, j in self._jobs.items()},
            }
        # The uniform runtime-accounting shape (r17): requests/live_conns
        # come from the shared server core, so the counters mean the same
        # thing on every service's STATS answer.  The admission-control
        # shed counters (r18) surface top-level too, so dtxtop and the
        # loadsim overload verdict read one shape across all three
        # services (the native PS exports the same two keys).
        core = self._core.core_stats()
        out["requests"] = core["requests"]
        out["live_conns"] = core["live_conns"]
        out["shed_total"] = core["shed_total"]
        out["queue_deadline_drops"] = core["queue_deadline_drops"]
        out["core"] = core
        # Process-wide registry + flight-recorder depth ride along (r13):
        # one STATS scrape reads the server's dispatcher counters AND the
        # host process's client-side instruments in one round trip.
        out["registry"] = telemetry.snapshot()
        out["flight_events"] = len(telemetry.RECORDER)
        return out

    # -- the core handler ----------------------------------------------------
    # One registered handler on the shared server core (r17): the core
    # owns accept/read/write/HELLO/counting; this method is pure
    # request->response.  HELLO never reaches it (answered in the core
    # through the shared wire.hello_answer path), and a raised exception
    # becomes a LOUD per-op ERR on the client (the core's posture).

    def _handle(self, conn, op: int, name: str, a: int, b: int, payload):
        # The tenant rides the name operand (",t=<tenant>", r20) — absent
        # on untagged (pre-tenant) clients, which land on the default
        # tenant's job with byte-identical frames.
        name, tenant = tenancy.untag_name(name)
        if op == DSVC_REGISTER:
            with self._lock:
                j = self._job_locked(tenant)
                if a >= 0:
                    # Negative worker ids are metadata-only probes (source
                    # resolution, tooling): they must not count as training
                    # workers in the dispatcher's liveness/stats tables.
                    j.registered.add(a)
                    j.last_seen[a] = time.monotonic()
                    j.stale_members.discard(a)
                epoch = j.epoch
            info = {
                "incarnation": self._incarnation,
                "epoch": epoch,
                "num_splits": len(self._splits),
                "batch_size": self._batch,
                **self._info_extra,
            }
            return OK, [json.dumps(info).encode()]
        if op == DSVC_GET_SPLIT:
            # name: "epoch=<n>[,strict]" — <n> is the epoch the CLIENT is
            # in (the epoch its ack's split was assigned in); ",strict"
            # additionally constrains assignment to that epoch
            # (single-epoch iteration).
            client_epoch, strict = None, False
            if name.startswith("epoch="):
                tail = name[len("epoch="):]
                strict = tail.endswith(",strict")
                client_epoch = int(tail[: -len(",strict")] if strict else tail)
            status, info = self._handle_get_split(
                tenant, a, b, client_epoch, strict
            )
            if status >= 0 and info.get("num_batches") is None:
                info["num_batches"] = self._num_batches(status)
            return status, [json.dumps(info).encode()]
        if op == DSVC_CLAIM_SPLIT:
            status, info = self._handle_claim(tenant, a, b)
            if status == OK and info.get("num_batches") is None:
                info["num_batches"] = self._num_batches(b)
            return status, [json.dumps(info).encode()]
        if op == DSVC_GET_BATCH:
            if not (0 <= a < len(self._splits)):
                return ERR, None
            with self._lock:
                j = self._job_locked(tenant)
                if name:
                    j.last_seen[int(name)] = time.monotonic()
                    j.stale_members.discard(int(name))
            batches = self._split_batches(a)
            if b >= len(batches) or b < 0:
                return END_OF_SPLIT, None
            with self._lock:
                j.batches_served += 1
            return OK, batches[b]
        if op == DSVC_HEARTBEAT:
            with self._lock:
                j = self._job_locked(tenant)
                j.last_seen[a] = time.monotonic()
                j.stale_members.discard(a)
                epoch = j.epoch
            return epoch, None
        if op == DSVC_STATS:
            return OK, [json.dumps(self.stats()).encode()]
        if op == DSVC_GET_EVAL:
            if self._eval_chunk is None:
                return END_OF_SPLIT, None
            return OK, encode_batch(self._eval_chunk)
        if op == DSVC_SHUTDOWN:
            self.shutdown_requested.set()
            return OK, None
        return ERR, None


# ----------------------------------------------------------------------------
# Client transport — deadlines, backoff reconnect, incarnation healing
# ----------------------------------------------------------------------------


class DataServiceClient:
    """One TCP connection to a data server (requests serialized on it).

    The PR 1 fault posture, extended to input: every op takes the
    ``op_timeout_s`` deadline; a transport failure triggers
    exponential-backoff reconnect bounded by ``reconnect_deadline_s``
    (``DSVCDeadlineError`` past it) and the op is replayed — every DSVC op
    is idempotent or replay-safe by protocol (see the module docstring's
    GET_SPLIT note).  On reconnect the client re-negotiates HELLO,
    re-registers, and compares the server's incarnation: a change means a
    RESTARTED server lost all assignment state, so registered
    ``on_reincarnation`` callbacks run (the dataset source re-claims its
    in-flight split there).

    Fault-plan role: ``<process role>_ds`` by default, so ``DTX_FAULT_PLAN``
    specs can target data connections specifically (``role=worker0_ds``)
    while broad globs like ``worker0*`` still match both PS and data
    clients of a worker.
    """

    def __init__(
        self, host: str, port: int, *, worker_id: int = 0,
        op_timeout_s: float | None = 30.0, reconnect_deadline_s: float = 60.0,
        backoff_s: float = 0.25, role: str | None = None,
        tenant: str = tenancy.DEFAULT_TENANT,
    ):
        self._host, self._port = host, port
        self.worker_id = worker_id
        # The tenant every request of this client is tagged with (r20):
        # the default tenant tags nothing, so a pre-tenant server sees
        # byte-identical frames.
        self.tenant = (
            tenant if tenant == tenancy.DEFAULT_TENANT
            else tenancy.check_tenant(tenant)
        )
        self._op_timeout = op_timeout_s
        self._reconnect_deadline = reconnect_deadline_s
        self._backoff = backoff_s
        self.role = role if role is not None else (
            (faults.current_role() or "client") + "_ds"
        )
        self._injector = faults.client_injector(self.role)
        # Shared retry discipline (r18): replays and shed retries spend
        # this budget; exhaustion surfaces as DSVCDeadlineError plus a
        # flight-recorder event (parallel/retry.py).
        self._budget = retry.RetryBudget()
        self._lock = threading.RLock()
        self._in_recovery = False
        self._callbacks: list = []
        self._sock: socket.socket | None = None
        self._hdr = bytearray(wire.RESP_HDR.size)
        self.incarnation: int | None = None
        self.server_info: dict = {}
        try:
            self._connect()
            self._register()
        except OSError:
            if self._reconnect_deadline <= 0:
                raise
            self._recover(time.monotonic() + self._reconnect_deadline)

    # -- transport -----------------------------------------------------------

    def _connect(self) -> None:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._op_timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        status, tag = self._attempt(
            DSVC_HELLO, a=wire.WIRE_VERSION,
            b=wire.pack_hello_b(wire.WIRE_DTYPES["f32"], service="dsvc"),
        )
        err = wire.hello_failure(
            status, tag, service="dsvc", host=self._host, port=self._port
        )
        if err is not None:
            self._sever()
            raise DSVCError(err)

    def _register(self) -> None:
        """REGISTER on the live socket (single attempt); detects a new
        server incarnation and runs the reincarnation callbacks."""
        status, raw = self._attempt(DSVC_REGISTER, name=self.role, a=self.worker_id)
        if status != OK:
            raise self.rejected_error("register", status)
        info = json.loads(raw)
        changed = (
            self.incarnation is not None
            and info["incarnation"] != self.incarnation
        )
        self.server_info = info
        if changed:
            faults.log_event(
                "dsvc_reincarnation", role=self.role, epoch=info["epoch"],
            )
            self._in_recovery = True
            try:
                for fn in list(self._callbacks):
                    fn(info)
            finally:
                self._in_recovery = False
        # Adopt the new incarnation only AFTER the callbacks completed: a
        # transport fault inside a callback (e.g. a second drop during the
        # re-claim) sends the recover loop around again, and the retried
        # register must still see the incarnation as CHANGED so the
        # callbacks re-run — callbacks are idempotent (claim re-claims).
        self.incarnation = info["incarnation"]

    def on_reincarnation(self, fn) -> None:
        """Register ``fn(server_info)`` to run whenever a reconnect lands on
        a NEW server incarnation (assignment state lost).  Callbacks may use
        this client; their ops run single-attempt (no nested recovery)."""
        self._callbacks.append(fn)

    def _sever(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._reconnect_deadline = 0.0
        self._sever()

    def _attempt(
        self, op: int, name: str = "", a: int = 0, b: int = 0, *,
        batch: bool = False, deadline_s: float | None = None,
    ):
        """One send/recv round trip; severs the socket on ANY transport
        failure (framing broken mid-stream).  Returns ``(status, payload)``
        where payload is raw bytes, a decoded batch dict (``batch=True``),
        or None when the response carries none."""
        # One reference for the whole round trip: close() from another
        # thread fails the attempt as a transport error (OSError), never
        # as an AttributeError on a vanished socket.
        sock = self._sock
        if sock is None:
            raise ConnectionError("not connected")
        # The ONE client-side tagging point (r20): every data-plane op of
        # a non-default tenant carries its tenant in the name operand.
        # Never HELLO — the tag is a v5 construct and HELLO is the frame
        # that discovers the peer's version (same reasoning as the
        # deadline stamp below).
        if self.tenant != tenancy.DEFAULT_TENANT and op != DSVC_HELLO:
            name = tenancy.tag_name(name, self.tenant)
        try:
            eff_deadline = (
                deadline_s if deadline_s is not None else self._op_timeout
            )
            sock.settimeout(eff_deadline)
            # Deadline propagation (r18): the remaining per-op budget rides
            # in the frame header, so the server core sheds this request —
            # instead of dispatching it to a worker — once this client has
            # already abandoned it.  NEVER on HELLO itself: the stamp is a
            # v4 construct and HELLO is the frame that DISCOVERS the
            # peer's version — a stamped HELLO against a pre-v4 server
            # would misparse instead of answering the loud version
            # mismatch (every later op follows a v4-confirmed HELLO).
            sock.sendall(wire.pack_request(
                op, name, a, b, 0,
                deadline_ms=(
                    0 if eff_deadline is None or op == DSVC_HELLO
                    else max(1, int(eff_deadline * 1000))
                ),
            ))
            hdr = memoryview(self._hdr)
            wire.recv_exact(sock, hdr)
            status, nbytes = wire.RESP_HDR.unpack(self._hdr)
            if not nbytes:
                return status, None
            if batch:
                return status, read_batch(sock, nbytes)
            buf = bytearray(nbytes)
            wire.recv_exact(sock, memoryview(buf))
            return status, bytes(buf)
        except OSError:
            self._sever()
            raise

    def _recover(self, t_end: float) -> None:
        attempt = 0
        immediate = False
        while True:
            if attempt and not immediate:
                # Jittered backoff (r18): recovering peers decorrelate
                # their re-dials instead of re-arriving in lockstep.
                delay = retry.jittered(self._backoff, attempt - 1, cap_s=2.0)
                time.sleep(min(delay, max(0.0, t_end - time.monotonic())))
            immediate = False
            if time.monotonic() >= t_end:
                faults.log_event(
                    "reconnect_gave_up", role=self.role, host=self._host,
                    port=self._port, attempts=attempt,
                )
                telemetry.dump_flight_recorder("reconnect_gave_up")
                raise DSVCDeadlineError(
                    f"data service at {self._host}:{self._port} unreachable "
                    f"for {self._reconnect_deadline:.0f}s ({attempt} attempts)"
                )
            attempt += 1
            # Per-address circuit breaker (r18): a freshly-proven-dead
            # address fails fast for its open window instead of burning
            # another connect timeout (shared process-wide, so every
            # client of this server pays ONE discovery).
            breaker = retry.breaker_for((self._host, self._port))
            if not breaker.allow():
                breaker.wait_for_probe(t_end)
                immediate = True  # the wait was this attempt's pacing
                continue
            try:
                self._connect()
                self._register()
            except OSError:
                breaker.on_failure()
                self._sever()
                continue
            except DSVCRejectedError:
                # The server ANSWERED and refused (a deterministic
                # register rejection): the transport is healthy and
                # every retry would be refused the same way — re-raise
                # instead of burning the whole reconnect budget to
                # report the service "unreachable" (the exact failure
                # mode the typed rejection exists to prevent).
                breaker.on_success()  # the address answered: not dead
                raise
            except DSVCError:
                # A callback's single-attempt op hit a transport fault: same
                # as a raw drop — sever, retry, same deadline.  (A HELLO
                # version/tag mismatch also lands here; retrying it is
                # harmless and bounded by the deadline.)
                self._sever()
                continue
            breaker.on_success()
            faults.log_event("reconnected", role=self.role, attempts=attempt)
            return

    def call(
        self, op: int, name: str = "", a: int = 0, b: int = 0, *,
        batch: bool = False,
    ):
        """One request/response; recovers + replays on transport failure
        (every DSVC op is replay-safe — see class docstring).  A server
        SHED (the RETRY_LATER band, r18 admission control) is retried
        with jittered backoff through the shared retry budget, bounded
        by the op deadline — never at line rate."""
        with self._lock:
            if self._injector is not None and self._injector.before_op(op):
                self._sever()  # injected drop_conn
            t_end = None
            shed = retry.ShedRetry(self._budget, self._op_timeout)
            while True:
                if self._sock is not None:
                    try:
                        status, payload = self._attempt(
                            op, name, a, b, batch=batch
                        )
                    except OSError as e:
                        if self._in_recovery or self._reconnect_deadline <= 0:
                            raise DSVCError(f"dsvc op {op} failed: {e!r}") from e
                        faults.log_event(
                            "conn_lost", role=self.role, op_code=op,
                            error=type(e).__name__,
                        )
                    else:
                        hint = wire.retry_after_ms(status)
                        if hint is None:
                            self._budget.on_success()
                            return status, payload
                        # One spelling of the shed-retry discipline
                        # (retry.ShedRetry): jittered off the server's
                        # hint, through the budget, deadline-bounded.
                        if not shed.backoff(hint):
                            raise DSVCDeadlineError(
                                f"data service at {self._host}:{self._port} "
                                f"kept shedding op {op} (RETRY_LATER) past "
                                "the op deadline / retry budget"
                            )
                        continue
                elif self._in_recovery or self._reconnect_deadline <= 0:
                    raise DSVCError(f"dsvc op {op} failed: not connected")
                if t_end is None:
                    t_end = time.monotonic() + self._reconnect_deadline
                # A transport replay spends the shared retry budget: a
                # storm of failing ops cannot replay unboundedly.
                if not self._budget.try_spend():
                    raise DSVCDeadlineError(
                        f"data service at {self._host}:{self._port} retry "
                        f"budget exhausted replaying op {op}"
                    )
                self._recover(t_end)

    # -- convenience ops -----------------------------------------------------

    @staticmethod
    def rejected_error(what: str, status: int) -> DSVCError:
        """The ONE typed-error path for server-side rejections (r17):
        every negative answer a caller cannot act on maps to
        :class:`DSVCRejectedError`, with the core's generic handler-
        failure band (``ERR``) named explicitly — the server logged the
        traceback; the client's job is only to say WHERE to look."""
        if status == ERR:
            return DSVCRejectedError(
                f"{what} failed server-side (ERR: handler error — see the "
                "data server's log)"
            )
        return DSVCRejectedError(f"{what} rejected: status {status}")

    def heartbeat(self) -> int:
        status, _ = self.call(DSVC_HEARTBEAT, a=self.worker_id)
        return status

    def stats(self) -> dict:
        status, raw = self.call(DSVC_STATS)
        if status != OK:
            raise self.rejected_error("stats", status)
        return json.loads(raw)

    def shutdown_server(self) -> None:
        self.call(DSVC_SHUTDOWN)


# ----------------------------------------------------------------------------
# RemoteDatasetSource — the dsvc:// branch of data/streams.py
# ----------------------------------------------------------------------------


class _BatchPrefetcher:
    """Double-buffered background prefetch (modeled on
    ``async_ps.ParamPrefetcher``): while the trainer consumes batch k, the
    fetch thread already pulls k+1 over the wire — transport latency hidden
    under compute.  Errors surface on the CONSUMING side, never corrupt it;
    a bounded queue (depth 2) caps both staleness and host RAM."""

    _DONE = object()

    def __init__(self, it: Iterator, *, depth: int = 2, stall_timeout_s: float = 300.0):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._stall = stall_timeout_s
        self._thread = threading.Thread(
            target=self._loop, args=(it,), daemon=True, name="dsvc-prefetch"
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while True:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._stop.is_set():
                    return False

    def _loop(self, it) -> None:
        try:
            for item in it:
                if self._stop.is_set() or not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self._put(e)
            return
        self._put(self._DONE)

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=self._stall)
            except queue.Empty:
                raise DSVCDeadlineError("data-service prefetch thread stalled")
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class RemoteDatasetSource:
    """High-level consumer of one data server: owns a
    :class:`DataServiceClient`, runs the split protocol, and yields ready
    batches.  ``dsvc://host:port`` specs parse via :func:`parse_spec`.

    Reconnect healing: the source registers an ``on_reincarnation`` hook
    that RE-CLAIMS the unacknowledged in-flight split on the restarted
    server, then resumes at the same batch index — exact, because split
    batches are deterministic in ``(seed, split)``.  A split the restarted
    epoch already completed (or another worker claimed first) is dropped
    and the source moves on; duplicates are possible only across the
    failover (at-least-once), never in steady state.
    """

    def __init__(
        self, spec: str, *, worker_id: int = 0,
        op_timeout_s: float | None = 30.0, reconnect_deadline_s: float = 60.0,
        role: str | None = None, poll_s: float = 0.05,
        tenant: str = tenancy.DEFAULT_TENANT,
    ):
        host, port = parse_spec(spec)
        self.spec = spec
        self._wid = worker_id
        self._poll_s = poll_s
        self._client = DataServiceClient(
            host, port, worker_id=worker_id, op_timeout_s=op_timeout_s,
            reconnect_deadline_s=reconnect_deadline_s, role=role,
            tenant=tenant,
        )
        self._client.on_reincarnation(self._reclaim)
        self._epoch = int(self._client.server_info["epoch"])
        self._ack = -1
        self._cur: list | None = None  # [split, num_batches, next_index]

    @property
    def server_info(self) -> dict:
        return self._client.server_info

    @property
    def num_splits(self) -> int:
        return int(self._client.server_info["num_splits"])

    def stats(self) -> dict:
        return self._client.stats()

    def eval_chunk(self) -> dict[str, np.ndarray] | None:
        status, payload = self._client.call(DSVC_GET_EVAL, batch=True)
        if status == END_OF_SPLIT:
            return None
        if status != OK:
            raise DataServiceClient.rejected_error("get_eval", status)
        return payload

    def close(self) -> None:
        self._client.close()

    # -- reincarnation healing ----------------------------------------------

    def _reclaim(self, info: dict) -> None:
        """Runs inside the client's reconnect path: re-request the
        unacknowledged split from the restarted server (PR 1 semantics,
        extended to input), adopt its epoch, and forget an ack addressed to
        the dead incarnation only after handing it over."""
        self._epoch = int(info["epoch"])
        if self._cur is None:
            return
        split = self._cur[0]
        status, raw = self._client._attempt(DSVC_CLAIM_SPLIT, a=self._wid, b=split)
        if status == OK:
            faults.log_event(
                "dsvc_reclaimed", role=self._client.role, split=split,
                index=self._cur[2],
            )
            return  # keep streaming the same split at the same index
        # This split is no longer ours — drop it and move on.  The named
        # claim statuses make the log line actionable: CLAIM_DONE means an
        # ack raced ahead (the work already counted), CLAIM_TAKEN means a
        # peer claimed it across the failover (at-least-once duplicate).
        reason = (
            "completed" if status == CLAIM_DONE
            else "taken" if status == CLAIM_TAKEN
            else f"status_{status}"
        )
        faults.log_event(
            "dsvc_reclaim_lost", role=self._client.role, split=split,
            status=status, reason=reason,
        )
        self._cur = None

    # -- the split/batch loop ------------------------------------------------

    def _next_split(self, single_epoch: bool):
        while True:
            # The epoch always rides along: it tags the ack (so a stale ack
            # from before an epoch roll is ignored server-side, never
            # falsely completing the new epoch's copy) and, with ",strict",
            # constrains assignment to it (single-epoch iteration).
            sent_epoch = self._epoch
            name = f"epoch={sent_epoch}" + (",strict" if single_epoch else "")
            status, raw = self._client.call(
                DSVC_GET_SPLIT, name=name, a=self._wid, b=self._ack
            )
            self._ack = -1
            info = json.loads(raw) if raw else {}
            if status >= 0:
                self._epoch = int(info.get("epoch", self._epoch))
                return status, int(info["num_batches"])
            if status == WAIT:
                time.sleep(self._poll_s)
                continue
            if status == EPOCH_ROLLED:
                server_epoch = int(info.get("epoch", -1))
                if single_epoch and (
                    server_epoch < sent_epoch or self._epoch != sent_epoch
                ):
                    # Not a genuine roll: either the server RESTARTED into
                    # an earlier epoch (state lost), or a mid-call recovery
                    # already adopted the new incarnation's epoch while the
                    # REPLAYED request still carried the stale constraint
                    # (sent_epoch, not self._epoch, is what the server
                    # answered).  Either way the epoch this client is
                    # finishing IS the server's current one — adopt it and
                    # keep going.
                    self._epoch = server_epoch
                    continue
                return None, 0
            raise DataServiceClient.rejected_error("get_split", status)

    def _iter_batches(self, repeat: bool) -> Iterator[dict[str, np.ndarray]]:
        while True:
            split, nb = self._next_split(single_epoch=not repeat)
            if split is None:
                return
            self._cur = [split, nb, 0]
            while True:
                cur = self._cur
                if cur is None:
                    break  # lost to another worker across a failover
                if cur[2] >= cur[1]:
                    self._ack = cur[0]
                    self._cur = None
                    break
                status, payload = self._client.call(
                    DSVC_GET_BATCH, name=str(self._wid), a=cur[0], b=cur[2],
                    batch=True,
                )
                if status == END_OF_SPLIT:
                    self._ack = cur[0]
                    self._cur = None
                    break
                if status != OK or payload is None:
                    raise DataServiceClient.rejected_error(
                        f"get_batch({cur[0]},{cur[2]})", status
                    )
                if self._cur is cur:
                    cur[2] += 1
                yield payload

    def batches(
        self, *, repeat: bool = True, prefetch: bool = True,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Ready batches from the server: this worker's FCFS share of each
        epoch's splits.  ``repeat=False`` stops when the epoch the source
        joined rolls over (every split acknowledged by someone).
        ``prefetch`` double-buffers the next pull under the consumer's
        compute."""
        it = self._iter_batches(repeat)
        if not prefetch:
            return it
        pf = _BatchPrefetcher(it)

        def stream():
            try:
                yield from pf
            finally:
                pf.close()

        return stream()


# ----------------------------------------------------------------------------
# Task-role hosting (the runner's `data_service` job)
# ----------------------------------------------------------------------------


def serve_from_dir(
    data_dir: str, *, batch_size: int, seed: int = 0, augment: bool = True,
    port: int = 0, loopback_only: bool = True, cache_splits: int = 4,
    tenant_quotas: dict | None = None,
) -> DataServiceServer:
    """A server over a ``shard-*.npz`` directory: last shard held out as the
    eval chunk (same convention as ``streams.resolve_image_source``), the
    rest served as training splits with the standard image decode/augment
    running server-side."""
    shards = filestream.list_shards(data_dir)
    if not shards:
        raise ValueError(f"no shard files under {data_dir!r} to serve")
    train = shards[:-1] if len(shards) > 1 else shards
    if len(shards) == 1:
        log.warning(
            "data service: single shard — eval REUSES the train shard "
            "(memorization!)"
        )
    return DataServiceServer(
        train,
        batch_size=batch_size,
        decode_fn=filestream.image_decode_fn(augment=augment, seed=seed),
        seed=seed,
        eval_chunk=filestream.load_chunk(shards[-1]),
        port=port,
        loopback_only=loopback_only,
        cache_splits=cache_splits,
        tenant_quotas=tenant_quotas,
        # Advertised so consumers can sanity-check their own seed/augment
        # request against what this pipeline actually runs (streams.py
        # warns on mismatch — the server's settings win).
        info_extra={"seed": seed, "augment": augment},
    )


def host_data_service_task(
    data_dir: str, port: int, *, batch_size: int, seed: int = 0,
    loopback_only: bool = True,
    ps_addrs: list[tuple[str, int]] | None = None,
    lease_poll_s: float = 2.0, ps_layout_version: int = 0,
    tenant_quotas: dict | None = None,
) -> int:
    """Dedicated data-service task body (``--job_name=data_service``): host
    the server until a client signals DSVC_SHUTDOWN (or the supervisor
    dies).  Arms ``die`` fault specs off the server's request counter —
    the deterministic "kill the data server at request N" fault the
    mid-epoch recovery tests inject; a supervisor restart plus the clients'
    re-claim path heals it.

    Elasticity (r14): with ``ps_addrs`` (the coordinator shard's replica
    list, from ``--ps_hosts``), the task WATCHES the membership lease
    registry — a worker whose lease expires or is released has its
    in-flight splits marked reassignable immediately, so the live
    rebalance follows the membership signal instead of waiting out the
    dispatcher's own liveness window."""
    server = serve_from_dir(
        data_dir, batch_size=batch_size, seed=seed, port=port,
        loopback_only=loopback_only, tenant_quotas=tenant_quotas,
    )
    faults.arm_process_faults(
        request_count_fn=server.request_count, leave_fn=server.stop,
    )
    watcher = None
    if ps_addrs:
        from ..parallel import membership

        def _member_left(m: dict) -> None:
            # Worker member ids carry their numeric wid as a trailing
            # index ("worker3"); members without one have no dispatcher
            # state to reassign.  The mark is scoped to the departed
            # member's tenant (r20): one tenant's lease expiry can never
            # reassign another tenant's splits.
            wid = membership.member_index(m["member"])
            if wid is not None:
                server.mark_worker_stale(wid, tenant=m.get("tenant"))

        try:
            # follow_epoch (r15): a live PS reshard moves the lease
            # registry to the new layout's coordinator; the watcher chases
            # the committed epoch so split reassignment keeps following
            # the membership signal across an N→M transition.
            watcher = membership.LeaseWatcher(
                list(ps_addrs), kind="worker", poll_s=lease_poll_s,
                on_leave=_member_left, follow_epoch=True,
                layout_version=ps_layout_version,
            )
        except (OSError, RuntimeError):
            log.warning(
                "data service: lease registry at %s unreachable; falling "
                "back to the liveness-window reassignment only", ps_addrs,
            )
    log.info(
        "data service task on port %d (%d splits%s; blocking until shutdown)",
        server.port, len(server._splits),
        ", watching worker leases" if watcher is not None else "",
    )
    supervised = os.environ.get("DTX_DSVC_SUPERVISED") == "1"
    ppid0 = os.getppid()
    try:
        while not server.shutdown_requested.wait(timeout=2.0):
            if supervised and os.getppid() != ppid0:
                log.warning("data service task: supervisor died; exiting")
                break
        bound = server.port
    finally:
        # Every exit (shutdown, supervisor death, or an exception out of
        # the wait loop) stops the watcher's poll thread and client: a
        # leaked watcher keeps dialing the PS forever.
        if watcher is not None:
            watcher.close()
        server.stop()
    return bound
