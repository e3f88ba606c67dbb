"""dtxcore — the unified async server runtime (r17 tentpole).

Before this module every host service ran its own hand-rolled
thread-per-connection server: the native PS (``native/ps_server.cc``), the
data service (``data/data_service.py``) and the serving replicas
(``serve/model_server.py``) each re-implemented accept loops, HELLO
answer/reject paths, STATS plumbing, request-counter exclusion and
graceful stop — and every idle connection pinned a handler thread.  The
TensorFlow architecture paper (PAPERS.md, arxiv 1605.08695) runs every
session type on ONE runtime; ``parallel/wire.py`` already unified the
framing half of that story.  This module finishes the server half for the
Python services:

- **Readiness-driven I/O** — one selector thread (epoll/kqueue via
  :mod:`selectors`) owns every socket: it accepts, reads request frames
  incrementally (the shared ``wire.py`` frame layout, parsed by an
  allocation-light state machine instead of blocking ``recv_exact``
  calls), and flushes buffered responses.  256 idle connections cost 256
  file descriptors and nothing else — no thread, no stack, no scheduler
  pressure.
- **Connection registry** — every live connection is a :class:`CoreConn`
  with its own parse state and write buffer; ``live_conns`` is a real
  count, not a best-effort list the handler threads race to maintain.
- **Bounded handler pool** — complete frames dispatch to a fixed worker
  pool (``workers=``).  Handlers return the reply (or go async via
  :data:`ASYNC` + :meth:`CoreConn.reply` for work that completes on
  another thread, e.g. the serve micro-batcher), so concurrency is
  bounded by the pool, never by the connection count.
- **Per-connection write buffering** — replies are queued on the
  connection and flushed by the selector as the peer drains them.  A
  slow or stalled reader accumulates bytes, it never wedges a handler
  thread in ``sendall``; a peer holding more than
  ``max_buffered_bytes`` that has also drained NOTHING for
  ``slow_reader_grace_s`` is dropped (progress-gated, so one
  legitimately large reply streaming to a healthy reader is never cut).
- **Per-service handler table keyed off the HELLO service tag** — a core
  hosts one or more services; the client's announced service identity
  (``wire.pack_hello_b(service=...)``) routes the connection, and every
  wrong-service dial is refused through the one shared
  ``wire.hello_answer`` path, naming what was actually reached.
- **Uniform accounting** — the request counter (the ``die:after_reqs``
  fault trigger and an exported metric) lives HERE, excluding
  control-plane ops from the one ``wire.CONTROL_OPS`` registry (each
  service passes its derived frozenset), plus an optional per-service
  ``counts_fn`` for rules an op code alone cannot carry (the dsvc
  negative-id REGISTER probe).  One STATS shape: every service folds
  :meth:`ServerCore.core_stats` into its scrape, so ``requests`` /
  ``live_conns`` mean the same thing on every wire (the native PS keeps
  its C++ loop but answers the same shape — asserted by test).
- **Hardened accept path** — transient ``ECONNABORTED`` is skipped;
  descriptor exhaustion (``EMFILE``/``ENFILE``) logs, backs off and
  resumes — it never kills the listener.
- **Graceful drain** — :meth:`drain` stops accepting, lets dispatched
  handlers finish and write buffers flush, then :meth:`stop` closes;
  zero in-flight requests are dropped on a clean shutdown.
- **Admission control** (r18) — the request plane degrades GRACEFULLY
  instead of collapsing.  The dispatch queue is BOUNDED
  (``max_dispatch_depth``): past it, new data-plane frames are answered
  the typed ``wire.RETRY_LATER_BASE`` shed status (backoff hint packed
  into the status) instead of queueing unboundedly.  Each request
  carries a QUEUE DEADLINE — the smaller of the service's
  ``queue_deadline_s`` policy and the deadline the CALLER stamped into
  the frame (``wire.DEADLINE_FLAG``, the r18 deadline-propagation wire) —
  and a request that waited past it is shed before a worker touches it
  (checked at dequeue AND swept ~1/s by the selector loop, so wedged
  workers cannot strand queued requests unanswered).  Each connection
  holds at most ``max_inflight_per_conn`` dispatched-unanswered
  requests; pipelined excess is shed, with per-connection response
  ORDER preserved by sequence-parked replies.  PRIORITY CLASSES:
  control/observability ops (the service's ``control_ops``, derived
  from ``wire.CONTROL_OPS`` — HELLO, STATS, LEASE_*, ...) are NEVER
  shed: they bypass every admission bound, ride a priority queue the
  workers prefer, and one DEDICATED control worker serves them even
  when every regular worker is wedged — under saturation the cluster
  stays observable and leases keep renewing, so overload cannot cascade
  into false member expiry.  Shed counters (``shed_total``,
  ``queue_deadline_drops``, ``shed_dispatch_full``,
  ``shed_inflight_cap``) fold into :meth:`core_stats`.

The native PS keeps its C++ thread-per-connection loop (its handlers are
microseconds of mutex-guarded C++, not milliseconds of Python, so the
thread count is a non-issue there); this module is the single Python
definition of server behavior, and the cross-service tests pin the C++
side to the same observable semantics.
"""

from __future__ import annotations

import errno
import logging
import queue
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable

from . import tenancy, wire

log = logging.getLogger("dtx.server_core")

#: Sentinel a handler returns when it will reply later (from another
#: thread) via :meth:`CoreConn.reply` — the batcher-callback shape.
ASYNC = object()

#: accept() errnos that are per-connection transients: the aborted peer is
#: gone, the listener is fine — skip and keep accepting.
_ACCEPT_TRANSIENT = {errno.ECONNABORTED, errno.EINTR, errno.EPROTO, errno.EPERM}

#: Upper bound on one request frame (name + payload); a frame announcing
#: more than this is a corrupt/malicious peer and the connection drops.
MAX_FRAME_BYTES = 1 << 30


class Service:
    """One entry in the core's handler table.

    ``handler(conn, op, name, a, b, payload) -> (status, bufs) | ASYNC``
    runs on a pool worker; ``payload`` is the request's raw payload as a
    bytes-like buffer (empty when none; treat it as read-only).
    Returning :data:`ASYNC` means the handler handed the frame to
    another thread which will call ``conn.reply`` exactly once.

    ``control_ops``   op codes excluded from the request counter — derive
                      it from ``wire.CONTROL_OPS`` (the one registry; the
                      dtxlint control pass pins the derivation sites).
    ``counts_fn``     optional extra exclusion an op code cannot express
                      (``fn(op, name, a, b) -> bool``; False = uncounted).
    ``error_status``  the status replied when a handler raises.
    ``accept_dtypes`` HELLO dtype codes this service negotiates.
    ``max_payload``   per-service request-payload bound, checked the
                      moment a frame HEADER completes — an announced
                      payload past it drops the connection BEFORE any
                      byte of it is buffered, so a bogus length costs
                      nothing (size it to the service's real needs:
                      small for payload-less wires like dsvc, batch-
                      sized for predict).

    Admission policy (r18; control ops are exempt from all three):

    ``queue_deadline_s``      how long a dispatched request may WAIT for
                              a worker before it is shed with
                              RETRY_LATER (None = only the caller's
                              stamped deadline applies; the effective
                              budget is the min of the two).
    ``max_inflight_per_conn`` dispatched-unanswered requests one
                              connection may hold; pipelined excess is
                              shed (order-preserving), so one aggressive
                              peer cannot monopolize the dispatch queue.
    ``retry_after_ms``        the backoff hint shed answers carry
                              (``wire.retry_later_status``).
    ``tenant_of``             multi-tenancy (r20): ``fn(op, name, a, b)
                              -> tenant`` attributes each data-plane
                              frame to its tenant (off the key prefix /
                              name tag the service's wire carries); None
                              = every frame is the default tenant.  The
                              tenant keys the core's weighted-fair
                              dispatch and per-tenant quotas.
    """

    __slots__ = (
        "name", "handler", "control_ops", "counts_fn", "error_status",
        "accept_dtypes", "max_payload", "on_disconnect",
        "queue_deadline_s", "max_inflight_per_conn", "retry_after_ms",
        "hello_extra", "tenant_of",
    )

    def __init__(
        self, name: str, handler: Callable, *,
        control_ops: frozenset[int] = frozenset(),
        counts_fn: Callable | None = None, error_status: int = -2,
        accept_dtypes: tuple[int, ...] = (0,),
        max_payload: int = MAX_FRAME_BYTES,
        on_disconnect: Callable | None = None,
        queue_deadline_s: float | None = None,
        max_inflight_per_conn: int = 16,
        retry_after_ms: int = 50,
        hello_extra: Callable | None = None,
        tenant_of: Callable | None = None,
    ):
        if name not in wire.SERVICE_IDS:
            raise ValueError(
                f"unknown service {name!r} (wire.SERVICE_IDS has "
                f"{sorted(wire.SERVICE_IDS)})"
            )
        self.name = name
        self.handler = handler
        self.control_ops = frozenset(control_ops)
        self.counts_fn = counts_fn
        self.error_status = error_status
        self.accept_dtypes = tuple(accept_dtypes)
        self.max_payload = min(int(max_payload), MAX_FRAME_BYTES)
        self.on_disconnect = on_disconnect
        self.queue_deadline_s = (
            None if queue_deadline_s is None else float(queue_deadline_s)
        )
        self.max_inflight_per_conn = max(1, int(max_inflight_per_conn))
        self.retry_after_ms = max(0, int(retry_after_ms))
        # Extra bytes appended to the HELLO success tag (the msrv model-
        # version word, r19): called per HELLO on the selector thread, so
        # it must be cheap and never raise.
        self.hello_extra = hello_extra
        self.tenant_of = tenant_of


class CoreConn:
    """One live connection: parse state + write buffer + identity.

    Responses are SEQUENCE-ORDERED (r18): every parsed frame gets the
    connection's next sequence number, replies park in ``parked`` until
    every earlier sequence has answered, and only then flush into the
    write buffer — so concurrent handlers (up to the per-connection
    in-flight cap) and immediate shed answers can never reorder the
    response stream of a pipelining peer."""

    __slots__ = (
        "core", "sock", "fd", "service", "rbuf", "pending", "pbuf", "pfill",
        "out", "out_bytes", "inflight", "next_seq", "next_out", "parked",
        "closed", "events", "peer", "last_progress",
    )

    def __init__(self, core: "ServerCore", sock: socket.socket, service):
        self.core = core
        self.sock = sock
        self.fd = sock.fileno()
        self.service = service  # Service | None (resolved at HELLO)
        self.rbuf = bytearray()
        # Mid-payload parse state: once a frame HEADER completes, the
        # payload fills a dedicated preallocated buffer — the bulk is
        # recv_into'd straight into it (one copy, no rbuf growth, no
        # re-copy on the selector thread).
        self.pending = None  # (op, name, a, b, deadline_ms) awaiting payload
        self.pbuf: bytearray | None = None
        self.pfill = 0
        self.out: deque = deque()  # memoryviews awaiting the selector flush
        self.out_bytes = 0
        self.inflight = 0  # dispatched frames awaiting their replies
        self.next_seq = 0  # sequence assigned to the next parsed frame
        self.next_out = 0  # next sequence allowed onto the wire
        self.parked: dict[int, list] = {}  # seq -> encoded reply views
        self.closed = False
        self.events = 0  # selector interest currently registered
        self.last_progress = time.monotonic()  # last byte the peer drained
        try:
            self.peer = sock.getpeername()
        except OSError:
            self.peer = ("?", 0)


class _ReplyHandle:
    """The per-request ``conn`` a handler receives: :meth:`reply` is bound
    to that request's response SLOT in the connection's ordered stream
    (thread-safe, callable from any thread — the async batcher-callback
    shape), and everything else delegates to the underlying
    :class:`CoreConn`.  A second reply to the same slot is a no-op, so a
    timeout sweep racing the genuine resolution stays safe."""

    __slots__ = ("_conn", "_seq")

    def __init__(self, conn: CoreConn, seq: int):
        self._conn = conn
        self._seq = seq

    def reply(self, status: int, bufs: list | None = None) -> None:
        """Queue this request's response frame.  The selector thread
        flushes it (in sequence order) as the peer drains — the caller
        NEVER blocks on the peer's read speed."""
        self._conn.core._queue_reply(
            self._conn, self._seq, status, bufs, dispatched=True
        )

    def __getattr__(self, item):
        return getattr(self._conn, item)


class ServerCore:
    """The selector-driven server runtime.  Construct, :meth:`add_service`,
    :meth:`start`; tear down with :meth:`stop` (drains first)."""

    def __init__(
        self, *, port: int = 0, loopback_only: bool = True,
        workers: int = 8, backlog: int = 128, name: str = "core",
        accept_backoff_s: float = 0.2, max_buffered_bytes: int = 256 << 20,
        slow_reader_grace_s: float = 30.0, bind_retry_s: float = 5.0,
        max_dispatch_depth: int = 512,
        tenant_quotas: dict[str, tenancy.TenantQuota] | None = None,
    ):
        self.name = name
        self._services: dict[str, Service] = {}
        self._default: Service | None = None
        self._n_workers = max(1, int(workers))
        self._accept_backoff_s = accept_backoff_s
        self._max_buffered = int(max_buffered_bytes)
        self._slow_grace_s = float(slow_reader_grace_s)
        self._max_dispatch_depth = max(1, int(max_dispatch_depth))
        self._next_slow_sweep = 0.0
        self._next_deadline_sweep = 0.0
        self._lock = threading.Lock()
        self._requests = 0
        self._accepts = 0
        self._accept_errors = 0
        self._dispatched = 0
        self._handler_errors = 0
        self._dropped_slow = 0
        # Shed accounting (r18): every admission refusal, by cause.
        self._shed_total = 0
        self._shed_dispatch_full = 0
        self._shed_inflight_cap = 0
        self._shed_quota = 0
        self._queue_deadline_drops = 0
        self._conns: dict[int, CoreConn] = {}
        self._dirty: queue.SimpleQueue = queue.SimpleQueue()
        # Two dispatch lanes under one condition: control-plane frames ride
        # the PRIORITY deque (never shed, preferred by every worker, owned
        # outright by the dedicated control worker); data-plane frames ride
        # PER-TENANT deques (r20) drained by STRIDE scheduling — each pop
        # advances the winning tenant's virtual time by 1/weight, so under
        # contention a weight-2 tenant drains twice as fast as a weight-1
        # tenant, an idle tenant costs nothing, and a newly-busy tenant
        # re-enters at the current virtual clock (no burst catch-up).  The
        # core-wide dispatch bound (``max_dispatch_depth``) spans ALL
        # tenant deques; ``tenant_quotas`` layers per-tenant in-flight /
        # queued caps on top (a tenant at quota is shed RETRY_LATER while
        # other tenants' traffic flows).  Pre-tenant posture is exactly
        # one "default" deque — byte-identical behavior.
        self._tasks_cond = threading.Condition()
        self._tenant_tasks: dict[str, deque] = {}
        self._tenant_vtime: dict[str, float] = {}
        self._vclock = 0.0
        self._ntasks = 0  # queued data-plane frames across all tenants
        self._ptasks: deque = deque()
        self._tenant_quotas = dict(tenant_quotas or {})
        # Per-tenant accounting (guarded by self._lock): request/shed
        # counters + live in-flight, keyed lazily as tenants appear.
        self._tenant_counters: dict[str, dict] = {}
        # (conn.fd, seq) -> tenant for every admitted-undispatched or
        # dispatched-unanswered frame, so the reply path can decrement
        # the right tenant's in-flight count.
        self._task_tenant: dict[tuple[int, int], str] = {}
        self._workers_stop = False
        self._stop_flag = False
        self._draining = False
        self._listener_retired = False
        self._accept_paused_until: float | None = None
        self._started = False
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # A supervised restart rebinds the dead incarnation's FIXED port;
        # lingering sockets can hold it briefly — retry within a short
        # window instead of failing the healing restart (the same posture
        # every pre-core server took).
        bind_deadline = time.monotonic() + (bind_retry_s if port else 0.0)
        while True:
            try:
                self._listener.bind(("127.0.0.1" if loopback_only else "", port))
                break
            except OSError:
                if time.monotonic() >= bind_deadline:
                    self._listener.close()
                    self._wake_r.close()
                    self._wake_w.close()
                    raise
                time.sleep(0.2)
        self._listener.listen(backlog)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self._threads: list[threading.Thread] = []

    # -- wiring ---------------------------------------------------------------

    def add_service(self, service: Service, *, default: bool = False) -> None:
        if self._started:
            raise RuntimeError("add_service before start()")
        self._services[service.name] = service
        if default or self._default is None:
            self._default = service

    def start(self) -> "ServerCore":
        if not self._services:
            raise RuntimeError("ServerCore needs at least one service")
        self._started = True
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        t = threading.Thread(
            target=self._select_loop, daemon=True, name=f"dtx-{self.name}-io"
        )
        t.start()
        self._threads.append(t)
        for i in range(self._n_workers):
            w = threading.Thread(
                target=self._worker, daemon=True,
                name=f"dtx-{self.name}-w{i}",
            )
            w.start()
            self._threads.append(w)
        # The dedicated control worker (r18): serves ONLY the priority
        # lane, so control/observability ops are answered even when every
        # regular worker is wedged inside a slow handler — the cluster
        # stays observable at exactly the moment that matters.
        ctl = threading.Thread(
            target=self._worker, kwargs={"control_only": True}, daemon=True,
            name=f"dtx-{self.name}-ctl",
        )
        ctl.start()
        self._threads.append(ctl)
        log.info(
            "%s core on port %d (%d services, %d workers)",
            self.name, self.port, len(self._services), self._n_workers,
        )
        return self

    # -- accounting -----------------------------------------------------------

    def request_count(self) -> int:
        """Counted (data-plane) requests so far — the ``die:after_reqs``
        fault trigger, same contract as the native PS server's counter."""
        with self._lock:
            return self._requests

    def live_conns(self) -> int:
        with self._lock:
            return len(self._conns)

    def _tenant_counter_locked(self, tenant: str) -> dict:
        """The per-tenant counter row (created on first sight); caller
        holds ``self._lock``."""
        tc = self._tenant_counters.get(tenant)
        if tc is None:
            tc = self._tenant_counters[tenant] = {
                "requests": 0,
                "inflight": 0,
                "shed_total": 0,
                "shed_inflight_cap": 0,
                "shed_dispatch_full": 0,
                "shed_quota": 0,
                "queue_deadline_drops": 0,
            }
        return tc

    def core_stats(self) -> dict:
        """The uniform runtime-accounting shape every service's STATS
        answer folds in (one definition of what the counters mean)."""
        with self._lock:
            tenants = {}
            for t, tc in self._tenant_counters.items():
                row = dict(tc)
                dq = self._tenant_tasks.get(t)
                row["queued"] = len(dq) if dq else 0
                q = self._tenant_quotas.get(t)
                row["weight"] = q.weight if q else 1.0
                row["max_inflight"] = q.max_inflight if q else 0
                row["max_dispatch"] = q.max_dispatch if q else 0
                tenants[t] = row
            return {
                "requests": self._requests,
                "live_conns": len(self._conns),
                "accepts": self._accepts,
                "accept_errors": self._accept_errors,
                "dispatched": self._dispatched,
                "handler_errors": self._handler_errors,
                "dropped_slow_readers": self._dropped_slow,
                "worker_threads": self._n_workers,
                "dispatch_depth": self._ntasks + len(self._ptasks),
                "max_dispatch_depth": self._max_dispatch_depth,
                # Admission-control sheds (r18), by cause; shed_total is
                # their sum — the externally gated "requests answered
                # RETRY_LATER instead of served" counter.
                "shed_total": self._shed_total,
                "shed_dispatch_full": self._shed_dispatch_full,
                "shed_inflight_cap": self._shed_inflight_cap,
                "shed_quota": self._shed_quota,
                "queue_deadline_drops": self._queue_deadline_drops,
                "draining": 1 if self._draining else 0,
                # Per-tenant breakdown (r20): the same shed vocabulary,
                # per namespace — what dtxtop's tenants section renders.
                "tenants": tenants,
            }

    # -- lifecycle ------------------------------------------------------------

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # pipe already full: the selector is waking anyway

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop accepting, let dispatched handlers finish and response
        buffers flush.  True when everything in flight completed inside
        the window — the zero-dropped-requests graceful half of stop."""
        self._draining = True
        self._wake()
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            with self._lock:
                busy = any(
                    c.inflight or c.out or c.parked
                    for c in self._conns.values()
                )
            if (
                not busy
                and not self._ntasks
                and not self._ptasks
                and (self._listener_retired or not self._started)
            ):
                return True
            time.sleep(0.01)
        return False

    def stop(self, drain_s: float = 5.0) -> None:
        """Drain (bounded), then tear the runtime down and release the
        port before returning."""
        if self._started:
            self.drain(drain_s)
        self._stop_flag = True
        self._draining = True
        self._wake()
        io_thread = self._threads[0] if self._threads else None
        if io_thread is not None:
            io_thread.join(timeout=5.0)
        with self._tasks_cond:
            self._workers_stop = True
            self._tasks_cond.notify_all()
        for t in self._threads[1:]:
            t.join(timeout=5.0)
        # Single-threaded from here: close every socket and the listener.
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.closed = True
            try:
                c.sock.close()
            except OSError:
                pass
        # shutdown() BEFORE close(): close alone does not free the kernel
        # socket while another thread is mid-syscall on it, which would
        # leave the port unavailable to a same-port supervised restart.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    # -- the selector loop ----------------------------------------------------

    def _select_loop(self) -> None:
        while not self._stop_flag:
            timeout = 0.5
            if self._accept_paused_until is not None:
                now = time.monotonic()
                if now >= self._accept_paused_until:
                    self._accept_paused_until = None
                    if not self._draining:
                        try:
                            self._sel.register(
                                self._listener, selectors.EVENT_READ, "accept"
                            )
                        except (KeyError, ValueError, OSError):
                            pass
                else:
                    timeout = min(timeout, self._accept_paused_until - now)
            try:
                events = self._sel.select(timeout)
            except OSError:
                continue
            for key, mask in events:
                tag = key.data
                if tag == "accept":
                    if self._draining:
                        self._retire_listener()
                    else:
                        self._do_accept()
                elif tag == "wake":
                    self._drain_wake()
                else:
                    conn: CoreConn = tag
                    if mask & selectors.EVENT_READ:
                        self._do_read(conn)
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._do_write(conn)
            self._process_dirty()
            self._sweep_slow_readers()
            self._sweep_queue_deadlines()
            if self._draining:
                self._retire_listener()

    def _unregister_listener(self) -> None:
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError, OSError):
            pass

    def _retire_listener(self) -> None:
        """Drain half of shutdown: actually CLOSE the listener (an
        unregister alone leaves the kernel completing handshakes into the
        backlog), so new connections are refused while in-flight work
        finishes.  Idempotent; runs on the selector thread."""
        if self._listener_retired:
            return
        self._listener_retired = True
        self._unregister_listener()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _process_dirty(self) -> None:
        """Connections whose reply() landed since the last pass: flush
        eagerly, update interest, and parse any already-buffered next
        frame (the peer may have pipelined)."""
        while True:
            try:
                conn = self._dirty.get_nowait()
            except queue.Empty:
                return
            if conn.closed:
                continue
            self._do_write(conn)
            if not conn.closed:
                self._pump(conn)

    # -- accept ---------------------------------------------------------------

    def _do_accept(self) -> None:
        for _ in range(64):  # bounded per event: reads must not starve
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if self._stop_flag or self._draining:
                    return
                with self._lock:
                    self._accept_errors += 1
                if e.errno in _ACCEPT_TRANSIENT:
                    # The aborted peer is gone; the listener is fine.
                    continue
                # EMFILE/ENFILE/ENOBUFS/ENOMEM (or anything unexpected):
                # resource exhaustion.  Back off and resume — the one
                # thing the accept path must never do is die and leave a
                # healthy service unreachable forever.
                log.warning(
                    "%s core: accept failed (%s) — backing off %.1fs, "
                    "listener stays up",
                    self.name, e, self._accept_backoff_s,
                )
                self._unregister_listener()
                self._accept_paused_until = (
                    time.monotonic() + self._accept_backoff_s
                )
                return
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                sock.close()
                continue
            conn = CoreConn(
                self, sock,
                self._default if len(self._services) == 1 else None,
            )
            with self._lock:
                self._conns[conn.fd] = conn
                self._accepts += 1
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.events = selectors.EVENT_READ

    # -- read / parse / dispatch ----------------------------------------------

    def _do_read(self, conn: CoreConn) -> None:
        if conn.pbuf is not None and conn.pfill < len(conn.pbuf):
            # Bulk payload path: straight into the frame's preallocated
            # buffer — one kernel-to-user copy, nothing staged in rbuf,
            # trailing pipelined bytes stay in the kernel for later.
            try:
                n = conn.sock.recv_into(memoryview(conn.pbuf)[conn.pfill :])
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(conn)
                return
            if not n:
                self._close_conn(conn)
                return
            conn.pfill += n
            self._pump(conn)
            return
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.rbuf += data
        self._pump(conn)

    @staticmethod
    def _parse_header(buf: bytearray, max_payload: int = MAX_FRAME_BYTES):
        """One complete request HEADER from ``buf``, or None.  Returns
        ``((op, name, a, b, plen, deadline_ms), consumed)`` — the
        incremental twin of ``wire.read_request``'s header half (r18:
        a ``wire.DEADLINE_FLAG``-stamped frame carries the caller's
        remaining per-op deadline after the standard tail; 0 = none).
        The payload bound is enforced HERE, the moment the header
        completes, before any payload byte would be buffered — an absurd
        announced length never costs memory."""
        if len(buf) < 2:
            return None
        nlen = buf[1]
        stamped = bool(buf[0] & wire.DEADLINE_FLAG)
        hdr_end = 2 + nlen + wire.REQ_TAIL.size
        if stamped:
            hdr_end += wire.DEADLINE_TAIL.size
        if len(buf) < hdr_end:
            return None
        a, b, plen = wire.REQ_TAIL.unpack_from(buf, 2 + nlen)
        deadline_ms = 0
        if stamped:
            (deadline_ms,) = wire.DEADLINE_TAIL.unpack_from(
                buf, 2 + nlen + wire.REQ_TAIL.size
            )
        if plen > max_payload:
            raise ValueError(
                f"frame announces {plen} payload bytes (bound {max_payload})"
            )
        name = bytes(buf[2 : 2 + nlen]).decode()
        return (
            (buf[0] & ~wire.DEADLINE_FLAG, name, a, b, plen, deadline_ms),
            hdr_end,
        )

    def _pump(self, conn: CoreConn) -> None:
        """Parse + ADMIT frames from the connection's read buffer (r18).
        Every parsed frame gets the connection's next response sequence;
        admission then either dispatches it (within the per-connection
        in-flight cap and the core-wide dispatch bound) or sheds it with
        the typed RETRY_LATER answer — which parks in sequence order, so
        a pipelining peer's response stream never reorders."""
        while not conn.closed:
            svc = conn.service or self._default
            if conn.pending is None:
                if self._parse_paused(conn):
                    break  # flood guard: stop parsing until replies flush
                try:
                    got = self._parse_header(conn.rbuf, svc.max_payload)
                except (ValueError, struct.error, UnicodeDecodeError):
                    self._close_conn(conn)
                    return
                if got is None:
                    break
                (op, name, a, b, plen, deadline_ms), consumed = got
                del conn.rbuf[:consumed]
                conn.pending = (op, name, a, b, deadline_ms)
                conn.pbuf = bytearray(plen)
                conn.pfill = 0
            # Whatever payload prefix already sits in rbuf moves over;
            # the rest arrives via the direct recv_into path above.
            need = len(conn.pbuf) - conn.pfill
            if need and conn.rbuf:
                take = min(need, len(conn.rbuf))
                conn.pbuf[conn.pfill : conn.pfill + take] = conn.rbuf[:take]
                del conn.rbuf[:take]
                conn.pfill += take
            if conn.pfill < len(conn.pbuf):
                break  # payload still in flight
            op, name, a, b, deadline_ms = conn.pending
            payload = conn.pbuf
            conn.pending, conn.pbuf, conn.pfill = None, None, 0
            seq = conn.next_seq
            conn.next_seq += 1
            if op == wire.HELLO_OP:
                self._handle_hello(conn, seq, a, b)
                continue
            control = op in svc.control_ops
            counted = not control and (
                svc.counts_fn is None or svc.counts_fn(op, name, a, b)
            )
            # Tenant attribution (r20): the service's tenant_of reads the
            # tenant off the frame (key prefix / name tag); anything it
            # cannot attribute — including a buggy hook — is the default
            # tenant, never a dropped frame.
            tenant = tenancy.DEFAULT_TENANT
            if not control and svc.tenant_of is not None:
                try:
                    tenant = svc.tenant_of(op, name, a, b) or tenant
                except Exception:  # noqa: BLE001 — attribution must not kill I/O
                    pass
            shed = None
            with self._lock:
                tc = self._tenant_counter_locked(tenant) if not control else None
                if counted:
                    self._requests += 1
                    tc["requests"] += 1
                if not control:
                    # Admission: control ops bypass every bound (priority
                    # class — never shed), data-plane frames must fit the
                    # per-connection in-flight cap, the core-wide dispatch
                    # bound, and the tenant's own quotas (r20) — a tenant
                    # at quota sheds while other tenants' traffic flows.
                    quota = self._tenant_quotas.get(tenant)
                    dq = self._tenant_tasks.get(tenant)
                    if conn.inflight >= svc.max_inflight_per_conn:
                        self._shed_inflight_cap += 1
                        self._shed_total += 1
                        tc["shed_inflight_cap"] += 1
                        tc["shed_total"] += 1
                        shed = svc.retry_after_ms
                    elif self._ntasks >= self._max_dispatch_depth:
                        self._shed_dispatch_full += 1
                        self._shed_total += 1
                        tc["shed_dispatch_full"] += 1
                        tc["shed_total"] += 1
                        shed = svc.retry_after_ms
                    elif quota is not None and (
                        (
                            quota.max_inflight
                            and tc["inflight"] >= quota.max_inflight
                        )
                        or (
                            quota.max_dispatch
                            and dq is not None
                            and len(dq) >= quota.max_dispatch
                        )
                    ):
                        self._shed_quota += 1
                        self._shed_total += 1
                        tc["shed_quota"] += 1
                        tc["shed_total"] += 1
                        shed = svc.retry_after_ms
                if shed is None:
                    self._dispatched += 1
                    conn.inflight += 1
                    if tc is not None:
                        tc["inflight"] += 1
                        self._task_tenant[(conn.fd, seq)] = tenant
            if shed is not None:
                self._queue_reply(
                    conn, seq, wire.retry_later_status(shed), None,
                    dispatched=False,
                )
                continue
            # The queue-deadline budget: the smaller of the service's
            # policy and the deadline the caller stamped on the wire —
            # a request that waits past it is shed before a worker
            # touches it (dequeue check + the selector's ~1/s sweep).
            budget = svc.queue_deadline_s
            if deadline_ms:
                stamped_s = deadline_ms / 1e3
                budget = stamped_s if budget is None else min(budget, stamped_s)
            t_shed = None if budget is None else time.monotonic() + budget
            task = (conn, svc, seq, t_shed, tenant, (op, name, a, b, payload))
            with self._tasks_cond:
                if control:
                    self._ptasks.append(task)
                else:
                    dq = self._tenant_tasks.get(tenant)
                    if dq is None:
                        dq = self._tenant_tasks[tenant] = deque()
                        self._tenant_vtime.setdefault(tenant, 0.0)
                    if not dq:
                        # Re-entering tenant starts at the current virtual
                        # clock: idle time earns no burst credit.
                        self._tenant_vtime[tenant] = max(
                            self._tenant_vtime[tenant], self._vclock
                        )
                    dq.append(task)
                    self._ntasks += 1
                # notify_all, not notify: a single notify can be consumed
                # by the CONTROL-ONLY worker, which cannot take a regular
                # task and would strand it until the 0.5s wait timeout.
                self._tasks_cond.notify_all()
        self._update_interest(conn)

    def _handle_hello(self, conn: CoreConn, seq: int, a: int, b: int) -> None:
        """HELLO answered inline on the selector thread (no payload, no
        handler work): the announced service identity routes the
        connection through the handler table; every mismatch goes
        through the one shared ``wire.hello_answer`` refusal."""
        expected = wire.hello_expected_service(b)
        svc = self._services.get(expected) or conn.service or self._default
        status, tag = wire.hello_answer(
            a, b, service=svc.name, accept_dtypes=svc.accept_dtypes
        )
        if status == wire.WIRE_VERSION:
            conn.service = svc
            if tag and svc.hello_extra is not None:
                tag = tag + svc.hello_extra()
        self._queue_reply(
            conn, seq, status, [tag] if tag else None, dispatched=False
        )

    def _queue_reply(
        self, conn: CoreConn, seq: int, status: int, bufs: list | None, *,
        dispatched: bool,
    ) -> None:
        """Park one response at its sequence slot and flush every
        now-contiguous reply into the write buffer (thread-safe; the one
        reply path for sync returns, async callbacks, HELLO and sheds).
        Encoding happens BEFORE any state changes, so a buffer the wire
        cannot encode raises to the caller with the slot still open —
        the caller's error reply is then the slot's first (and only)
        frame.  A second reply to an answered slot is a no-op."""
        views = wire.frames_to_views([
            wire.RESP_HDR.pack(status, wire.encoded_nbytes(bufs or [])),
            *(bufs or []),
        ])
        total = sum(len(v) for v in views)
        with self._lock:
            if conn.closed:
                return
            if seq < conn.next_out or seq in conn.parked:
                return  # already answered (idempotent late resolve)
            conn.parked[seq] = views
            # Parked bytes count toward the slow-reader bound: they are
            # committed response memory whether or not flushable yet.
            conn.out_bytes += total
            if dispatched:
                conn.inflight -= 1
                t = self._task_tenant.pop((conn.fd, seq), None)
                if t is not None:
                    tc = self._tenant_counters.get(t)
                    if tc is not None and tc["inflight"] > 0:
                        tc["inflight"] -= 1
            while conn.next_out in conn.parked:
                conn.out.extend(conn.parked.pop(conn.next_out))
                conn.next_out += 1
        self._dirty.put(conn)
        self._wake()

    def _shed_task(self, task, *, cause: str) -> None:
        """Answer one queued task RETRY_LATER without running its handler
        (the queue-deadline drop path; counted by cause, globally and on
        the owning tenant's row)."""
        conn, svc, seq, _t_shed, tenant, _req = task
        with self._lock:
            self._shed_total += 1
            tc = self._tenant_counter_locked(tenant)
            tc["shed_total"] += 1
            if cause == "queue_deadline":
                self._queue_deadline_drops += 1
                tc["queue_deadline_drops"] += 1
        self._queue_reply(
            conn, seq, wire.retry_later_status(svc.retry_after_ms), None,
            dispatched=True,
        )

    def _sweep_queue_deadlines(self) -> None:
        """Shed queued data-plane requests whose deadline budget expired
        while they WAITED (~1/s, on the selector thread): even with every
        worker wedged, an abandoned request gets its RETRY_LATER answer
        instead of silently aging in the queue.  The dequeue-time check
        in the worker covers the fast path; this sweep covers the
        pathological one."""
        now = time.monotonic()
        if now < self._next_deadline_sweep:
            return
        self._next_deadline_sweep = now + 1.0
        expired: list = []
        with self._tasks_cond:
            if not self._ntasks:
                return
            for tenant, dq in self._tenant_tasks.items():
                if not dq:
                    continue
                keep: deque = deque()
                for task in dq:
                    t_shed = task[3]
                    if t_shed is not None and now > t_shed:
                        expired.append(task)
                    else:
                        keep.append(task)
                if len(keep) != len(dq):
                    self._tenant_tasks[tenant] = keep
            self._ntasks -= len(expired)
        for task in expired:
            self._shed_task(task, cause="queue_deadline")

    # -- write ----------------------------------------------------------------

    def _do_write(self, conn: CoreConn) -> None:
        while conn.out:
            head = conn.out[0]
            try:
                n = conn.sock.send(head)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(conn)
                return
            if n:
                conn.last_progress = time.monotonic()
            with self._lock:
                conn.out_bytes -= n
            if n < len(head):
                conn.out[0] = head[n:]
                break
            conn.out.popleft()
        self._update_interest(conn)

    def _sweep_slow_readers(self) -> None:
        """Drop peers that hold more than ``max_buffered_bytes`` of
        undelivered response AND have drained nothing for
        ``slow_reader_grace_s`` — a stalled scraper must not hold server
        memory hostage (resilient clients reconnect).  The progress
        condition is what distinguishes a stall from one legitimately
        large reply streaming to a healthy reader: size alone must never
        drop a connection the peer is actively draining."""
        now = time.monotonic()
        if now < self._next_slow_sweep:
            return
        self._next_slow_sweep = now + 1.0
        with self._lock:
            over = [
                c for c in self._conns.values()
                if c.out_bytes > self._max_buffered
                and now - c.last_progress > self._slow_grace_s
            ]
        for conn in over:
            log.warning(
                "%s core: dropping %s — %d bytes buffered past the "
                "%d-byte bound with no read progress for %.0fs",
                self.name, conn.peer, conn.out_bytes, self._max_buffered,
                now - conn.last_progress,
            )
            with self._lock:
                self._dropped_slow += 1
            self._close_conn(conn)

    @staticmethod
    def _parse_paused(conn: CoreConn) -> bool:
        """Whether this connection's parse is paused (kernel
        backpressure): too many replies parked out-of-order, or too many
        frames in flight.  The in-flight bound matters for CONTROL ops —
        they are never shed, so a peer pipelining STATS/LEASE_* at line
        rate must be slowed by the socket, not grow the priority lane
        unboundedly.  Data-plane frames hit the (much smaller) admission
        caps first; this is the outer memory bound."""
        return len(conn.parked) >= 256 or conn.inflight >= 256

    def _update_interest(self, conn: CoreConn) -> None:
        if conn.closed:
            return
        want = 0
        # Reading stays on even at the data-plane in-flight cap — excess
        # frames are SHED (admission control), not kernel-back-pressured;
        # only the parse-pause flood bounds (parked replies / total
        # in-flight frames) stop the read.
        if not self._parse_paused(conn):
            want |= selectors.EVENT_READ
        if conn.out:
            want |= selectors.EVENT_WRITE
        if want == conn.events:
            return
        try:
            if conn.events == 0 and want:
                self._sel.register(conn.sock, want, conn)
            elif want == 0:
                self._sel.unregister(conn.sock)
            else:
                self._sel.modify(conn.sock, want, conn)
            conn.events = want
        except (KeyError, ValueError, OSError):
            self._close_conn(conn)

    def _close_conn(self, conn: CoreConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        with self._lock:
            self._conns.pop(conn.fd, None)
            conn.out.clear()
            conn.parked.clear()
            conn.out_bytes = 0
            # Release the dead connection's per-tenant in-flight slots —
            # its replies will never come back through _queue_reply (and
            # the fd may be reused by a future connection's key space).
            stale = [k for k in self._task_tenant if k[0] == conn.fd]
            for k in stale:
                tc = self._tenant_counters.get(self._task_tenant.pop(k))
                if tc is not None and tc["inflight"] > 0:
                    tc["inflight"] -= 1
        if conn.events:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.events = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        svc = conn.service or self._default
        if svc is not None and svc.on_disconnect is not None:
            try:
                svc.on_disconnect(conn)
            except Exception:  # noqa: BLE001 — a cleanup hook never kills I/O
                log.exception("%s core: on_disconnect hook failed", self.name)

    # -- the worker pool ------------------------------------------------------

    def _pop_fair_locked(self):
        """Stride-scheduled pop across the tenant deques (caller holds
        ``_tasks_cond``): the non-empty tenant with the smallest virtual
        time wins, and its clock advances by 1/weight — proportional
        share under contention, zero cost while idle.  None = no
        data-plane work queued."""
        best = None
        for t, dq in self._tenant_tasks.items():
            if dq and (
                best is None or self._tenant_vtime[t] < self._tenant_vtime[best]
            ):
                best = t
        if best is None:
            return None
        quota = self._tenant_quotas.get(best)
        self._tenant_vtime[best] += 1.0 / (quota.weight if quota else 1.0)
        self._vclock = self._tenant_vtime[best]
        self._ntasks -= 1
        return self._tenant_tasks[best].popleft()

    def _next_task(self, control_only: bool):
        """Pop the next task: the priority lane first (every worker), the
        weighted-fair tenant lanes only for regular workers.  None =
        shutting down."""
        with self._tasks_cond:
            while True:
                if self._workers_stop:
                    return None
                if self._ptasks:
                    return self._ptasks.popleft()
                if not control_only:
                    task = self._pop_fair_locked()
                    if task is not None:
                        return task
                self._tasks_cond.wait(timeout=0.5)

    def _worker(self, control_only: bool = False) -> None:
        while True:
            item = self._next_task(control_only)
            if item is None:
                return
            conn, svc, seq, t_shed, _tenant, (op, name, a, b, payload) = item
            if conn.closed:
                continue
            if t_shed is not None and time.monotonic() > t_shed:
                # The request waited past its queue-deadline budget: the
                # caller has (or is about to have) abandoned it — shed
                # BEFORE the handler burns a worker on dead work.
                self._shed_task(item, cause="queue_deadline")
                continue
            handle = _ReplyHandle(conn, seq)
            try:
                # The unpack and the reply encode stay INSIDE the guard:
                # a malformed handler return (or a buffer reply() cannot
                # encode) must answer the same loud per-op error — an
                # escape here would kill the pool worker and wedge the
                # connection in flight forever.
                out = svc.handler(handle, op, name, a, b, payload)
                if out is ASYNC:
                    continue
                status, bufs = out
                handle.reply(status, bufs)
            except Exception:
                # A handler bug must surface as a LOUD per-op error on
                # the client, not a silent connection close the client
                # burns its reconnect budget retrying (the shared posture
                # all pre-core servers converged on).
                log.exception(
                    "%s core: %s op %d (%s) failed server-side",
                    self.name, svc.name, op, name,
                )
                with self._lock:
                    self._handler_errors += 1
                handle.reply(svc.error_status, None)
