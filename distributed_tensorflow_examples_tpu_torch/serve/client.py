"""Resilient serving clients: per-replica transport + replica pool (r10).

:class:`ServeClient` is the PS client's discipline applied to the serving wire —
per-op deadlines, exponential-backoff reconnect bounded by
``reconnect_deadline_s``, ``DTX_FAULT_PLAN`` injection under the client
role ``<role>_sv`` — over the shared ``parallel/wire.py`` framing with the
``msrv`` HELLO service identity (a wrong-service dial fails loudly naming
both ends).  Predict is PURE (same inputs, same published params, same
outputs), so replaying it after a reconnect is always safe — the simplest
replay story of the three wires.

:class:`ServePool` is the load-balancing layer: round-robin over N
replicas, with unhealthy-replica EJECTION (a transport failure benches the
replica for ``eject_s`` and the request retries on a peer immediately) and
explicit backoff on OVERLOAD / NO_MODEL answers (admission control means
the replica is alive but shedding — rotate, don't hammer).  Under a
replica kill + supervised restart, the pool absorbs the gap: requests keep
succeeding on the surviving replicas, and the healed replica rejoins the
rotation when its ejection expires — the "zero failed client requests"
contract the fault tests pin.

The port's copy of ``distributed_tensorflow_examples_tpu/serve/client.py``
(same wire, so either package's client talks to either package's replica),
with the stepped decode ops (``decode_open``/``next``/``close``) and
:meth:`ServeClient.generate` over them; a predict-only replica's
``NO_DECODER`` answer maps to its typed error.

r18 (graceful degradation): both layers run the shared retry discipline
(``parallel/retry.py``).  A replica's RETRY_LATER shed answer carries its
own backoff hint in the status; the pool HONORS it — the shedding replica
benches for the hinted window and, once a rotation sweep has seen only
sheds (pool-WIDE overload), the next attempt waits a jittered hint first
instead of re-hammering the rotation at line rate (rotation must not
amplify an overload).  Transport replays and shed retries spend a
token-bucket retry budget; per-address circuit breakers fail dead peers
fast; every backoff is jittered so recovering clients decorrelate.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np

from ..parallel import retry, tenancy, wire
from ..utils import faults, telemetry
from ..utils.metrics import LatencyRecorder
from .model_server import (
    BAD_SESSION, ERR, NO_DECODER, NO_MODEL, OVERLOAD, SRV_DECODE_CLOSE,
    SRV_DECODE_NEXT, SRV_DECODE_OPEN, SRV_PREDICT, SRV_SHUTDOWN, SRV_STATS,
)


class ServeError(RuntimeError):
    """A serving op failed terminally (transport unrecoverable or the
    replica rejected the request)."""


class ServeDeadlineError(ServeError):
    """Reconnect/retry budget exhausted: no replica answered in time."""


class ServeOverloadError(ServeError):
    """The replica's admission control refused the request (queue full):
    back off or try another replica.  ``retry_after_s`` is the backoff
    hint the shed answer carried (r18: the RETRY_LATER band packs it into
    the status; the legacy OVERLOAD code point carries none → 0.0)."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServeUnavailableError(ServeError):
    """The replica is up but has not pulled a published snapshot yet
    (warming after a restart, or the chief has not published)."""


class ServeRejectedError(ServeError):
    """The replica ANSWERED and rejected the request itself (malformed
    inputs, apply error) — the transport is fine and every peer would
    answer the same, so pools must surface this to the caller instead of
    ejecting the healthy replica and replaying the bad request."""


class ServeSessionError(ServeError):
    """A decode session id the replica no longer knows (expired by the
    idle sweep, lost to a replica restart, or never existed) — the caller
    re-opens a session rather than retrying the poll."""


class ServeClient:
    """One TCP connection to a model replica (requests serialized on it).

    Fault-plan role: ``<process role>_sv`` by default, so ``DTX_FAULT_PLAN``
    specs can target serving connections specifically (``role=client0_sv``)
    while broad globs still match every transport of a process.
    """

    def __init__(
        self, host: str, port: int, *, op_timeout_s: float | None = 30.0,
        reconnect_deadline_s: float = 60.0, backoff_s: float = 0.25,
        role: str | None = None, tenant: str = tenancy.DEFAULT_TENANT,
    ):
        self._host, self._port = host, port
        # The tenant every request of this client is tagged with (r20):
        # the default tenant tags nothing — byte-identical frames against
        # any pre-tenant replica.
        self.tenant = (
            tenant if tenant == tenancy.DEFAULT_TENANT
            else tenancy.check_tenant(tenant)
        )
        self._op_timeout = op_timeout_s
        self._reconnect_deadline = reconnect_deadline_s
        self._backoff = backoff_s
        self.role = role if role is not None else (
            (faults.current_role() or "client") + "_sv"
        )
        self._injector = faults.client_injector(self.role)
        # Shared retry discipline (r18): transport replays spend this
        # token-bucket budget; exhaustion surfaces as ServeDeadlineError
        # plus a flight-recorder event (parallel/retry.py).
        self._budget = retry.RetryBudget()
        self._lock = threading.RLock()
        self._sock: socket.socket | None = None
        self._hdr = bytearray(wire.RESP_HDR.size)
        # The served registry version (r19): learned from the msrv HELLO
        # version word at connect (0 = hot-tracking / pre-r19 replica),
        # refreshed per response via the SRV_VERSION_FIELD stamp — pools
        # read both for canary routing and per-version accounting.
        self.server_model_version = 0
        self.last_model_version = -1
        try:
            self._connect()
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
            wire.HELLO_OP, a=wire.WIRE_VERSION,
            b=wire.pack_hello_b(wire.WIRE_DTYPES["f32"], service="msrv"),
        )
        err = wire.hello_failure(
            status, tag, service="msrv", host=self._host, port=self._port
        )
        if err is not None:
            self._sever()
            raise ServeError(err)
        _tag4, self.server_model_version = wire.unpack_hello_tag(tag)

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
        payload_bufs: list | None = None, batch: bool = False,
    ):
        """One send/recv round trip; severs the socket on ANY transport
        failure.  ``payload_bufs``: a pre-encoded batch buffer list (wire
        codec) sent zero-copy via scatter/gather ``sendmsg``."""
        # One reference for the whole round trip: a pool's set_addrs may
        # close this client from another thread mid-attempt, which must
        # fail the attempt as a transport error (OSError: the pool retries
        # on a peer), never as an AttributeError on a vanished socket.
        sock = self._sock
        if sock is None:
            raise ConnectionError("not connected")
        # The ONE client-side tagging point (r20): every data-plane op of
        # a non-default tenant carries its tenant in the name operand —
        # never HELLO, the version-discovery frame (same reasoning as the
        # deadline stamp below).
        if self.tenant != tenancy.DEFAULT_TENANT and op != wire.HELLO_OP:
            name = tenancy.tag_name(name, self.tenant)
        try:
            sock.settimeout(self._op_timeout)
            nbytes = wire.encoded_nbytes(payload_bufs) if payload_bufs else 0
            # Deadline propagation (r18): the remaining per-op budget
            # rides in the frame header, so the replica sheds a predict
            # this client has already abandoned instead of batching it.
            # Safe unconditionally: every ServeClient connection HELLOs
            # (v4 confirmed) before any other op — except HELLO itself.
            hdr = wire.pack_request(
                op, name, a, b, nbytes,
                deadline_ms=(
                    0 if self._op_timeout is None or op == wire.HELLO_OP
                    else max(1, int(self._op_timeout * 1000))
                ),
            )
            wire.send_frames(sock, [hdr] + (payload_bufs or []))
            head = memoryview(self._hdr)
            wire.recv_exact(sock, head)
            status, rbytes = wire.RESP_HDR.unpack(self._hdr)
            if not rbytes:
                return status, None
            if batch:
                return status, wire.read_batch(sock, rbytes)
            buf = bytearray(rbytes)
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
                raise ServeDeadlineError(
                    f"model replica at {self._host}:{self._port} unreachable "
                    f"for {self._reconnect_deadline:.0f}s ({attempt} attempts)"
                )
            attempt += 1
            # Per-address circuit breaker (r18, process-wide): a freshly-
            # proven-dead replica fails fast for its open window instead
            # of burning another connect timeout.
            breaker = retry.breaker_for((self._host, self._port))
            if not breaker.allow():
                breaker.wait_for_probe(t_end)
                immediate = True  # the wait was this attempt's pacing
                continue
            try:
                self._connect()
            except OSError:
                breaker.on_failure()
                self._sever()
                continue
            breaker.on_success()
            faults.log_event("reconnected", role=self.role, attempts=attempt)
            return

    def call(
        self, op: int, name: str = "", a: int = 0, b: int = 0, *,
        payload_bufs: list | None = None, batch: bool = False,
    ):
        """One request/response; recovers + replays on transport failure
        (every SRV op is pure/idempotent, so replay is always safe).  A
        replay spends the shared retry budget (r18): a storm of failing
        ops cannot replay unboundedly."""
        with self._lock:
            if self._injector is not None and self._injector.before_op(op):
                self._sever()  # injected drop_conn
            t_end = None
            while True:
                if self._sock is not None:
                    try:
                        got = self._attempt(
                            op, name, a, b, payload_bufs=payload_bufs,
                            batch=batch,
                        )
                    except OSError as e:
                        if self._reconnect_deadline <= 0:
                            raise ServeError(
                                f"serve op {op} failed: {e!r}"
                            ) from e
                        faults.log_event(
                            "conn_lost", role=self.role, op_code=op,
                            error=type(e).__name__,
                        )
                    else:
                        self._budget.on_success()
                        return got
                elif self._reconnect_deadline <= 0:
                    raise ServeError(f"serve op {op} failed: not connected")
                if t_end is None:
                    t_end = time.monotonic() + self._reconnect_deadline
                if not self._budget.try_spend():
                    raise ServeDeadlineError(
                        f"replica at {self._host}:{self._port} retry budget "
                        f"exhausted replaying op {op}"
                    )
                self._recover(t_end)

    # -- ops -----------------------------------------------------------------

    def predict(self, inputs: dict) -> tuple[int, dict[str, np.ndarray]]:
        """One predict round trip: ``(model_step, outputs)``.  The step is
        the published update the replica served this answer from.  Raises
        :class:`ServeOverloadError` / :class:`ServeUnavailableError` on the
        explicit shed statuses (callers/pools back off or rotate)."""
        bufs = wire.encode_batch(inputs)
        status, out = self.call(SRV_PREDICT, payload_bufs=bufs, batch=True)
        hint_ms = wire.retry_after_ms(status)
        if hint_ms is not None:
            # r18: the replica SHED this predict (admission control —
            # batcher queue full, dispatch bound, or queue-deadline
            # expiry) and the status carries its own backoff hint.
            raise ServeOverloadError(
                f"replica {self._host}:{self._port} overloaded "
                f"(retry after {hint_ms}ms)",
                retry_after_s=hint_ms / 1e3,
            )
        if status == OVERLOAD:
            # Legacy code point (pre-r18 replicas): no hint.
            raise ServeOverloadError(
                f"replica {self._host}:{self._port} overloaded"
            )
        if status == NO_MODEL:
            raise ServeUnavailableError(
                f"replica {self._host}:{self._port} has no model yet"
            )
        if status == ERR:
            # The server core's loud handler-failure band (r17): the
            # replica answered — an apply/handler exception server-side,
            # not a transport fault — so the typed rejection names where
            # the traceback lives instead of reading as "bad status -2".
            raise ServeRejectedError(
                "predict failed server-side (ERR: apply/handler error — "
                "see the replica's log)"
            )
        if status < 0 or out is None:
            raise ServeRejectedError(f"predict rejected: {status}")
        return status, self._strip_version(out)

    def _strip_version(self, out: dict) -> dict:
        """Pop the per-response version stamp (r19) into
        ``last_model_version`` — user code sees only its own fields."""
        ver = out.pop(wire.SRV_VERSION_FIELD, None)
        if ver is not None:
            self.last_model_version = int(np.asarray(ver).reshape(()))
        return out

    def _decode_status_check(self, status: int) -> None:
        """The shared decode-wire error mapping (every status a replica
        can answer on the DECODE ops gets its typed client error)."""
        hint_ms = wire.retry_after_ms(status)
        if hint_ms is not None:
            raise ServeOverloadError(
                f"replica {self._host}:{self._port} shed the decode op "
                f"(retry after {hint_ms}ms)", retry_after_s=hint_ms / 1e3,
            )
        if status == NO_MODEL:
            raise ServeUnavailableError(
                f"replica {self._host}:{self._port} has no model yet"
            )
        if status == NO_DECODER:
            raise ServeRejectedError(
                f"replica {self._host}:{self._port} serves no decode path "
                "(predict-only model)"
            )
        if status == BAD_SESSION:
            raise ServeSessionError(
                f"replica {self._host}:{self._port} does not know this "
                "decode session (expired, or lost to a restart) — re-open"
            )
        if status < 0:
            raise ServeRejectedError(f"decode op rejected: {status}")

    def decode_open(self, prompt, max_new_tokens: int) -> int:
        """Open one stepped-decode session (greedy continuation of
        ``prompt``, a 1-D int32 token array); returns the session id.
        A transport replay can orphan a server-side session — the
        replica's idle sweep reclaims it, so replay stays safe."""
        bufs = wire.encode_batch({"prompt": np.asarray(prompt, np.int32)})
        status, _ = self.call(
            SRV_DECODE_OPEN, a=int(max_new_tokens), payload_bufs=bufs,
        )
        self._decode_status_check(status)
        return status

    def decode_next(self, session: int, cursor: int = 0):
        """Poll a session's token stream from ``cursor`` (tokens already
        received): ``(tokens, done, model_step)``.  Cursor-addressed, so
        replaying the poll after a reconnect re-reads instead of
        double-draining."""
        status, out = self.call(
            SRV_DECODE_NEXT, a=int(session), b=int(cursor), batch=True,
        )
        self._decode_status_check(status)
        out = self._strip_version(out)
        return (
            np.asarray(out["tokens"], np.int32).reshape(-1),
            bool(np.asarray(out["done"]).reshape(-1)[0]),
            status,
        )

    def decode_close(self, session: int) -> None:
        """Release a session server-side (idempotent)."""
        self.call(SRV_DECODE_CLOSE, a=int(session))

    def generate(
        self, prompt, max_new_tokens: int, *, poll_s: float = 0.005,
        deadline_s: float = 120.0,
    ) -> np.ndarray:
        """The whole stream: open, poll the token stream to completion,
        close; returns the generated int32 tokens (the continuation only,
        not the prompt)."""
        sid = self.decode_open(prompt, max_new_tokens)
        tokens: list[int] = []
        try:
            t_end = time.monotonic() + deadline_s
            while True:
                got, done, _step = self.decode_next(sid, cursor=len(tokens))
                tokens.extend(int(t) for t in got)
                if done:
                    return np.asarray(tokens, np.int32)
                if time.monotonic() >= t_end:
                    raise ServeDeadlineError(
                        f"decode session {sid} incomplete after "
                        f"{deadline_s:.0f}s ({len(tokens)} tokens)"
                    )
                time.sleep(poll_s)
        finally:
            try:
                self.decode_close(sid)
            except ServeError:
                pass  # best-effort release; the idle sweep is the backstop

    def stats(self) -> dict:
        status, raw = self.call(SRV_STATS)
        if status == ERR:
            raise ServeRejectedError(
                "stats failed server-side (ERR: handler error — see the "
                "replica's log)"
            )
        if status != 0 or raw is None:
            raise ServeRejectedError(f"stats rejected: {status}")
        return json.loads(raw)

    def shutdown_server(self) -> None:
        self.call(SRV_SHUTDOWN)


class ServePool:
    """Round-robin load balancer over N replicas with unhealthy-replica
    ejection.  Per-replica clients run FAIL-FAST (no per-client reconnect
    budget): the pool itself is the recovery layer — a failed attempt
    benches that replica for ``eject_s`` and immediately retries on a peer,
    which converts a replica kill into added latency on one request rather
    than an error.  ``deadline_s`` bounds one logical predict across every
    retry; it should comfortably cover a supervised replica restart."""

    def __init__(
        self, addrs: list[tuple[str, int]], *, role: str | None = None,
        op_timeout_s: float | None = 10.0, eject_s: float = 1.0,
        deadline_s: float = 60.0, backoff_s: float = 0.05,
        tenant: str = tenancy.DEFAULT_TENANT,
    ):
        if not addrs:
            raise ValueError("need at least one replica address")
        # The pool's tenant (r20): forwarded to every per-replica client,
        # so each predict is tagged and the replicas' admission control /
        # accounting attribute this pool's traffic to it.
        self.tenant = (
            tenant if tenant == tenancy.DEFAULT_TENANT
            else tenancy.check_tenant(tenant)
        )
        self.addrs = list(addrs)
        self.role = role if role is not None else (
            (faults.current_role() or "client") + "_sv"
        )
        self._op_timeout = op_timeout_s
        self._eject_s = eject_s
        self._deadline = deadline_s
        self._backoff = backoff_s
        n = len(self.addrs)
        self._clients: list[ServeClient | None] = [None] * n
        self._eject_until = [0.0] * n
        # Per-replica served registry version (r19): learned from the
        # HELLO version word at dial and refreshed per response; None =
        # not yet dialed.  The canary lane keys off it.
        self._ver: list[int | None] = [None] * n
        self._rr = 0
        self._lock = threading.Lock()
        # Canary routing (r19): (version, weight) — that fraction of
        # picks routes to replicas serving ``version``, the rest to the
        # stable lane.  None = plain round-robin.
        self._canary: tuple[int, float] | None = None
        self._canary_acc = 0.0
        # Per-version accounting (r19): ok/error counts + a latency ring
        # per served version — the promote-or-rollback evidence
        # (serve.deploy.canary_verdict consumes version_stats()).
        self._vstats: dict[int, dict] = {}
        # Shared retry discipline (r18): every cross-replica retry spends
        # this budget — a pool cannot convert one overload into an
        # unbounded rotation storm.
        self._budget = retry.RetryBudget()
        self.retries = 0
        self.ejections = 0
        self.overload_backoffs = 0
        self.last_replica = -1
        self.last_version = -1

    def set_canary(self, version: int, weight: float) -> None:
        """Route ``weight`` (0..1) of picks to replicas serving registry
        ``version`` (the canary lane), the rest to everything else (the
        stable lane).  A lane with no live replica falls back to plain
        rotation — a canary that dies degrades to stable service, it
        never blackholes the weighted fraction."""
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"canary weight must be in [0, 1], got {weight}")
        with self._lock:
            self._canary = (int(version), float(weight))
            self._canary_acc = 0.0
        faults.log_event(
            "serve_canary_set", role=self.role, version=int(version),
            weight=round(float(weight), 3),
        )

    def clear_canary(self) -> None:
        with self._lock:
            self._canary = None

    def _rr_pick_locked(self, now: float, lane=None) -> int | None:
        """Round-robin over un-ejected replicas (optionally restricted to
        a lane of indices); caller holds the lock."""
        for k in range(len(self.addrs)):
            i = (self._rr + k) % len(self.addrs)
            if now >= self._eject_until[i] and (lane is None or i in lane):
                self._rr = i + 1
                return i
        return None

    def _pick(self) -> int | None:
        with self._lock:
            now = time.monotonic()
            if self._canary is not None:
                cver, weight = self._canary
                live = [
                    i for i in range(len(self.addrs))
                    if now >= self._eject_until[i]
                ]
                c_lane = {i for i in live if self._ver[i] == cver}
                s_lane = {i for i in live if self._ver[i] != cver}
                if c_lane and s_lane:
                    # Deterministic weighted split: the accumulator hands
                    # exactly ``weight`` of picks to the canary lane over
                    # any window (no RNG to decorrelate in tests).
                    self._canary_acc += weight
                    if self._canary_acc >= 1.0:
                        self._canary_acc -= 1.0
                        lane = c_lane
                    else:
                        lane = s_lane
                    got = self._rr_pick_locked(now, lane)
                    if got is not None:
                        return got
            return self._rr_pick_locked(now)  # plain rotation / fallback

    def _eject(self, i: int, for_s: float) -> None:
        with self._lock:
            if i >= len(self.addrs):
                return  # set_addrs shrank the pool under this request
            self._eject_until[i] = time.monotonic() + for_s
            self.ejections += 1
            c, self._clients[i] = self._clients[i], None
        if c is not None:
            c.close()

    def _client(self, i: int) -> ServeClient:
        with self._lock:
            c = self._clients[i]
        if c is not None:
            return c
        host, port = self.addrs[i]
        c = ServeClient(
            host, port, op_timeout_s=self._op_timeout,
            reconnect_deadline_s=0.0,  # the POOL is the recovery layer
            role=self.role, tenant=self.tenant,
        )
        with self._lock:
            # Two threads can race past the None check and both dial;
            # first one in wins, the loser closes its socket (no leak)
            # and shares the winner's client.
            if self._clients[i] is None:
                self._clients[i] = c
                if i < len(self._ver):
                    self._ver[i] = c.server_model_version
                return c
            winner = self._clients[i]
        c.close()
        return winner

    # -- per-version accounting (r19) ----------------------------------------

    def _record_version(
        self, i: int, version: int | None, ok: bool, dt_s: float = 0.0,
    ) -> None:
        with self._lock:
            if version is None:
                # An errored attempt: charge the replica's last-known
                # version (-1 when it was never learned).
                known = self._ver[i] if 0 <= i < len(self._ver) else None
                ver = -1 if known is None else int(known)
            else:
                ver = int(version)
                if 0 <= i < len(self._ver):
                    self._ver[i] = ver
            st = self._vstats.get(ver)
            if st is None:
                st = self._vstats[ver] = {
                    "ok": 0, "err": 0, "lat": LatencyRecorder(),
                }
            if ok:
                st["ok"] += 1
                st["lat"].record(dt_s)
            else:
                st["err"] += 1
        if ok and version is not None:
            self.last_version = ver

    def version_stats(self) -> dict[int, dict]:
        """Per served-version accounting: ``{version: {ok, err,
        latency percentiles/qps}}`` (version -1 = attempts whose replica's
        version was never learned) — the canary-vs-stable evidence a
        promote-or-rollback decision reads (serve.deploy.canary_verdict)."""
        with self._lock:
            items = list(self._vstats.items())
        out: dict[int, dict] = {}
        for ver, st in items:
            row = {"ok": st["ok"], "err": st["err"]}
            for k, v in st["lat"].percentile_scalars("v").items():
                row[k.split("/", 1)[1]] = v
            out[ver] = row
        return out

    def known_versions(self) -> dict[str, int | None]:
        """Last-known served version per replica address (None = never
        dialed)."""
        with self._lock:
            return {
                f"{h}:{p}": v for (h, p), v in zip(self.addrs, self._ver)
            }

    def predict(
        self, inputs: dict, *, deadline_s: float | None = None,
    ) -> tuple[int, dict[str, np.ndarray]]:
        """One logical predict, retried across the rotation until it
        succeeds or the deadline passes.  Safe to retry without markers:
        predict is pure, so a response lost mid-failover at worst costs a
        recomputation, never a duplicated side effect."""
        t_end = time.monotonic() + (
            deadline_s if deadline_s is not None else self._deadline
        )
        last_err: BaseException | None = None
        first = True
        sheds_in_row = 0  # consecutive RETRY_LATER answers this request
        while time.monotonic() < t_end:
            i = self._pick()
            if i is None:
                # Everything benched: sleep to the earliest un-ejection
                # (bounded by the backoff floor) and try again.  Waiting
                # is free — no request is issued, so no retry token is
                # spent (the budget prices re-ISSUES, not patience).
                with self._lock:
                    wake = min(self._eject_until)
                time.sleep(
                    min(max(self._backoff, wake - time.monotonic()), 1.0)
                )
                continue
            if not first:
                with self._lock:
                    self.retries += 1
                # Every re-issued request consults the shared budget
                # (r18): refused means the pool is already storming —
                # surface the typed deadline error instead of feeding it.
                if not self._budget.try_spend():
                    raise ServeDeadlineError(
                        "serve pool retry budget exhausted "
                        f"(last error: {last_err!r})"
                    )
            first = False
            try:
                c = self._client(i)
                t0 = time.perf_counter()
                got = c.predict(inputs)
                self.last_replica = i
                # The response's version stamp (r19) — fall back to the
                # HELLO word against a pre-stamp replica.
                ver = (
                    c.last_model_version
                    if c.last_model_version >= 0
                    else c.server_model_version
                )
                self._record_version(
                    i, ver, ok=True, dt_s=time.perf_counter() - t0
                )
                self._budget.on_success()
                return got
            except ServeRejectedError:
                # The replica ANSWERED: the request itself is bad (or the
                # apply failed deterministically).  Every peer would reject
                # it the same way — surface it instead of benching healthy
                # replicas and replaying for the whole deadline.
                raise
            except (ServeOverloadError, ServeUnavailableError) as e:
                # Alive but shedding: rotate — but HONOR the retry-after
                # hint the shed carried (r18).  The shedding replica
                # benches for the hinted window (it told us how long its
                # queue needs to drain), and once a whole rotation sweep
                # has answered only sheds — pool-WIDE overload — the next
                # attempt waits a jittered hint first: rotating at line
                # rate across N overloaded replicas is amplification, not
                # load balancing.
                last_err = e
                self._record_version(i, None, ok=False)
                hint_s = getattr(e, "retry_after_s", 0.0)
                self._eject(i, max(min(self._eject_s, 0.25), hint_s))
                # Only a genuine SHED answer counts toward the pool-wide-
                # overload detection — a warming replica (Unavailable, no
                # hint) is not overload evidence, and must not push the
                # pool into the backoff sleep.
                if isinstance(e, ServeOverloadError):
                    sheds_in_row += 1
                if hint_s > 0 and sheds_in_row >= len(self.addrs):
                    with self._lock:
                        self.overload_backoffs += 1
                    time.sleep(min(
                        retry.jittered(hint_s, cap_s=2.0),
                        max(0.0, t_end - time.monotonic()),
                    ))
            except IndexError:
                # set_addrs() shrank the pool between _pick and use (an
                # elastic scale-down racing this request): the index is
                # simply stale — re-pick against the new rotation, never
                # fail the logical predict.
                continue
            except (ServeError, OSError, ConnectionError) as e:
                last_err = e
                sheds_in_row = 0  # a transport fault, not a shed answer
                self._record_version(i, None, ok=False)
                self._eject(i, self._eject_s)
                faults.log_event(
                    "serve_replica_ejected", role=self.role, replica=i,
                    error=type(e).__name__,
                )
        raise ServeDeadlineError(
            f"no replica answered within {self._deadline:.0f}s "
            f"(last error: {last_err!r})"
        )

    def set_addrs(self, addrs: list[tuple[str, int]]) -> None:
        """Reconcile the replica set against an ELASTIC membership list
        (r14): addresses that remain keep their client and ejection
        state; removed replicas' clients close (an in-flight predict on
        one fails its attempt and retries on a peer — predict is pure, so
        a scale-down never fails a logical request); new replicas join
        the rotation un-ejected.  No-op when nothing changed."""
        addrs = list(addrs)
        if not addrs:
            raise ValueError("need at least one replica address")
        stale: list[ServeClient] = []
        with self._lock:
            if addrs == self.addrs:
                return
            keep_clients = dict(zip(self.addrs, self._clients))
            keep_eject = dict(zip(self.addrs, self._eject_until))
            keep_ver = dict(zip(self.addrs, self._ver))
            stale = [
                c
                for a, c in keep_clients.items()
                if c is not None and a not in addrs
            ]
            self.addrs = addrs
            self._clients = [keep_clients.get(a) for a in addrs]
            self._eject_until = [keep_eject.get(a, 0.0) for a in addrs]
            self._ver = [keep_ver.get(a) for a in addrs]
            self._rr %= len(addrs)
        for c in stale:
            try:
                c.close()
            except Exception:
                pass
        faults.log_event(
            "serve_pool_resized", role=self.role, replicas=len(addrs),
        )

    def stats(self, i: int) -> dict:
        """Replica ``i``'s stats (dialing it directly, even if benched)."""
        return self._client(i).stats()

    def close(self) -> None:
        for k, c in enumerate(self._clients):
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass
            self._clients[k] = None
