"""Model replica server, registry-pin mode: the port of
``distributed_tensorflow_examples_tpu/serve/model_server.py``.

A replica speaks the shared ``parallel/wire.py`` framing under the ``msrv``
service tag, byte-identical to the JAX replica, so either package's
``ServeClient`` talks to it.  It serves ONE immutable registry version:

- the version loads once, at construction, and is unflattened into tensors
  on the replica's device (a replica that cannot load its version fails
  its construction loudly);
- a lease-style registry pin protects the version from GC for the
  replica's lifetime, renewed by the refresher thread;
- PREDICT requests from every connection coalesce through
  :class:`serve.batcher.DynamicBatcher` into one apply padded to
  ``max_batch`` rows, run under ``torch.inference_mode()``; each answer's
  status is the served ``model_step`` and its batch carries the registry
  version (``wire.SRV_VERSION_FIELD``), exactly as the JAX replica stamps
  them;
- ``decode_fns=(init_cache_fn, step_fn)`` adds the stepped KV-cache
  decode path, as in JAX: greedy sessions behind
  :class:`serve.batcher.SlotBatcher` (one step advances every active
  slot of a fixed-width batch), streamed over DECODE_OPEN/NEXT/CLOSE;
  sessions nobody polls for ``session_idle_s`` are cancelled by the
  refresher.  Without it DECODE_OPEN answers ``NO_DECODER``;
- STATS and SHUTDOWN answer as in JAX.

Hot-tracking a parameter server (``ps_addrs``), membership leases and
reshard following wait for the port's PS-plane slice: each raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np
import torch

from .. import bridge
from ..parallel import server_core, tenancy, wire
from ..utils import device as device_lib
from ..utils import faults, telemetry
from ..utils.metrics import LatencyRecorder, MetricsWriter
from . import batcher as batcher_lib
from . import registry as registry_lib

log = logging.getLogger("dtx.serve")

#: This wire's service identity (parallel/wire.py registry).
SERVICE = "msrv"

SRV_PREDICT = wire.SRV_OPS["PREDICT"]
SRV_STATS = wire.SRV_OPS["STATS"]
SRV_SHUTDOWN = wire.SRV_OPS["SHUTDOWN"]
SRV_DECODE_OPEN = wire.SRV_OPS["DECODE_OPEN"]
SRV_DECODE_NEXT = wire.SRV_OPS["DECODE_NEXT"]
SRV_DECODE_CLOSE = wire.SRV_OPS["DECODE_CLOSE"]

#: Ops excluded from the request counter (wire.CONTROL_OPS).
_SRV_CONTROL_OPS = frozenset(
    wire.SRV_OPS[n] for n in wire.CONTROL_OPS["msrv"]
)

# Response statuses (wire.SRV_STATUS aliases).  PREDICT success answers the
# served model_step (>= 0) as the status.
ERR = wire.SRV_STATUS["ERR"]
OVERLOAD = wire.SRV_STATUS["OVERLOAD"]
NO_MODEL = wire.SRV_STATUS["NO_MODEL"]
BAD_SESSION = wire.SRV_STATUS["BAD_SESSION"]
NO_DECODER = wire.SRV_STATUS["NO_DECODER"]


def _tenant_of_request(op: int, name: str, a: int, b: int) -> str:
    """Per-tenant admission attribution: the ``,t=<tenant>`` name tag."""
    return tenancy.untag_name(name)[1]


def _to_host(x):
    """An output tensor on the host, as the wire codec takes it: numpy,
    except bfloat16, which stays a CPU tensor (numpy has no bfloat16)."""
    x = x.detach().cpu()
    return x if x.dtype == torch.bfloat16 else x.numpy()


class _DecodeEngine:
    """Stepped KV-cache decode behind the sequence-slot batcher: the twin
    of the JAX replica's engine.

    The model supplies ``init_cache_fn(slots, max_len, device)`` (a
    per-slot cache) and ``step_fn(params, cache, tokens[S], pos[S]) ->
    (logits [S, V], cache)``, one apply that advances EVERY slot one
    position.  The engine owns the host-side slot state (each slot's
    current token and position), prompt teacher-forcing and greedy
    selection (``np.argmax`` over the step's logits: the first index on a
    tie), so a session's tokens do not depend on its neighbours: the slot
    array's shape is fixed (a free slot computes an inert row), a row's
    numbers depend only on its own slot, and the attention mask confines
    each session to the cache positions it wrote itself, so a freed slot
    needs no cache reset.  The step runs on the batcher's thread under
    ``torch.inference_mode()``, on the replica's device."""

    def __init__(
        self, model_getter, init_cache_fn, step_fn, *, slots: int,
        max_len: int, max_sessions: int, device,
    ):
        self._get_model = model_getter  # () -> (step, params)
        self.device = device
        with torch.inference_mode():
            self._cache = init_cache_fn(slots, max_len, device)
        self._step = step_fn
        self.slots = int(slots)
        self.max_len = int(max_len)
        self._tokens = np.zeros((self.slots,), np.int32)
        self._pos = np.zeros((self.slots,), np.int32)
        self.batcher = batcher_lib.SlotBatcher(
            self._run_step, slots=self.slots, max_sessions=max_sessions,
        )

    def open(self, prompt: np.ndarray, max_new_tokens: int):
        """Admit one greedy decode session; returns its StreamTicket.
        Raises ValueError on a prompt/budget the cache cannot hold, and
        ``batcher.Overloaded`` past the session bound."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = int(max_new_tokens)
        if prompt.size < 1:
            raise ValueError("decode needs a non-empty prompt")
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        if prompt.size + n > self.max_len:
            raise ValueError(
                f"{prompt.size} prompt + {n} new tokens exceeds the "
                f"replica's decode_max_len={self.max_len}"
            )
        return self.batcher.open(
            {"prompt": prompt, "n": n, "emitted": 0, "seated": False}
        )

    def _run_step(self, slots):
        _step, params = self._get_model()
        for i, t in enumerate(slots):
            if t is not None and not t.state["seated"]:
                # A freshly seated session starts its slot at position 0
                # feeding its first prompt token; the cache needs no reset.
                t.state["seated"] = True
                self._tokens[i] = t.state["prompt"][0]
                self._pos[i] = 0
        # A free slot keeps its last session's token and position (an
        # inert row); one that ended on the cache's last position steps
        # there again instead of past the end.
        pos = np.minimum(self._pos, self.max_len - 1)
        with torch.inference_mode():
            logits, self._cache = self._step(
                params, self._cache,
                torch.from_numpy(self._tokens).to(self.device),
                torch.from_numpy(pos).to(self.device),
            )
            out = logits.float().cpu().numpy()
        results: list = [None] * len(slots)
        for i, t in enumerate(slots):
            if t is None:
                continue
            st = t.state
            p = int(self._pos[i])
            if p + 1 < len(st["prompt"]):
                nxt = int(st["prompt"][p + 1])  # teacher-force the prompt
                emits: list[int] = []
            else:
                nxt = int(np.argmax(out[i]))  # greedy continuation
                emits = [nxt]
                st["emitted"] += 1
            self._tokens[i] = nxt
            self._pos[i] = p + 1
            results[i] = (emits, st["emitted"] >= st["n"])
        return results

    def stats(self) -> dict:
        s = self.batcher.stats()
        s["max_len"] = self.max_len
        return s

    def stop(self) -> None:
        self.batcher.stop()


class ModelReplicaServer:
    """One registry-pinned serving replica.

    ``param_shapes``  the parameter tree with shape-tuple leaves
                      (``models.transformer.param_shapes(cfg)``): the
                      structure the registry's flat vector unflattens into.
    ``predict_fn``    ``predict_fn(params, inputs) -> tensor | dict``, with
                      ``inputs`` a dict of tensors on ``device``; row-wise
                      in the leading dim, which makes padded batching exact.
    ``ps_addrs``      must be empty in this slice (hot-tracking raises).
    ``device``        ``None`` = ``cuda`` (raises without a card); tests
                      pass ``"cpu"``.
    ``decode_fns``    ``(init_cache_fn, step_fn)``
                      (``models.transformer.serve_decode_fns(cfg)``): the
                      decode path, with ``decode_slots`` slots of
                      ``decode_max_len`` positions and at most
                      ``decode_max_sessions`` sessions active or queued.
    """

    def __init__(
        self, param_shapes, predict_fn, ps_addrs=(), *, device=None,
        port: int = 0, loopback_only: bool = True, max_batch: int = 32,
        max_wait_ms: float = 5.0, queue_depth: int = 128,
        refresh_ms: float = 50.0, role: str | None = None,
        metrics_dir: str | None = None, metrics_every: int = 100,
        membership: bool = False, follow_reshard: bool = False,
        handler_workers: int = 8, queue_deadline_ms: float = 0.0,
        registry_dir: str | None = None, model_name: str = "default",
        model_version: int | None = None, pin_ttl_s: float = 30.0,
        decode_fns: tuple | None = None, decode_slots: int = 4,
        decode_max_len: int = 512, decode_max_sessions: int = 64,
        session_idle_s: float = 60.0,
        tenant: str = tenancy.DEFAULT_TENANT,
        tenant_quotas: dict | None = None,
    ):
        if ps_addrs:
            raise NotImplementedError(
                "hot-tracking a parameter server (ps_addrs) waits for the "
                "port's PS-plane slice; serve a pinned registry version"
            )
        if membership:
            raise NotImplementedError(
                "membership leases wait for the port's PS-plane slice"
            )
        if follow_reshard:
            raise NotImplementedError(
                "reshard following waits for the port's PS-plane slice"
            )
        self.model_version = int(model_version or 0)
        if not registry_dir or self.model_version <= 0:
            raise ValueError(
                "the port's replica serves a pinned registry version: pass "
                "registry_dir and model_version >= 1"
            )
        self.device = device_lib.resolve(device)
        self._predict = predict_fn
        self.role = role if role is not None else (
            faults.current_role() or "serve0"
        )
        self.tenant = (
            tenant if tenant == tenancy.DEFAULT_TENANT
            else tenancy.check_tenant(tenant)
        )
        self.model_name = tenancy.qualify(self.tenant, model_name)
        self._registry = registry_lib.ModelRegistry(registry_dir)
        self._pin_ttl_s = max(5.0, float(pin_ttl_s))
        _total, unflatten = bridge.flat_param_spec(param_shapes)
        # The version loads ONCE, here: a replica that cannot load it fails
        # its construction loudly, never comes up serving NO_MODEL.
        step, flat, _manifest = self._registry.load(
            self.model_name, self.model_version
        )
        self._model = (int(step), unflatten(flat, self.device))
        self._registry.pin(
            self.model_name, self.model_version, self.role,
            ttl_s=self._pin_ttl_s, tenant=self.tenant,
        )
        self._next_pin_renew = time.monotonic() + self._pin_ttl_s / 3
        self._incarnation = int.from_bytes(os.urandom(4), "little") | 1
        self._lock = threading.Lock()
        # Wedged-apply backstop: the refresher resolves in-flight predict
        # tickets past this deadline with TimeoutError (a loud ERR).
        self._ticket_deadline_s = 120.0
        self._pending_tickets: dict = {}
        self._predicts = 0
        self._applies = 0
        self._refresh_errors = 0
        self._overloads = 0
        self.max_batch = int(max_batch)
        self._refresh_s = max(refresh_ms, 1.0) / 1e3
        self.latency = LatencyRecorder()
        self._writer = MetricsWriter(metrics_dir) if metrics_dir else None
        self._metrics_every = max(1, metrics_every)
        self._batcher = batcher_lib.DynamicBatcher(
            self._run_batch, max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
        )
        # Decode sessions: ids are handed to clients as the DECODE_OPEN
        # status; the table maps them to stream tickets, and the refresher
        # sweeps sessions nobody polled for ``session_idle_s``.
        self._engine = (
            _DecodeEngine(
                lambda: self._model, decode_fns[0], decode_fns[1],
                slots=decode_slots, max_len=decode_max_len,
                max_sessions=decode_max_sessions, device=self.device,
            )
            if decode_fns is not None
            else None
        )
        self._session_idle_s = float(session_idle_s)
        self._sessions: dict[int, list] = {}  # sid -> [ticket, last_poll]
        self._next_sid = 1
        self._decode_opens = 0
        self._stop = threading.Event()
        self.shutdown_requested = threading.Event()
        self._core = server_core.ServerCore(
            port=port, loopback_only=loopback_only, name="msrv",
            workers=handler_workers, tenant_quotas=tenant_quotas,
        )
        self._retry_after_ms = max(20, int(2 * max_wait_ms))
        self._core.add_service(server_core.Service(
            SERVICE, self._handle,
            control_ops=_SRV_CONTROL_OPS,
            tenant_of=_tenant_of_request,
            error_status=ERR,
            max_payload=256 << 20,
            queue_deadline_s=(
                queue_deadline_ms / 1e3 if queue_deadline_ms else None
            ),
            retry_after_ms=self._retry_after_ms,
            # The HELLO version word: a dialing client learns the served
            # registry version at connect.
            hello_extra=lambda: wire.HELLO_VERSION_TAIL.pack(
                self.model_version
            ),
        ))
        self._core.start()
        self.port = self._core.port
        self._refresher = threading.Thread(
            target=self._refresh_loop, daemon=True, name="msrv-refresh"
        )
        self._refresher.start()
        log.info(
            "model replica %s serving on port %d (pinned %s/v%d on %s, "
            "max_batch=%d, incarnation %d)",
            self.role, self.port, self.model_name, self.model_version,
            self.device, self.max_batch, self._incarnation,
        )

    # -- lifecycle -----------------------------------------------------------

    def request_count(self) -> int:
        """Requests handled so far (the ``die:after_reqs`` fault trigger);
        the server core excludes the control-plane ops."""
        return self._core.request_count()

    @property
    def model_step(self) -> int:
        return self._model[0]

    def stop(self) -> None:
        self._stop.set()
        # The core drains first (in-flight predicts resolve and their
        # buffered responses flush) and releases the port.
        self._core.stop()
        self._refresher.join(timeout=5.0)
        self._batcher.stop()
        if self._engine is not None:
            self._engine.stop()
        # Release the registry pin LAST: GC must not reclaim the served
        # version while in-flight work could still touch it.
        try:
            self._registry.unpin(
                self.model_name, self.model_version, self.role,
                tenant=self.tenant,
            )
        except OSError:
            log.warning("registry unpin failed", exc_info=True)
        if self._writer is not None:
            self._writer.close()

    # -- the refresher: pin renewal and the stuck-ticket sweep ---------------

    def _sweep_stuck_tickets(self) -> None:
        now = time.monotonic()
        with self._lock:
            stuck = [t for t, dl in self._pending_tickets.items() if now > dl]
        for t in stuck:
            t._resolve(error=TimeoutError(
                "batched apply did not complete in "
                f"{self._ticket_deadline_s:.0f}s (batch thread wedged?)"
            ))

    def _sweep_idle_sessions(self) -> None:
        """Cancel decode sessions nobody polled for ``session_idle_s``: an
        abandoned client must not hold a slot or its emissions forever.
        DECODE_CLOSE is the polite path; this is the backstop."""
        if self._engine is None:
            return
        now = time.monotonic()
        with self._lock:
            stale = [
                sid for sid, (_t, last) in self._sessions.items()
                if now - last > self._session_idle_s
            ]
            tickets = [self._sessions.pop(sid)[0] for sid in stale]
        for t in tickets:
            t.cancel()

    def _refresh_loop(self) -> None:
        while not self._stop.is_set():
            self._sweep_stuck_tickets()
            self._sweep_idle_sessions()
            now = time.monotonic()
            if now >= self._next_pin_renew:
                self._next_pin_renew = now + self._pin_ttl_s / 3
                try:
                    self._registry.pin(
                        self.model_name, self.model_version, self.role,
                        ttl_s=self._pin_ttl_s, tenant=self.tenant,
                    )
                except (OSError, registry_lib.RegistryError):
                    self._refresh_errors += 1
                    faults.log_event(
                        "serve_pin_renew_failed", role=self.role,
                        version=self.model_version,
                    )
            self._stop.wait(max(self._refresh_s, 0.25))

    # -- the batched apply ---------------------------------------------------

    def _run_batch(self, items: list[dict]):
        """One padded apply for a coalesced request list; returns
        ``(step, outputs_slice)`` per request.  Runs on the batch thread."""
        step, params = self._model
        proto = items[0]
        rows = [len(next(iter(it.values()))) for it in items]
        total = sum(rows)
        # Pad to the fixed max_batch shape (a lone oversized request runs
        # at its own size); pad rows are zeros and row-independent.
        padded = self.max_batch if total <= self.max_batch else total
        batch = {
            k: np.zeros((padded,) + np.asarray(v).shape[1:], np.asarray(v).dtype)
            for k, v in proto.items()
        }
        off = 0
        for it, r in zip(items, rows):
            for k in batch:
                batch[k][off : off + r] = it[k]
            off += r
        with torch.inference_mode():
            inputs = {
                k: torch.from_numpy(v).to(self.device) for k, v in batch.items()
            }
            out = self._predict(params, inputs)
            if not isinstance(out, dict):
                out = {"output": out}
            # Only the real rows cross to the host; the pad rows are dropped
            # on the device (a logits row at full width is 131 MB).
            out_host = {k: _to_host(v[:total]) for k, v in out.items()}
        results = []
        off = 0
        for r in rows:
            results.append(
                (step, {k: v[off : off + r] for k, v in out_host.items()})
            )
            off += r
        with self._lock:
            self._predicts += total
            self._applies += 1
        return results

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        b = self._batcher.stats()
        core = self._core.core_stats()
        with self._lock:
            s = {
                "service": SERVICE,
                "role": self.role,
                "incarnation": self._incarnation,
                "model_step": self.model_step,
                "model_version": self.model_version,
                "model_name": self.model_name,
                "tenant": self.tenant,
                "pinned": True,
                "device": str(self.device),
                "requests": core["requests"],
                "live_conns": core["live_conns"],
                "shed_total": core["shed_total"],
                "queue_deadline_drops": core["queue_deadline_drops"],
                "core": core,
                "tenants": core["tenants"],
                "predict_rows": self._predicts,
                "applies": self._applies,
                "overloads": self._overloads,
                "refresh_errors": self._refresh_errors,
                "decode_sessions_open": len(self._sessions),
                "decode_opens": self._decode_opens,
            }
        s.update({f"batcher_{k}": v for k, v in b.items()})
        if self._engine is not None:
            s.update({f"decode_{k}": v for k, v in self._engine.stats().items()})
        s.update(self.latency.percentile_scalars("serve"))
        s["registry"] = telemetry.snapshot()
        s["flight_events"] = len(telemetry.RECORDER)
        return s

    # -- the core handler ----------------------------------------------------

    def _handle(self, conn, op: int, name: str, a: int, b: int, payload):
        if op == SRV_PREDICT:
            t0 = time.perf_counter()
            try:
                inputs = wire.decode_batch_bytes(payload)
            except (ValueError, TypeError, KeyError):
                return ERR, None
            return self._handle_predict(conn, inputs, t0)
        if op == SRV_DECODE_OPEN:
            return self._handle_decode_open(a, payload)
        if op == SRV_DECODE_NEXT:
            return self._handle_decode_next(a, b)
        if op == SRV_DECODE_CLOSE:
            return self._handle_decode_close(a)
        if op == SRV_STATS:
            return 0, [json.dumps(self.stats()).encode()]
        if op == SRV_SHUTDOWN:
            self.shutdown_requested.set()
            return 0, None
        return ERR, None

    def _stamp(self, out: dict) -> dict:
        """The served registry version rides every predict response."""
        out = dict(out)
        out[wire.SRV_VERSION_FIELD] = np.int64(self.model_version)
        return out

    # -- decode sessions ----------------------------------------------------

    def _handle_decode_open(self, max_new_tokens: int, payload):
        if self._engine is None:
            return NO_DECODER, None
        try:
            prompt = np.asarray(wire.decode_batch_bytes(payload)["prompt"])
        except (ValueError, TypeError, KeyError):
            return ERR, None
        try:
            ticket = self._engine.open(prompt, max_new_tokens)
        except ValueError:
            return ERR, None
        except batcher_lib.Overloaded:
            with self._lock:
                self._overloads += 1
            return wire.retry_later_status(self._retry_after_ms), None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._sessions[sid] = [ticket, time.monotonic()]
            self._decode_opens += 1
        return sid, None

    def _handle_decode_next(self, sid: int, cursor: int):
        with self._lock:
            entry = self._sessions.get(sid)
            if entry is not None:
                entry[1] = time.monotonic()
        if entry is None:
            return BAD_SESSION, None
        try:
            tokens, done = entry[0].snapshot(cursor)
        except Exception:  # noqa: BLE001 — a failed step answers loudly
            log.error("decode session %d failed server-side", sid, exc_info=True)
            with self._lock:
                self._sessions.pop(sid, None)
            return ERR, None
        out = self._stamp({
            "tokens": np.asarray(tokens, np.int32),
            "done": np.asarray([1 if done else 0], np.uint8),
        })
        return self.model_step, wire.encode_batch(out)

    def _handle_decode_close(self, sid: int):
        with self._lock:
            entry = self._sessions.pop(sid, None)
        if entry is not None:
            entry[0].cancel()
        return 0, None  # idempotent: closing an unknown session is a no-op

    def _handle_predict(self, conn, inputs: dict, t0: float):
        if not inputs:
            return ERR, None
        lens = {len(v) if v.ndim else -1 for v in inputs.values()}
        if len(lens) != 1 or -1 in lens:
            # Every field must share one leading dim: the row unit the
            # batcher budgets and the scatter slices by.
            return ERR, None
        if any(isinstance(v, torch.Tensor) for v in inputs.values()):
            return ERR, None  # bfloat16 inputs: no model of this slice takes them
        # Requests coalesce only with SCHEMA-IDENTICAL neighbours, so one
        # mismatched request fails alone, in its own apply.
        schema = tuple(sorted(
            (k, v.shape[1:], str(v.dtype)) for k, v in inputs.items()
        ))
        try:
            ticket = self._batcher.submit(inputs, rows=lens.pop(), key=schema)
        except batcher_lib.Overloaded:
            with self._lock:
                self._overloads += 1
            return wire.retry_later_status(self._retry_after_ms), None

        def _resolved(value, error) -> None:
            with self._lock:
                self._pending_tickets.pop(ticket, None)
            if error is not None:
                log.error(
                    "batched predict failed server-side", exc_info=error
                )
                conn.reply(ERR, None)
                return
            step, out = value
            try:
                conn.reply(step, wire.encode_batch(self._stamp(out)))
            except Exception:  # noqa: BLE001 — an unanswered conn would wedge
                log.error(
                    "predict reply failed (unserializable output?)",
                    exc_info=True,
                )
                conn.reply(ERR, None)
                return
            self.latency.record(time.perf_counter() - t0)
            if (
                self._writer is not None
                and self.latency.total % self._metrics_every == 0
            ):
                self._writer.scalars(
                    self.model_step, self.latency.percentile_scalars("serve")
                )

        with self._lock:
            self._pending_tickets[ticket] = (
                time.monotonic() + self._ticket_deadline_s
            )
        ticket.on_resolve(_resolved)
        return server_core.ASYNC


# ----------------------------------------------------------------------------
# Task-role hosting (the CLI's `serve` job)
# ----------------------------------------------------------------------------


def host_serve_task(
    *, param_shapes, predict_fn, ps_addrs=(), port: int, device=None,
    loopback_only: bool = True, max_batch: int = 32,
    max_wait_ms: float = 5.0, queue_depth: int = 128,
    refresh_ms: float = 50.0, metrics_dir: str | None = None,
    membership: bool = False, queue_deadline_ms: float = 0.0,
    registry_dir: str | None = None, model_name: str = "default",
    model_version: int | None = None, decode_fns: tuple | None = None,
    decode_slots: int = 4, decode_max_len: int = 512,
    tenant: str = tenancy.DEFAULT_TENANT, tenant_quotas: dict | None = None,
    on_ready=None,
) -> int:
    """Dedicated serve-task body (``--job_name=serve``): host one pinned
    replica until a client sends SRV_SHUTDOWN (or the supervisor dies);
    returns the port it bound.  Arms ``die`` fault specs off the replica's
    request counter, as the JAX task does.  ``on_ready(server)``, when
    given, is called once the replica is listening (an in-process host
    learns the bound port from it)."""
    server = ModelReplicaServer(
        param_shapes, predict_fn, ps_addrs, device=device, port=port,
        loopback_only=loopback_only, max_batch=max_batch,
        max_wait_ms=max_wait_ms, queue_depth=queue_depth,
        refresh_ms=refresh_ms, metrics_dir=metrics_dir,
        membership=membership, queue_deadline_ms=queue_deadline_ms,
        registry_dir=registry_dir, model_name=model_name,
        model_version=model_version, decode_fns=decode_fns,
        decode_slots=decode_slots, decode_max_len=decode_max_len,
        tenant=tenant, tenant_quotas=tenant_quotas,
    )
    faults.arm_process_faults(
        request_count_fn=server.request_count,
        leave_fn=lambda: server.stop(),
    )
    log.info(
        "serve task on port %d (model_step=%d; blocking until shutdown)",
        server.port, server.model_step,
    )
    if on_ready is not None:
        on_ready(server)
    supervised = os.environ.get("DTX_SERVE_SUPERVISED") == "1"
    ppid0 = os.getppid()
    while not server.shutdown_requested.wait(timeout=2.0):
        if supervised and os.getppid() != ppid0:
            log.warning("serve task: supervisor died; exiting")
            break
    bound = server.port
    server.stop()
    return bound
