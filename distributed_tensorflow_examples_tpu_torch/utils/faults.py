"""Deterministic, seedable fault-injection layer for the PS path.

The reference inherits TF's fault model: a lost PS task stalls every worker
until the runtime tears the session down and the whole job crash-restarts
(SURVEY.md section 5.3).  This module makes faults *injectable, survivable
and tested* instead: a fault plan — activated via the ``DTX_FAULT_PLAN``
env var, so every child process of a ``utils.multiprocess`` cluster (or a
``--job_name`` launch) inherits it — scripts exactly which process drops a
connection, delays an op, or dies, and when.  The recovery machinery under
test lives in ``parallel/ps_service.py`` (deadline/backoff/reconnect/replay)
and ``train/ps_experiment.py`` (PS task under ``supervise()``).

Plan syntax (semicolon-separated specs, ``kind:key=val,key=val``)::

    DTX_FAULT_PLAN='drop_conn:role=worker0,op=25;die:role=ps,after_reqs=120'

Kinds:

- ``drop_conn`` — the matching process's ``PSClient`` closes its socket
  right before its ``op``-th call (1-based, counted per client), forcing
  the reconnect+replay path.  ``count`` (default 1) repeats the fault on
  the following calls too.
- ``delay`` — sleep ``ms`` milliseconds before the ``op``-th call (and the
  next ``count-1`` calls): the slow-PS / slow-network fault.
- ``die`` — the matching PROCESS exits with code ``FAULT_EXIT_CODE`` (43)
  either ``after_s`` seconds after :func:`arm_process_faults`, or once the
  in-process PS server has served ``after_reqs`` requests (the "kill PS at
  step K" fault).  The request count tracks the coordination traffic but
  is not exactly reproducible across machines — idle shutdown-queue polls
  and bounded-wait chunk re-issues add timing-dependent requests — so
  pick triggers with margin (well above startup chatter, well below the
  run's total).  One-shot: a supervisor restarting the task strips the
  spec via :func:`plan_without` so the incarnation that heals is not
  re-killed.
- ``partition`` — drop traffic between two named roles while BOTH stay
  alive: the fault that tests failover and split-brain guards distinctly
  from death.  Two shapes: (a) process-level, ``partition:role=ps0,
  peer=ps2`` — the matching SERVICE process severs its replication link
  toward the peer role by policy (``arm_process_faults(partition_fn=...)``
  — for a replicated PS pair the next mutating op then fails loudly with
  the divergence error instead of silently splitting brains); timing via
  ``after_s``/``after_reqs`` like ``die``, or immediately when neither is
  given.  (b) client-level, ``partition:role=worker0,op=5`` — from the
  ``op``-th call onward, EVERY op on the matching client severs its
  socket first (the persistent-drop analog of ``drop_conn``): the client
  keeps healing by reconnect, so this models a flapping/black-holed link
  rather than a dead peer.

Every spec takes ``role=`` (fnmatch glob, default ``*``) matched against
the process role — set by launchers via the ``DTX_FAULT_ROLE`` env var or
:func:`set_role` (``ps0``, ``chief0``, ``worker1``, ``data_service0``,
``serve0``, ``task2``...).  Per-connection client roles derive from the
process role: a worker's prefetch PS connection is ``worker<i>_pf``, its
data-service connections are ``<role>_ds`` (``data/data_service.py``) and
a process's serving-wire connections are ``<role>_sv``
(``serve/client.py``), so plans can target one transport of a process
without firing on the others; broad globs (``worker0*``) still match them
all.  Client
faults additionally take ``p=``/``seed=`` for probabilistic injection: the
RNG is seeded from ``(seed, role, op-kind)``, and op indices count LOGICAL
client ops (chunk re-issues of one blocking op don't advance the counter),
so a given plan fires at the same logical operation in every run —
deterministic AND seedable.  (``after_reqs`` is the exception: see above.)

Observability: every injected fault and every recovery action logs one
structured line through the ``dtx.faults`` logger (``dtx.faults
event=<name> k=v ...``), so tests — and operators grepping task logs —
can assert the recovery path actually ran.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging
import os
import sys
import threading
import time
import zlib

from . import telemetry

log = logging.getLogger("dtx.faults")

#: Exit code of a fault-injected process death ("die" spec).  Distinctive so
#: supervisors/tests can tell an injected kill from an organic crash.
FAULT_EXIT_CODE = 43

_CLIENT_KINDS = ("drop_conn", "delay", "partition")
# Membership event kinds (r14 elasticity): ``leave`` — the matching
# process departs GRACEFULLY (runs its registered leave hooks — release
# the membership lease, stop the service — then exits 0, so a supervisor
# treats it as done, not a crash to heal); ``join`` — an ORCHESTRATOR
# event (only a process that can spawn new tasks can honor it): loadsim
# reads matching specs via :func:`join_specs` and starts the named role at
# ``after_s``; in-process arming skips it loudly.  Together with ``die``
# they script a full kill/join/leave cycle per role.
_KINDS = _CLIENT_KINDS + ("die", "leave", "join")

_role_lock = threading.Lock()
_role: str | None = None

_control_codes: frozenset | None = None


def control_op_codes() -> frozenset:
    """Wire op CODES of every control-plane op, all three services —
    derived from the one registry (``wire.CONTROL_OPS``; codes are
    disjoint across services except the shared HELLO point, so one flat
    set serves every wire's injector).  The client op index SKIPS these:
    ``op=N`` plan indices address logical data-plane ops, and heartbeat/
    scrape/epoch-poll cadence must never shift them (the r15 fault-index
    drift, generalized).  Lazy import: wire is JAX-free, but resolving it
    at module load would order utils before parallel in every importer."""
    global _control_codes
    if _control_codes is None:
        from ..parallel import wire

        registries = {
            "ps": wire.PS_OPS, "dsvc": wire.DSVC_OPS, "msrv": wire.SRV_OPS,
        }
        _control_codes = frozenset(
            registries[svc][name]
            for svc, names in wire.CONTROL_OPS.items()
            for name in names
        )
    return _control_codes


@dataclasses.dataclass
class FaultSpec:
    kind: str
    role: str = "*"  # fnmatch glob against the process role
    op: int = 0  # client faults: 1-based call index the fault fires at
    count: int = 1  # client faults: consecutive calls affected
    ms: float = 0.0  # delay: sleep duration
    after_s: float = 0.0  # die/partition: seconds after arming
    after_reqs: int = 0  # die/partition: server requests served
    p: float = 1.0  # client faults: per-eligible-op probability
    seed: int = 0  # seeds the probabilistic RNG (with role+kind)
    peer: str = "*"  # partition: glob for the OTHER side of the cut link

    def matches_role(self, role: str) -> bool:
        return fnmatch.fnmatchcase(role, self.role)

    def matches_peer(self, role: str) -> bool:
        return fnmatch.fnmatchcase(role, self.peer)


def parse_plan(plan: str) -> list[FaultSpec]:
    """Parse a ``DTX_FAULT_PLAN`` string; raises ValueError on bad syntax so
    a typo'd plan fails the launch instead of silently injecting nothing."""
    specs: list[FaultSpec] = []
    for raw in plan.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, rest = raw.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r}")
        kw: dict = {}
        for item in filter(None, (s.strip() for s in rest.split(","))):
            key, has_eq, val = item.partition("=")
            if not has_eq:
                raise ValueError(f"bad fault field {item!r} in {raw!r}")
            if key in ("role", "peer"):
                kw[key] = val
            elif key in ("op", "count", "after_reqs", "seed"):
                kw[key] = int(val)
            elif key in ("ms", "after_s", "p"):
                kw[key] = float(val)
            else:
                raise ValueError(f"unknown fault field {key!r} in {raw!r}")
        spec = FaultSpec(kind=kind, **kw)
        # ``partition`` is exempt: its process shape (role+peer, timed like
        # die or immediate) carries no op index; only its op>0 form is a
        # client fault.
        if spec.kind in _CLIENT_KINDS and spec.kind != "partition" \
                and spec.op <= 0:
            raise ValueError(f"{kind} fault needs op=<n> (1-based): {raw!r}")
        if spec.kind in ("die", "leave") and not (
            spec.after_s > 0 or spec.after_reqs > 0
        ):
            raise ValueError(
                f"{kind} fault needs after_s or after_reqs: {raw!r}"
            )
        if spec.kind == "join" and not spec.after_s > 0:
            raise ValueError(
                f"join event needs after_s (orchestrators schedule joins "
                f"by wall time): {raw!r}"
            )
        specs.append(spec)
    return specs


def format_plan(specs: list[FaultSpec]) -> str:
    """Inverse of :func:`parse_plan` (used to strip fired specs on restart)."""
    out = []
    for s in specs:
        fields = []
        defaults = FaultSpec(kind=s.kind)
        for f in dataclasses.fields(FaultSpec):
            if f.name == "kind":
                continue
            v = getattr(s, f.name)
            if v != getattr(defaults, f.name):
                fields.append(f"{f.name}={v}")
        out.append(s.kind + (":" + ",".join(fields) if fields else ""))
    return ";".join(out)


def plan_without(plan: str, kind: str, role: str) -> str:
    """The plan minus specs of ``kind`` whose role glob matches ``role`` —
    how a supervisor avoids re-killing the incarnation that heals the
    fault it just injected."""
    return format_plan(
        [s for s in parse_plan(plan) if not (s.kind == kind and s.matches_role(role))]
    )


def set_role(role: str) -> None:
    """Set this process's fault role (launchers call this; also exported to
    children via ``DTX_FAULT_ROLE``)."""
    global _role
    with _role_lock:
        _role = role
    os.environ["DTX_FAULT_ROLE"] = role


def current_role() -> str:
    with _role_lock:
        if _role is not None:
            return _role
    return os.environ.get("DTX_FAULT_ROLE", "")


def active_plan() -> str:
    return os.environ.get("DTX_FAULT_PLAN", "")


def log_event(event: str, **fields) -> None:
    """One structured ``dtx.faults`` line per fault/recovery action.  A
    stderr handler (and an INFO level) is attached on first use when the
    ambient logging config would swallow the event — recovery evidence
    must reach per-task log files even in processes whose root logger sits
    at the WARNING default.  Propagation stays on, so pytest's caplog (and
    any operator-configured root handler) still sees every event.

    Every line is ALSO retained by the process flight recorder (r13
    dtxobs): injected faults and recovery actions stay attributable
    post-hoc from the recorder's JSONL dump even when no log collector
    was watching the process."""
    try:
        telemetry.record_event(event, **fields)
    except Exception:
        pass  # observability must never fail the recovery path it observes
    if not log.handlers and not log.isEnabledFor(logging.INFO):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(message)s"))
        log.addHandler(h)
        log.setLevel(logging.INFO)
    kv = " ".join(f"{k}={fields[k]}" for k in sorted(fields))
    log.info("dtx.faults event=%s%s", event, (" " + kv) if kv else "")


class ClientFaultInjector:
    """Per-``PSClient`` hook: consults the plan before every client op.
    Deterministic — the op counter is per client, and the probabilistic RNG
    is seeded from (seed, role, kind).

    Control-plane ops (:func:`control_op_codes`) neither advance the
    counter nor fire faults, so a client that interleaves scrapes or
    epoch polls with its data ops keeps stable plan indices.
    ``count_control_ops=True`` is the opt-in for DEDICATED control
    clients (the ``_lm`` membership legs): their lease stream IS their
    logical op stream, and excluding it would leave them untargetable."""

    def __init__(
        self, role: str | None = None, plan: str | None = None,
        count_control_ops: bool = False,
    ):
        self.role = role if role is not None else current_role()
        raw = plan if plan is not None else active_plan()
        # Only a partition spec's CLIENT shape (an explicit op index)
        # belongs here — its process shape (role+peer) arms at the service
        # host via arm_process_faults and must not also sever the host's
        # own client legs.
        self._specs = [
            s
            for s in (parse_plan(raw) if raw else [])
            if s.kind in _CLIENT_KINDS and s.matches_role(self.role)
            and (s.kind != "partition" or s.op > 0)
        ]
        self._op = 0
        self._rngs: dict[int, "_DetRng"] = {}
        # Resolved only when a plan is live: the no-faults hot path must
        # not import the wire registry.
        self._control: frozenset = (
            frozenset() if (count_control_ops or not self._specs)
            else control_op_codes()
        )

    def _fires(self, i: int, spec: FaultSpec) -> bool:
        if spec.kind == "partition":
            # Persistent from its op index onward (count ignored): a
            # partition stays cut until the plan changes.
            if self._op < spec.op:
                return False
        elif not (spec.op <= self._op < spec.op + spec.count):
            return False
        if spec.p >= 1.0:
            return True
        rng = self._rngs.setdefault(i, _DetRng(spec.seed, self.role, spec.kind))
        return rng.uniform() < spec.p

    def before_op(self, op_code: int) -> bool:
        """Advance the op counter; sleep for matching delays.  Returns True
        when a drop_conn/partition fault fires (the caller must sever its
        socket)."""
        if not self._specs or op_code in self._control:
            return False
        self._op += 1
        drop = False
        for i, spec in enumerate(self._specs):
            if not self._fires(i, spec):
                continue
            if spec.kind == "delay":
                log_event(
                    "inject_delay", role=self.role, op=self._op,
                    op_code=op_code, ms=spec.ms, spec=format_plan([spec]),
                )
                time.sleep(spec.ms / 1000.0)
            elif spec.kind == "drop_conn":
                log_event(
                    "inject_drop_conn", role=self.role, op=self._op,
                    op_code=op_code, spec=format_plan([spec]),
                )
                drop = True
            elif spec.kind == "partition":
                if self._op == spec.op:  # log the cut once, not per op
                    log_event(
                        "inject_partition", role=self.role, op=self._op,
                        op_code=op_code, spec=format_plan([spec]),
                    )
                drop = True
        return drop


class _DetRng:
    """Tiny deterministic uniform stream (no numpy import on the hot path):
    xorshift64* seeded from (seed, role, kind)."""

    def __init__(self, seed: int, role: str, kind: str):
        self._s = (
            (seed * 0x9E3779B97F4A7C15)
            ^ zlib.crc32(f"{role}/{kind}".encode())
        ) & 0xFFFFFFFFFFFFFFFF or 0x2545F4914F6CDD1D

    def uniform(self) -> float:
        x = self._s
        x ^= (x >> 12) & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x << 25)) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 27
        self._s = x
        return ((x * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) / 2**64


def client_injector(
    role: str | None = None, *, count_control_ops: bool = False,
) -> ClientFaultInjector | None:
    """A ``ClientFaultInjector`` for this process, or None when the plan has
    no client faults for the role (keeps the no-faults hot path at zero
    cost: one None check per op).  ``count_control_ops``: see
    :class:`ClientFaultInjector` — dedicated control clients only."""
    inj = ClientFaultInjector(role=role, count_control_ops=count_control_ops)
    return inj if inj._specs else None


def join_specs(plan: str, role: str | None = None) -> list[FaultSpec]:
    """The plan's ``join`` events (optionally filtered by a role glob
    match) — the ORCHESTRATOR's half of membership chaos: only a process
    that can spawn cluster tasks (tools/loadsim.py) can honor a join, so
    it reads them from here instead of :func:`arm_process_faults`."""
    return [
        s
        for s in (parse_plan(plan) if plan else [])
        if s.kind == "join" and (role is None or s.matches_role(role))
    ]


# Late-registered graceful-departure hooks (r14): a process arms its
# ``leave`` specs before its services (and their membership leases) exist,
# so the hooks are looked up at FIRE time.  Typical hooks: release the
# lease, stop the server.  Run in reverse registration order, each
# guarded — departure must not hang on a broken service.
_leave_hooks: list = []


def register_leave_hook(fn) -> None:
    _leave_hooks.append(fn)


def _leave(spec: FaultSpec, role: str, leave_fn=None, **fields) -> None:
    log_event(
        "inject_leave", role=role, spec=format_plan([spec]), **fields,
    )
    telemetry.dump_flight_recorder(f"inject_leave role={role}")
    for fn in [leave_fn] + list(reversed(_leave_hooks)):
        if fn is None:
            continue
        try:
            fn()
        except Exception:
            pass
    for h in log.handlers:
        try:
            h.flush()
        except Exception:
            pass
    # Exit 0: a LEAVE is a clean departure — the supervisor (exit-0 =
    # done) must not resurrect a member that scaled itself down.
    os._exit(0)


def _die(spec: FaultSpec, role: str, **fields) -> None:
    log_event(
        "inject_die", role=role, exit=FAULT_EXIT_CODE,
        spec=format_plan([spec]), **fields,
    )
    # The process is about to hard-exit: persist the flight recorder NOW
    # (the injected death plus everything leading up to it), so a chaos
    # run's post-mortem can attribute the kill to its spec.
    telemetry.dump_flight_recorder(f"inject_die role={role}")
    for h in log.handlers:
        try:
            h.flush()
        except Exception:
            pass
    os._exit(FAULT_EXIT_CODE)


def arm_process_faults(
    role: str | None = None, *, request_count_fn=None, partition_fn=None,
    leave_fn=None,
) -> list[threading.Thread]:
    """Arm matching ``die``/``leave`` (and process-shape ``partition``)
    specs for this process.  ``after_s`` specs start a timer thread;
    ``after_reqs`` specs need ``request_count_fn`` (e.g.
    ``ps_service.server_request_count`` in a PS task) and poll it.
    ``partition_fn(spec) -> bool`` is the service host's cut-the-link hook
    (a replicated PS task severs its repl link when the spec's ``peer``
    glob matches its peer's role); partition specs without timing fields
    arm immediately.  ``leave_fn`` is the graceful-departure hook a
    ``leave`` spec runs before exiting 0 (late hooks can also be added via
    :func:`register_leave_hook`).  ``join`` specs are orchestrator events
    (:func:`join_specs`) and are skipped here, loudly.  Returns the
    watcher threads (daemonic; tests may join on a dead process)."""
    role = role if role is not None else current_role()
    raw = active_plan()
    if not raw:
        return []

    def fire_partition(spec):
        if partition_fn(spec):
            log_event(
                "inject_partition", role=role, peer=spec.peer,
                after_s=spec.after_s, after_reqs=spec.after_reqs,
                spec=format_plan([spec]),
            )

    threads: list[threading.Thread] = []
    for spec in parse_plan(raw):
        if spec.kind == "partition" and spec.op <= 0 and \
                spec.matches_role(role):
            if partition_fn is None:
                log_event(
                    "fault_unarmed", role=role, kind="partition",
                    reason="no_partition_hook_in_this_process",
                )
                continue
            if spec.after_s > 0:

                def ptimer(spec=spec):
                    time.sleep(spec.after_s)
                    fire_partition(spec)

                t = threading.Thread(
                    target=ptimer, daemon=True, name="dtx-fault-partition"
                )
                t.start()
                threads.append(t)
            elif spec.after_reqs > 0:
                if request_count_fn is None:
                    # Same contract as the die kind: a timed trigger with
                    # no counter to read must be SKIPPED loudly, never
                    # fired at request 0.
                    log_event(
                        "fault_unarmed", role=role, kind="partition",
                        reason="after_reqs_without_request_counter",
                    )
                    continue

                def ppoller(spec=spec):
                    while True:
                        if request_count_fn() >= spec.after_reqs:
                            fire_partition(spec)
                            return
                        time.sleep(0.02)

                t = threading.Thread(
                    target=ppoller, daemon=True, name="dtx-fault-partition"
                )
                t.start()
                threads.append(t)
            else:
                fire_partition(spec)
            continue
        if spec.kind == "join" and spec.matches_role(role):
            # Only an orchestrator (a process that can SPAWN cluster
            # tasks) can honor a join — skip loudly, like an unarmable
            # after_reqs trigger, so a plan wired to the wrong process is
            # never silently inert.
            log_event(
                "fault_unarmed", role=role, kind="join",
                reason="join_is_orchestrated",
            )
            continue
        if spec.kind not in ("die", "leave") or not spec.matches_role(role):
            continue
        fire = (
            _die
            if spec.kind == "die"
            else lambda spec, role, **kw: _leave(
                spec, role, leave_fn=leave_fn, **kw
            )
        )
        if spec.after_s > 0:

            def timer(spec=spec, fire=fire):
                time.sleep(spec.after_s)
                fire(spec, role, after_s=spec.after_s)

            t = threading.Thread(target=timer, daemon=True, name="dtx-fault-die")
            t.start()
            threads.append(t)
        if spec.after_reqs > 0:
            if request_count_fn is None:
                # Only a PS-server-hosting process has a request counter; a
                # broad role glob (e.g. the '*' default) must not take down
                # chief/worker tasks that merely match it — skip, loudly.
                log_event(
                    "fault_unarmed", role=role, kind=spec.kind,
                    reason="after_reqs_without_request_counter",
                )
                continue

            def poller(spec=spec, fire=fire):
                while True:
                    n = request_count_fn()
                    if n >= spec.after_reqs:
                        fire(spec, role, after_reqs=spec.after_reqs, reqs=n)
                    time.sleep(0.02)

            t = threading.Thread(target=poller, daemon=True, name="dtx-fault-die")
            t.start()
            threads.append(t)
    return threads
