"""Shared wire machinery for the cross-process services (r8 satellite).

The port's copy of ``distributed_tensorflow_examples_tpu/parallel/wire.py``:
the frames, HELLO and batch codec are byte-identical, so a client of either
package talks to a server of the other.  One difference: a ``bfloat16``
field is encoded from, and decoded to, a CPU ``torch.bfloat16`` tensor over
its raw 2-byte payload (the JAX package names that dtype through
``ml_dtypes``, which the port does not need).

All three socket services — the PS state service client
(``parallel/ps_service.py`` -> ``native/ps_server.cc``), the disaggregated
data service (``data/data_service.py``) and the model-serving replicas
(``serve/model_server.py``) — speak the same frame layout, the same HELLO
version negotiation, and the same zero-copy send/receive discipline.  This
module is the ONE definition of those pieces, factored out of ``ps_service``
so the services cannot drift:

- **Frame layout** — request: ``<BB`` (op, name_len) + name bytes + ``<qqI``
  (a, b, payload_len); response: ``<qI`` (status, payload_len).  The unit of
  ``payload_len`` is per-service: the PS wire counts ELEMENTS of the
  negotiated dtype (the C++ server's contract), the data and serving wires
  count BYTES (batches carry mixed-dtype fields).  The layout and the
  zero-copy paths are identical either way.
- **HELLO** (op 26, shared code point) — version+dtype negotiation, sent
  before any payload op can be misparsed.  Every service has a SERVICE
  IDENTITY too (r10): clients announce the service they expect in HELLO's
  ``b`` operand (:func:`pack_hello_b` ``service=``), the Python services
  answer through one shared helper (:func:`hello_answer`) that refuses a
  wrong-service dial with a status naming the service actually reached,
  and the shared client-side check (:func:`hello_failure`) turns every
  mismatch into a diagnostic naming BOTH ends.  The native PS server
  ignores the announcement bits (its success answer carries no tag), which
  is itself distinctive: a data/serve client reading a tag-less success
  knows it dialed the PS state service.
- **Zero-copy send** (:func:`send_frames`) — header + payload buffers leave
  via scatter/gather ``sendmsg``; payload bytes are never copied into a
  concatenated request buffer.
- **Zero-copy receive** (:func:`recv_exact`) — ``recv_into`` straight into
  the caller's buffer; no chunk accumulation (the pre-r7 ``bytes +=`` loop
  was O(n²) in payload size), no staging copy.
- **bf16 payload codec** — round-to-nearest-even f32<->bf16 bit-pattern
  conversion, bit-exact with the C++ server's ``f32_to_bf16``.
- **batch codec** (:func:`encode_batch` / :func:`read_batch`) — mixed-dtype
  field dicts as a JSON schema header + raw bytes, scatter/gather out and
  ``recv_into`` straight into the final arrays; shared by the data service
  (training batches) and the serving wire (predict inputs/outputs).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

#: Wire protocol version (must match native/ps_server.cc kWireVersion).
#: v3 (r12): the HELLO b-word's shard-identity fields moved (count bits
#: 32..55 -> 20..31, layout version and the repl flag added above them) —
#: the bump makes a v2/v3 HELLO pairing fail loudly (-4) instead of a
#: relocated field silently reading as "no expectation" and disabling the
#: mis-wire guard.  v4 (r18): requests may carry a per-op DEADLINE stamp
#: (op-byte bit 7 = :data:`DEADLINE_FLAG`, a trailing ``<I`` deadline_ms
#: field after the standard tail) and servers may SHED with the
#: :data:`RETRY_LATER_BASE` status band — the bump makes a mixed v3/v4
#: negotiated pairing fail loudly instead of a stamped frame misparsing
#: as an unknown op.  Un-stamped frames stay byte-identical to v3, so
#: HELLO-less connections (plain f32, no expectations) remain
#: version-agnostic, exactly as before.
WIRE_VERSION = 4

#: Payload encodings (HELLO dtype codes).  f32 framing is byte-identical
#: to wire v1; bf16 halves payload bytes and REQUIRES a negotiated peer.
WIRE_DTYPES = {"f32": 0, "bf16": 1}

# ----------------------------------------------------------------------------
# Protocol registries (r11): the ONE Python definition site for every op
# code and service status the three wires speak.  Service modules alias
# these names — they must never restate the numbers.  The native server's
# ``enum Op`` is the C++ mirror of PS_OPS; ``tools/dtxlint``'s
# wire-conformance pass pins the two against each other (names AND
# numbers), checks that every client-sent opcode has a server dispatch case,
# and refuses op/status collisions across services, so a renumbering in
# one place can never silently drift.
# ----------------------------------------------------------------------------

#: PS state-service op codes (native/ps_server.cc ``enum Op``).
PS_OPS: dict[str, int] = {
    "ACC_GET": 1,
    "ACC_APPLY": 2,
    "ACC_TAKE": 3,
    "ACC_SET_STEP": 4,
    "ACC_DROPPED": 5,
    "TQ_GET": 6,
    "TQ_PUSH": 7,
    "TQ_POP": 8,
    "GQ_GET": 9,
    "GQ_PUSH": 10,
    "GQ_POP": 11,
    "GQ_SET_MIN": 12,
    "GQ_DROPPED": 13,
    "CANCEL_ALL": 14,
    "PING": 15,
    "PSTORE_GET_OBJ": 16,
    "PSTORE_SET": 17,
    "PSTORE_GET": 18,
    "INCARNATION": 19,
    "ACC_APPLY_TAGGED": 20,
    "GQ_PUSH_TAGGED": 21,
    "ACC_DEDUPED": 22,
    "GQ_DEDUPED": 23,
    "ACC_RESET_WORKER": 24,
    "GQ_RESET_WORKER": 25,
    "HELLO": 26,
    "PSTORE_GET_IF_NEWER": 27,
    # PS shard replication (r12).  REPL_SYNC: a (re)starting replica pulls
    # its peer's full state (objects, param snapshots, dedup tables,
    # counters, state token) before it starts serving — server-to-server
    # only, over a repl-flagged connection.  REPL_TOKEN: answers the
    # server's STATE TOKEN as the status — the state-lineage id clients
    # compare on reconnect to tell "state intact (failover/resync)" from
    # "state lost (reseed needed)"; a pre-r12 server answers -2 and the
    # client falls back to incarnation-only semantics.
    "REPL_SYNC": 28,
    "REPL_TOKEN": 29,
    # Observability (r13 dtxobs).  STATS: answers the server's whole
    # counter table — shard identity, incarnation/state token, request and
    # connection counts, replication forward/sync/mirror counters, summed
    # dedup/dropped counters — as one raw JSON blob (payload counted in
    # 4-byte units like REPL_SYNC, NEVER dtype-encoded), so one scraper
    # (tools/dtxtop.py) reads a live cluster with zero side channels.
    # All three services carry a STATS op; code points stay disjoint so a
    # mis-wired scrape is refused, never misread.
    "STATS": 30,
    # Membership leases (r14 elasticity).  The coordinator shard hosts a
    # LEASE REGISTRY: every elastic member (async worker, serve replica)
    # ACQUIREs a lease naming itself and renews it on a heartbeat, so the
    # chief, the data service and dtxtop learn the LIVE set from the
    # registry instead of static --worker_hosts.  LEASE_ACQUIRE: name =
    # the member string (``membership.pack_member``), a = ttl_ms; answers
    # 1 (newly acquired — including a re-acquire after the old lease
    # EXPIRED, so a renewing client learns it lapsed) or 2 (renewal of a
    # live lease).  LEASE_RELEASE: the clean-departure signal (1 released
    # / 0 unknown, idempotent).  LEASE_LIST: the live set as one raw JSON
    # blob (4-byte units, dtype-independent, like STATS) — expired
    # entries are pruned at list time and counted.  Leases are liveness
    # state, deliberately NOT replicated (not forwarded, not in the
    # REPL_SYNC blob): after a failover the next heartbeat re-acquires on
    # the survivor within one TTL, the same self-healing posture as
    # tokens.
    "LEASE_ACQUIRE": 31,
    "LEASE_RELEASE": 32,
    "LEASE_LIST": 33,
    # Live resharding (r15).  The COORDINATOR shard stores one RESHARD
    # RECORD per slot — PENDING (a transition being prepared) and
    # COMMITTED (the current layout epoch) — as an opaque raw JSON blob
    # (``parallel/reshard.py`` owns the schema; payloads are raw 4-byte
    # units like STATS, never dtype-encoded).  RESHARD_BEGIN: a = the new
    # epoch version, payload = the record; stores/overwrites the pending
    # slot (idempotent — every joining shard task may announce the same
    # record); refused (-2) for a version not above the committed one.
    # RESHARD_COMMIT: a = version; promotes a matching pending record to
    # committed (idempotent when already committed at that version).
    # RESHARD_GET: a = caller's known version, b = slot (0 committed / 1
    # pending); answers the slot's version as the status (0 = empty) with
    # the record payload only when it is newer than ``a`` — so the
    # steady-state epoch poll every client runs costs O(header), exactly
    # like an unchanged-step PSTORE_GET_IF_NEWER.  RESHARD_ABORT: a =
    # version; clears a matching pending record (1 cleared / 0 nothing) —
    # the loud mid-transition bail-out.  All four are control-plane ops
    # excluded from the request counter (they fire on poll cadence, like
    # STATS/LEASE ops, and must not perturb ``die:after_reqs`` triggers).
    # REPL_SYNC additionally accepts a RANGE (a = start element, b =
    # element count > 0): the slice-ranged state transfer a new-layout
    # shard task assembles its slice from (param-store objects only; see
    # ps_server.cc for the ranged blob layout).
    "RESHARD_BEGIN": 34,
    "RESHARD_COMMIT": 35,
    "RESHARD_GET": 36,
    "RESHARD_ABORT": 37,
}

#: Data-service op codes (data/data_service.py).  Disjoint from the PS
#: range except the shared HELLO code point, so a frame sent to the wrong
#: service is refused, never misinterpreted.
DSVC_OPS: dict[str, int] = {
    "HELLO": 26,
    "REGISTER": 64,
    "GET_SPLIT": 65,
    "CLAIM_SPLIT": 66,
    "GET_BATCH": 67,
    "HEARTBEAT": 68,
    "STATS": 69,
    "GET_EVAL": 70,
    "SHUTDOWN": 71,
}

#: Serving-replica op codes (serve/model_server.py), disjoint from both.
#: DECODE_* (r19) are the STREAM code points of the decode-serving wire:
#: a stateful autoregressive session is OPENed (payload = the prompt
#: batch, ``a`` = max new tokens; the session id answers as the status),
#: then the client PULLS its token stream incrementally — DECODE_NEXT's
#: ``a`` is the session id and ``b`` the client's CURSOR (tokens already
#: received), and the server answers ``emitted[cursor:]`` — so a replayed
#: poll after a reconnect re-reads instead of double-draining (the same
#: replay-safety discipline as pure PREDICT, bought with a cursor instead
#: of purity).  DECODE_CLOSE is idempotent.  All three are DATA-plane ops
#: (counted; a decode session is real served work, not poll cadence).
SRV_OPS: dict[str, int] = {
    "HELLO": 26,
    "PREDICT": 96,
    "STATS": 97,
    "SHUTDOWN": 98,
    "DECODE_OPEN": 99,
    "DECODE_NEXT": 100,
    "DECODE_CLOSE": 101,
}

#: Data-service response statuses.  Positive codes are per-op results
#: (END_OF_SPLIT and CLAIM_DONE deliberately share 1 — they answer
#: different ops); negative codes are the error band and must stay unique.
DSVC_STATUS: dict[str, int] = {
    "OK": 0,
    "END_OF_SPLIT": 1,  # GET_BATCH index past the split; GET_EVAL w/o chunk
    "CLAIM_DONE": 1,  # CLAIM_SPLIT: already completed this epoch
    "CLAIM_TAKEN": 2,  # CLAIM_SPLIT: assigned to another live worker
    "ERR": -2,  # bad op / bad operands / handler failure
    "WAIT": -3,  # GET_SPLIT: nothing pending right now — poll again
    "EPOCH_ROLLED": -4,  # GET_SPLIT: the constrained epoch is over
}

#: Serving-replica response statuses.  PREDICT success answers the served
#: model_step (>= 0) as the status, so only the error band is enumerated.
SRV_STATUS: dict[str, int] = {
    "ERR": -2,  # bad request / failed apply
    "OVERLOAD": -7,  # admission control: queue full, back off / try a peer
    "NO_MODEL": -8,  # replica up but no published snapshot yet (warming)
    "BAD_SESSION": -9,  # DECODE_NEXT/CLOSE: unknown or expired session id
    "NO_DECODER": -10,  # DECODE_OPEN: this replica serves no decode path
}

#: Reserved field name the serving replica stamps into every predict /
#: decode response batch: the REGISTRY MODEL VERSION the answer was served
#: from (r19; 0 = hot-tracking the live training run, no pinned version).
#: The client strips it before handing outputs to the caller, so the
#: version rides next to ``model_step`` with zero schema impact on user
#: fields — pools read it to keep per-version (canary vs stable)
#: latency/error accounting.
SRV_VERSION_FIELD = "__model_version__"

#: msrv HELLO version word (r19): a serving replica's HELLO success answer
#: is its 4-byte service tag PLUS one ``<q`` MODEL VERSION (0 =
#: hot-tracking) — a dialing pool learns which registry version the
#: replica serves before routing a single predict, which is what makes
#: canary-weighted routing work on freshly discovered replicas.  Pre-r19
#: msrv replicas answer the bare tag; clients treat that as version 0.
HELLO_VERSION_TAIL = struct.Struct("<q")


def unpack_hello_tag(payload: bytes | None) -> tuple[bytes | None, int]:
    """Split a Python-service HELLO success payload into ``(tag,
    model_version)``.  A bare 4-byte tag (dsvc, pre-r19 msrv) carries
    version 0; anything else hands the payload back unsplit so
    :func:`hello_failure` names it in the diagnostic."""
    if payload is None:
        return None, 0
    payload = bytes(payload)
    if len(payload) == 4:
        return payload, 0
    if len(payload) == 4 + HELLO_VERSION_TAIL.size:
        return payload[:4], HELLO_VERSION_TAIL.unpack(payload[4:])[0]
    return payload, 0

#: Control-plane ops per service (r16): the ONE definition of which ops
#: are excluded from (a) every server's request counter and (b) the
#: client-side fault-injection op index.  The request counter is the
#: fault layer's deterministic ``die:after_reqs`` trigger and an exported
#: metric; the fault op index is how ``DTX_FAULT_PLAN`` ``op=N`` specs
#: address logical client ops.  Control ops fire on CONNECTION and
#: WALL-CLOCK cadence (handshakes, identity probes, scrapes, heartbeats,
#: epoch polls) — counting them would make both notions drift with dial
#: and poll frequency instead of tracking data-plane progress.  Exclusion
#: sites derive from this dict and NOTHING else: the C++ server's
#: ``kControlOps`` block mirrors CONTROL_OPS["ps"] (pinned both
#: directions by ``tools/dtxlint``'s control pass), the dsvc/msrv counter
#: branches and ``utils/faults``' op-index accounting read it directly.
#: REPL_SYNC is deliberately NOT here: a state transfer is real traffic
#: (one per restart/join), not poll cadence, and it has always counted.
CONTROL_OPS: dict[str, frozenset[str]] = {
    "ps": frozenset({
        "HELLO", "INCARNATION", "REPL_TOKEN", "STATS",
        "LEASE_ACQUIRE", "LEASE_RELEASE", "LEASE_LIST",
        "RESHARD_BEGIN", "RESHARD_COMMIT", "RESHARD_GET", "RESHARD_ABORT",
    }),
    "dsvc": frozenset({"HELLO", "STATS"}),
    "msrv": frozenset({"HELLO", "STATS"}),
}

# Multi-tenancy (r20 dtxtenant): tenancy is a KEY-PREFIX protocol, not a
# new op family — a tenant's PS objects live under ``t.<tenant>.<name>``
# and its lease identities under ``t.<tenant>.<member>``, so v<=4 frames
# from untagged (pre-tenant) clients stay byte-identical and simply land
# in the ``default`` tenant (whose keys carry NO prefix at all).  The
# prefix below is the ONE wire-level definition: ``parallel/tenancy.py``
# builds every qualified key from it, ``native/ps_server.cc`` mirrors it
# as ``kTenantKeyPrefix`` (for the per-tenant STATS breakdown and the
# prefix-filtered CANCEL_ALL), and ``tools/dtxlint``'s tenant pass pins
# the two and refuses prefix construction anywhere else.
TENANT_KEY_PREFIX = "t."

#: PS ops whose ``name`` operand is a TENANT-SCOPED OBJECT KEY — the ops
#: :meth:`ps_service.PSClient.call` qualifies with the caller's tenant
#: prefix.  Everything else (HELLO/STATS/PING/INCARNATION, the lease ops
#: — whose names are member docs, tenant-scoped inside ``pack_member`` —
#: the reshard/replication control surface, and CANCEL_ALL, whose name is
#: a raw prefix FILTER) passes its name through untouched.  Declared as a
#: literal so dtxlint's tenant pass can validate every entry against
#: PS_OPS and pin the qualification site against this set.
TENANT_SCOPED_OPS: dict[str, frozenset[str]] = {
    "ps": frozenset({
        "ACC_GET", "ACC_APPLY", "ACC_TAKE", "ACC_SET_STEP", "ACC_DROPPED",
        "ACC_APPLY_TAGGED", "ACC_DEDUPED", "ACC_RESET_WORKER",
        "TQ_GET", "TQ_PUSH", "TQ_POP",
        "GQ_GET", "GQ_PUSH", "GQ_POP", "GQ_SET_MIN", "GQ_DROPPED",
        "GQ_PUSH_TAGGED", "GQ_DEDUPED", "GQ_RESET_WORKER",
        "PSTORE_GET_OBJ", "PSTORE_SET", "PSTORE_GET", "PSTORE_GET_IF_NEWER",
    }),
}

#: Protocol state machines (r16): the legal op orderings each wire's
#: conversation must respect, declared as pure DATA (dict/list/str
#: literals only) so ``tools/dtxlint``'s protocol pass can both validate
#: the machines (every op real, every state reachable, every transition
#: exercised by some call-site) and lint client call-sites against them.
#: ``aliases`` name the wrapper callables that stand for an op at a
#: call-site (``client.reshard_commit(...)`` IS a RESHARD_COMMIT).
WIRE_PROTOCOLS: dict[str, dict] = {
    # Tagged services: HELLO is the FIRST op on every fresh connection —
    # nothing the peer could misparse may precede the version/service
    # negotiation.  (The native PS accepts HELLO-less f32 connections by
    # design, so "ps" is exempt.)
    "hello-first": {
        "kind": "first_op",
        "services": ["dsvc", "msrv"],
        "op": "HELLO",
    },
    # A reshard transition BEGINs once and then COMMITs or ABORTs — no
    # second BEGIN at the same version, no commit without a pending
    # record.  "pending" self-loops are deliberately absent: a re-BEGIN
    # inside one code block is the half-applied-transition bug class.
    "reshard-transition": {
        "kind": "session",
        "service": "ps",
        "init": "idle",
        "transitions": {
            "idle": {"RESHARD_BEGIN": "pending"},
            "pending": {"RESHARD_COMMIT": "idle", "RESHARD_ABORT": "idle"},
        },
        "aliases": {
            "RESHARD_BEGIN": ["reshard_announce"],
            "RESHARD_COMMIT": ["reshard_commit"],
            "RESHARD_ABORT": ["reshard_abort"],
        },
    },
    # A lease is ACQUIRED (or renewed) before it can be RELEASED.
    "lease-lifecycle": {
        "kind": "session",
        "service": "ps",
        "init": "released",
        "transitions": {
            "released": {"LEASE_ACQUIRE": "held"},
            "held": {"LEASE_ACQUIRE": "held", "LEASE_RELEASE": "released"},
        },
        "aliases": {
            "LEASE_ACQUIRE": ["lease_acquire"],
            "LEASE_RELEASE": ["lease_release"],
        },
    },
    # A layout-epoch joiner assembles its slice from the old tier (ranged
    # REPL_SYNC) BEFORE announcing the pending transition record: a
    # record whose announcer has not synced could be committed against an
    # unassembled shard.
    "sync-before-announce": {
        "kind": "order",
        "service": "ps",
        "first": "REPL_SYNC",
        "then": "RESHARD_BEGIN",
        "aliases": {
            "REPL_SYNC": [
                "ranged_sync", "assemble_slice", "assemble_for_shard",
                "install_assembled", "join_new_shard",
            ],
            "RESHARD_BEGIN": ["reshard_announce"],
        },
    },
}

#: The shared HELLO op code (one code point for every service, so one
#: negotiation routine serves all three wires).
HELLO_OP = PS_OPS["HELLO"]

# Sharded PS (r9, field layout revised r12): HELLO's b operand carries the
# SHARD IDENTITY the client expects of the server it dialed — dtype code in
# bits 0..7, expected shard id in bits 8..19, expected shard count in bits
# 20..31, expected LAYOUT VERSION in bits 32..47 (the shard-topology epoch
# — the plumbing live N->M resharding rides on: mixed-epoch clients fail
# the dial loudly instead of scattering onto the wrong partition), and the
# replication-peer flag at bit 48 (the server-to-server forward/sync
# connection announces itself so mirrors are never re-forwarded and a
# partitioned peer can refuse it by policy).  A zero count/version means
# "no expectation" (every pre-r9 client — their b is just the dtype code,
# < 256 — packs identically).  The server answers ``-5 - packed(own
# identity)`` on a mismatch, so a mis-wired dial fails loudly at connect,
# naming what was actually reached, instead of silently serving the wrong
# slice (or the wrong epoch) of the parameter vector.
HELLO_SHARD_ID_SHIFT = 8
HELLO_SHARD_COUNT_SHIFT = 20
HELLO_SHARD_MASK = 0xFFF
HELLO_LAYOUT_SHIFT = 32
HELLO_LAYOUT_MASK = 0xFFFF
HELLO_REPL_SHIFT = 48
HELLO_SHARD_MISMATCH = -5

# PS replication statuses (r12, native/ps_server.cc parity).  REPL_REFUSED:
# a partitioned server refusing its peer's repl-flagged connection (the
# injected-partition primitive).  REPL_DIVERGED: a replica refusing a
# state-MUTATING client op because it can no longer replicate it (its peer
# refuses the link) — the loud split-brain error; reads still serve.
REPL_REFUSED = -6
REPL_DIVERGED = -7

# Graceful load shedding (r18, native/ps_server.cc parity).  A server that
# ADMISSION-REFUSES a request — dispatch queue full, per-connection
# in-flight cap exceeded, or the request waited past its queue-deadline
# budget — answers a status in the RETRY_LATER band: ``RETRY_LATER_BASE -
# retry_after_ms``, so the shed carries its own backoff HINT with zero
# payload plumbing on any wire (the same pack-into-the-status trick as the
# HELLO shard-mismatch echo).  The band spans ``RETRY_LATER_SPAN`` ms of
# hint below the base; anything below that is NOT a shed (the shard-
# mismatch echoes live around -1M and must never decode as one).  Shed
# answers are RETRYABLE by contract — but only through the shared retry
# budget (``parallel/retry.py``): a client that re-hammers a shedding
# server at line rate is the retry storm admission control exists to
# prevent.  Control-plane ops (wire.CONTROL_OPS) are NEVER shed: under
# saturation the cluster stays observable and leases keep renewing, so
# overload cannot cascade into false member expiry.
RETRY_LATER_BASE = -1000
RETRY_LATER_SPAN = 600_000  # max encodable hint: 10 minutes

#: Request op-byte flag (bit 7; every real op code is < 0x80): the frame's
#: standard tail is followed by one ``<I`` field carrying the caller's
#: REMAINING per-op deadline in ms.  Servers use it to drop work the
#: caller has already abandoned (queue-deadline shed) and to clamp
#: blocking-op waits — a worker never burns on a request whose caller
#: gave up.  Optional per frame: un-stamped frames are byte-identical to
#: the v3 layout.
DEADLINE_FLAG = 0x80
DEADLINE_TAIL = struct.Struct("<I")


def retry_later_status(retry_after_ms: int) -> int:
    """The shed status for a given backoff hint (clamped to the band)."""
    return RETRY_LATER_BASE - max(0, min(int(retry_after_ms), RETRY_LATER_SPAN))


def retry_after_ms(status: int) -> int | None:
    """The backoff hint a RETRY_LATER status carries, or None when
    ``status`` is not a shed (the band check keeps the far-more-negative
    shard-mismatch echoes from ever decoding as one)."""
    if RETRY_LATER_BASE - RETRY_LATER_SPAN <= status <= RETRY_LATER_BASE:
        return RETRY_LATER_BASE - status
    return None

# Service identity (r10): every wire service has an id + a 4-byte tag.  A
# client announces the service it EXPECTS in HELLO's b operand (bits
# 56..62 — above the shard-identity bits, below the sign bit; the native
# PS server masks them out, so announcing is backward-compatible with it);
# the Python services refuse a mismatched announcement with status
# ``WRONG_SERVICE_BASE - own_id`` so the dial fails loudly naming what was
# actually reached.  Successful Python-service HELLOs answer their 4-byte
# tag as payload; the native PS answers tag-less (also distinctive).
SERVICE_IDS = {"ps": 1, "dsvc": 2, "msrv": 3}
SERVICE_TAGS = {"ps": b"psrv", "dsvc": b"dsvc", "msrv": b"msrv"}
SERVICE_NAMES = {
    "ps": "the native PS state service",
    "dsvc": "a data service",
    "msrv": "a model-serving replica",
}
HELLO_SERVICE_SHIFT = 56
HELLO_SERVICE_MASK = 0x7F
WRONG_SERVICE_BASE = -100


def pack_hello_b(
    dtype_code: int, shard_id: int = 0, shard_count: int = 0,
    service: str = "", layout_version: int = 0, repl: bool = False,
) -> int:
    """HELLO's b operand: dtype + (optional) expected shard identity +
    (optional) expected layout version + (optional) replication-peer flag
    + (optional) expected SERVICE identity.  Out-of-range fields are
    REJECTED, never masked: a truncated shard_count/layout_version would
    pack as "no expectation" and silently disable the very guard the
    word exists to enforce."""
    if not 0 <= shard_id <= HELLO_SHARD_MASK or \
            not 0 <= shard_count <= HELLO_SHARD_MASK:
        raise ValueError(
            f"shard identity ({shard_id}/{shard_count}) exceeds the "
            f"{HELLO_SHARD_MASK + 1}-shard HELLO field"
        )
    if not 0 <= layout_version <= HELLO_LAYOUT_MASK:
        raise ValueError(
            f"layout_version {layout_version} exceeds the "
            f"{HELLO_LAYOUT_MASK + 1}-epoch HELLO field"
        )
    return (
        dtype_code
        | (shard_id << HELLO_SHARD_ID_SHIFT)
        | (shard_count << HELLO_SHARD_COUNT_SHIFT)
        | (layout_version << HELLO_LAYOUT_SHIFT)
        | ((1 if repl else 0) << HELLO_REPL_SHIFT)
        | ((SERVICE_IDS[service] if service else 0) << HELLO_SERVICE_SHIFT)
    )


def hello_expected_service(b: int) -> str:
    """The service a HELLO's sender announced it expects ('' = none)."""
    sid = (b >> HELLO_SERVICE_SHIFT) & HELLO_SERVICE_MASK
    for name, i in SERVICE_IDS.items():
        if i == sid:
            return name
    return ""


def wrong_service_status(service: str) -> int:
    return WRONG_SERVICE_BASE - SERVICE_IDS[service]


def unpack_wrong_service(status: int) -> str | None:
    """The service a ``WRONG_SERVICE_BASE``-range HELLO answer names, or
    None when ``status`` is not a wrong-service refusal."""
    sid = WRONG_SERVICE_BASE - status
    for name, i in SERVICE_IDS.items():
        if i == sid:
            return name
    return None


def hello_answer(
    a: int, b: int, *, service: str, accept_dtypes=(0,),
) -> tuple[int, bytes | None]:
    """The shared server-side HELLO answer for the Python services: returns
    ``(status, tag_payload)``.  A client announcing a DIFFERENT service is
    refused with a status naming this one (the wrong-service loud failure);
    a version/dtype mismatch answers -1; success echoes the wire version
    plus this service's 4-byte tag."""
    expected = hello_expected_service(b)
    if expected and expected != service:
        return wrong_service_status(service), None
    if a != WIRE_VERSION or (b & 0xFF) not in accept_dtypes:
        return -1, None
    return WIRE_VERSION, SERVICE_TAGS[service]


def hello_failure(
    status: int, tag: bytes | None, *, service: str, host: str, port: int,
) -> str | None:
    """The shared client-side HELLO verdict: None when ``(status, tag)`` is
    a valid success for ``service``, else a diagnostic naming both ends —
    what this client speaks AND what the peer turned out to be."""
    want = SERVICE_NAMES[service]
    # The success payload is the 4-byte service tag, optionally followed
    # by the msrv HELLO version word (r19) — split before comparing.
    tag4, _version = unpack_hello_tag(tag)
    if status == WIRE_VERSION and tag4 == SERVICE_TAGS[service]:
        return None
    got = unpack_wrong_service(status)
    if got is not None:
        return (
            f"wrong-service dial: {host}:{port} is {SERVICE_NAMES[got]} "
            f"({got!r}), not {want} ({service!r}) — check the host lists "
            "against the running tasks"
        )
    if status == WIRE_VERSION and not tag:
        return (
            f"wrong-service dial: {host}:{port} answered HELLO "
            f"v{WIRE_VERSION} without a service tag — that port hosts the "
            f"native PS state service, not {want} ({service!r})"
        )
    return (
        f"HELLO with {host}:{port} failed: asked v{WIRE_VERSION}/{service}, "
        f"peer answered {status} {tag!r} — not {want}, or an incompatible "
        "version"
    )


def unpack_shard_mismatch(status: int) -> tuple[int, int, int]:
    """Decode a ``-5 - packed`` HELLO answer into the SERVER's
    (shard_id, shard_count, layout_version)."""
    packed = -(status - HELLO_SHARD_MISMATCH)
    return (
        (packed >> HELLO_SHARD_ID_SHIFT) & HELLO_SHARD_MASK,
        (packed >> HELLO_SHARD_COUNT_SHIFT) & HELLO_SHARD_MASK,
        (packed >> HELLO_LAYOUT_SHIFT) & HELLO_LAYOUT_MASK,
    )

#: Request tail after the name bytes: a, b, payload_len.
REQ_TAIL = struct.Struct("<qqI")

#: Response header: status, payload_len.
RESP_HDR = struct.Struct("<qI")


def pack_request(
    op: int, name: str, a: int, b: int, payload_len: int,
    deadline_ms: int = 0,
) -> bytes:
    """The request frame header (everything but the payload).
    ``deadline_ms`` > 0 stamps the caller's remaining per-op deadline
    (r18): the op byte carries :data:`DEADLINE_FLAG` and one ``<I`` field
    follows the standard tail — both ends must speak wire v4."""
    nm = name.encode()
    if deadline_ms > 0:
        return (
            struct.pack("<BB", op | DEADLINE_FLAG, len(nm)) + nm
            + REQ_TAIL.pack(a, b, payload_len)
            + DEADLINE_TAIL.pack(min(int(deadline_ms), RETRY_LATER_SPAN))
        )
    return struct.pack("<BB", op, len(nm)) + nm + REQ_TAIL.pack(a, b, payload_len)


def f32_to_bf16(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (as uint16 bit patterns), round-to-nearest-even, NaN
    kept quiet — bit-exact with the server's ``f32_to_bf16``.  In-place
    arithmetic plus a cheap ``any()``-guarded NaN fixup: measured ~2x
    faster than a branchless ``np.where`` select, whose extra full-size
    temporaries cost more than the rare-NaN reduction saves."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    out32 = bits + np.uint32(0x7FFF)
    out32 += (bits >> np.uint32(16)) & np.uint32(1)
    out32 >>= np.uint32(16)
    out = out32.astype(np.uint16)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        out[nan] = ((bits[nan] >> np.uint32(16)) | np.uint32(0x0040)).astype(
            np.uint16
        )
    return out


def bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _byte_view(a: np.ndarray) -> np.ndarray:
    """Zero-copy uint8 view of a contiguous array.  ``memoryview(...).cast``
    would do for standard dtypes, but PEP 3118 has no format code for
    extension dtypes (ml_dtypes bfloat16 & co. raise ``cannot include
    dtype 'E' in a buffer``) — a uint8 ``view`` moves any itemsize.
    ``reshape(-1)`` keeps 0-d scalar arrays — unsized for ``len()`` —
    valid."""
    return a.reshape(-1).view(np.uint8)


def frames_to_views(bufs) -> list:
    """Normalize a mixed bytes/ndarray buffer list into non-empty byte
    memoryviews — the ONE definition of the wire's outgoing buffer shape
    (extension dtypes included, via :func:`_byte_view`), shared by
    :func:`send_frames` and the server core's buffered reply path."""
    out = []
    for b in bufs:
        if isinstance(b, np.ndarray):
            if b.nbytes:
                out.append(memoryview(_byte_view(b)))
        elif len(b):
            out.append(memoryview(b))
    return out


def send_frames(sock, bufs) -> None:
    """Scatter/gather send of a buffer list via ``sendmsg`` — no buffer is
    ever copied into a concatenated message.  Accepts ``bytes``,
    ``memoryview`` and contiguous ndarrays (cast to byte views here)."""
    out = frames_to_views(bufs)
    while out:
        sent = sock.sendmsg(out)
        while out and sent >= len(out[0]):
            sent -= len(out[0])
            out.pop(0)
        if out and sent:
            out[0] = out[0][sent:]


def send_frame(sock, header: bytes, payload: np.ndarray | None) -> None:
    """Header + optional array payload (the PS client's request shape)."""
    if payload is None or payload.size == 0:
        sock.sendall(header)
        return
    send_frames(sock, [header, payload])


def recv_exact(sock, view: memoryview) -> None:
    """Fill ``view`` from the socket via ``recv_into`` — responses land
    directly in their final buffer.  Raises ConnectionError on EOF."""
    pos, n = 0, len(view)
    while pos < n:
        r = sock.recv_into(view[pos:])
        if r == 0:
            raise ConnectionError("peer closed the connection")
        pos += r


def read_request(sock, hdr2: bytearray | None = None):
    """Server-side request parse: returns ``(op, name, a, b, payload_len)``
    with the payload left unread on the socket (the handler decides the
    receive buffer), or None on a clean EOF before a new frame.  A
    deadline-stamped frame (r18) has its stamp consumed and discarded —
    this blocking helper serves tests and tooling; the server core's
    incremental parser is where the stamp is acted on."""
    head = memoryview(hdr2 if hdr2 is not None else bytearray(2))
    try:
        recv_exact(sock, head)
    except ConnectionError:
        return None
    op, nlen = head[0], head[1]
    name = b""
    if nlen:
        nb = bytearray(nlen)
        recv_exact(sock, memoryview(nb))
        name = bytes(nb)
    tail = bytearray(REQ_TAIL.size)
    recv_exact(sock, memoryview(tail))
    a, b, plen = REQ_TAIL.unpack(tail)
    if op & DEADLINE_FLAG:
        stamp = bytearray(DEADLINE_TAIL.size)
        recv_exact(sock, memoryview(stamp))
        op &= ~DEADLINE_FLAG & 0xFF
    return op, name.decode(), a, b, plen


# ----------------------------------------------------------------------------
# Batch codec: JSON schema header + raw field bytes (zero-copy both ways).
# Shared by the data service (training batches) and the serving wire
# (predict inputs/outputs) — one definition, so the two byte-counting wires
# cannot drift.
# ----------------------------------------------------------------------------


def encode_batch(batch: dict) -> list:
    """Wire form of a field-dict batch: ``<I`` schema length + JSON schema +
    each field's raw bytes, returned as a BUFFER LIST for scatter/gather
    ``sendmsg`` — field arrays are never copied into a concatenated
    message.  Field order is sorted for determinism."""
    fields, bufs = [], []
    for k in sorted(batch):
        src = batch[k]
        if isinstance(src, torch.Tensor) and src.dtype == torch.bfloat16:
            # numpy has no bfloat16 of its own: the field travels as its
            # raw 2-byte payload under the "bfloat16" spelling, the same
            # bytes an ml_dtypes array puts on the wire.
            spec = BF16
            a = src.detach().cpu().contiguous().view(torch.int16).numpy()
            fields.append({"name": k, "dtype": spec, "shape": list(src.shape)})
            bufs.append(a.reshape(-1))
            continue
        src = np.asarray(src)
        a = np.ascontiguousarray(src)
        # Record the SOURCE shape: ascontiguousarray promotes 0-d scalars
        # to 1-d, and the decode side must reconstruct the original.
        # Extension dtypes (ml_dtypes bfloat16 & co.) stringify to a void
        # '<V2' that would DECODE as raw void — their registered NAME is
        # the round-trippable spelling; .str keeps byte order for the rest.
        spec = a.dtype.name if a.dtype.kind == "V" else a.dtype.str
        fields.append({"name": k, "dtype": spec, "shape": list(src.shape)})
        bufs.append(a)
    meta = json.dumps(fields).encode()
    return [struct.pack("<I", len(meta)) + meta] + bufs


def encoded_nbytes(bufs: list) -> int:
    return sum(
        b.nbytes if isinstance(b, np.ndarray) else len(b) for b in bufs
    )


#: Schema spelling of a bfloat16 field (ml_dtypes' registered name).
BF16 = "bfloat16"


def _decode_dtype(spec: str) -> np.dtype:
    """Decode a schema dtype spelling.  A bfloat16 field is received as
    its raw int16 payload and handed out by :func:`_as_field`."""
    return np.dtype(np.int16) if spec == BF16 else np.dtype(spec)


def _as_field(spec: str, a: np.ndarray):
    """A decoded field as callers see it: numpy, except bfloat16, which
    becomes a CPU ``torch.bfloat16`` tensor over the same bytes (copied
    first when ``a`` is a read-only view into a receive buffer)."""
    if spec != BF16:
        return a
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).view(torch.bfloat16)


def decode_batch_bytes(buf) -> dict:
    """Inverse of :func:`encode_batch` over an in-memory buffer — the
    server-core shape (r17): the readiness-driven runtime receives whole
    request payloads off the selector, so handlers decode from bytes
    instead of a socket.  Fields are zero-copy views into ``buf``
    (read-only; callers that mutate copy their slice)."""
    mv = memoryview(buf)
    if len(mv) < 4:
        raise ValueError("batch payload shorter than its schema header")
    (mlen,) = struct.unpack("<I", mv[:4])
    if 4 + mlen > len(mv):
        raise ValueError("batch schema exceeds the framed payload")
    consumed = 4 + mlen
    out: dict = {}
    for f in json.loads(bytes(mv[4:consumed])):
        dt = _decode_dtype(f["dtype"])
        count = int(np.prod(f["shape"], dtype=np.int64))
        nbytes = count * dt.itemsize
        if consumed + nbytes > len(mv):
            raise ValueError("batch field exceeds the framed payload")
        out[f["name"]] = _as_field(f["dtype"], np.frombuffer(
            mv, dtype=dt, count=count, offset=consumed
        ).reshape(f["shape"]))
        consumed += nbytes
    if consumed != len(mv):
        raise ValueError(
            f"batch framing mismatch: {consumed} consumed != {len(mv)} framed"
        )
    return out


def read_batch(sock, nbytes: int) -> dict:
    """Inverse of :func:`encode_batch`, receiving each field via
    ``recv_into`` straight into its final freshly-allocated array — no
    staging buffer, no per-field copy."""
    head = bytearray(4)
    recv_exact(sock, memoryview(head))
    (mlen,) = struct.unpack("<I", head)
    meta = bytearray(mlen)
    recv_exact(sock, memoryview(meta))
    consumed = 4 + mlen
    out: dict = {}
    for f in json.loads(bytes(meta)):
        a = np.empty(f["shape"], _decode_dtype(f["dtype"]))
        if a.nbytes:
            recv_exact(sock, memoryview(_byte_view(a)))
        out[f["name"]] = _as_field(f["dtype"], a)
        consumed += a.nbytes
    if consumed != nbytes:
        raise ConnectionError(
            f"batch framing mismatch: {consumed} consumed != {nbytes} framed"
        )
    return out
