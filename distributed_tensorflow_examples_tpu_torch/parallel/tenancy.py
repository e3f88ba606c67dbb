"""dtxtenant — the multi-tenant namespace substrate (r20).

Until now the cluster served exactly ONE run end-to-end: one PS object
space, one lease registry, one data-service job, one served model.  This
module is the namespace layer that lets N training runs and M served
models share one PS tier, one data service and one serve pool without
interfering — the tf.data-service sharing argument (disaggregated input
workers exist precisely to be shared across jobs) and the TensorFlow
paper's concurrent-sessions-on-one-runtime capability, rebuilt for the
flat-param substrate.

Tenancy is a KEY-PREFIX protocol, deliberately NOT a new wire op family:

- A tenant's PS objects live under ``t.<tenant>.<name>`` and its lease
  identities under ``t.<tenant>.<member>`` (:func:`qualify`).  The
  ``default`` tenant's keys carry NO prefix at all, so every untagged
  (pre-tenant) client interops byte-identically — v<=4 frames are the
  default tenant by construction, not by negotiation.
- :func:`split_qualified` is the inverse every consumer (lease watchers,
  STATS breakdowns, dtxtop) uses to attribute a key to its tenant.
- Data-service and serve requests tag the tenant into the existing
  ``name`` operand (:func:`tag_name` / :func:`untag_name`) — again
  absent for the default tenant, so the frames of an untagged client do
  not change by a single byte.
- :class:`TenantQuota` + :func:`parse_quotas` carry the per-tenant
  admission policy (``--tenant_quotas``) the server core's weighted-fair
  dispatcher enforces.

EVERY tenant-prefixed key in ``parallel/`` and ``serve/`` must be built
through :func:`qualify` — pinned by ``tools/dtxlint``'s ``tenant`` pass,
which refuses any other construction of the ``t.`` prefix.
"""

from __future__ import annotations

import dataclasses
import re

from . import wire

#: The tenant every untagged key/frame/member belongs to.  Its keys are
#: the BARE names — qualify() is the identity for it — which is the whole
#: back-compat story: a pre-tenant client IS a default-tenant client.
DEFAULT_TENANT = "default"

#: Legal tenant ids: short, no dots (dots delimit the qualified form), no
#: ``|`` (the pack_member field separator), no commas (the name-operand
#: tag separator) — safe inside PS object keys, lease member docs,
#: registry model names (``[A-Za-z0-9._-]``) and JSON alike.
_TENANT_RE = re.compile(r"^[A-Za-z0-9_-]{1,32}$")

_PREFIX = wire.TENANT_KEY_PREFIX

#: PS op numbers whose ``name`` is a tenant-scoped object key, derived
#: from the wire registry (never restated — dtxlint pins the derivation).
PS_SCOPED_OP_CODES = frozenset(
    wire.PS_OPS[name] for name in wire.TENANT_SCOPED_OPS["ps"]
)


def check_tenant(tenant: str) -> str:
    """Validate a tenant id (returns it).  Raises ValueError on anything
    that could not ride every key space unambiguously."""
    if not _TENANT_RE.match(tenant or ""):
        raise ValueError(
            f"tenant id {tenant!r} must match {_TENANT_RE.pattern} "
            "(no dots/pipes/commas — they delimit the key spaces)"
        )
    return tenant


def qualify(tenant: str, name: str) -> str:
    """The ONE tenant-key constructor: ``t.<tenant>.<name>`` for a
    non-default tenant, the bare name for the default tenant (identity —
    byte-identical back-compat) and for empty names (control ops carry no
    key to scope)."""
    if not name or tenant == DEFAULT_TENANT:
        return name
    return f"{_PREFIX}{check_tenant(tenant)}.{name}"


def split_qualified(name: str) -> tuple[str, str]:
    """Inverse of :func:`qualify`: ``(tenant, bare_name)``.  Unprefixed
    names (and malformed prefixes) belong to the default tenant."""
    if name.startswith(_PREFIX):
        rest = name[len(_PREFIX):]
        tenant, sep, bare = rest.partition(".")
        if sep and bare and _TENANT_RE.match(tenant):
            return tenant, bare
    return DEFAULT_TENANT, name


def tenant_of(name: str) -> str:
    """The tenant a (possibly qualified) key belongs to."""
    return split_qualified(name)[0]


def tenant_prefix(tenant: str) -> str:
    """The key prefix selecting everything a tenant owns — the CANCEL_ALL
    filter a non-default tenant sends so its reseed can never touch
    another tenant's objects ('' for the default tenant: its bare keys
    have no selectable prefix, so it cancels the whole space — the
    documented pre-tenant behavior)."""
    if tenant == DEFAULT_TENANT:
        return ""
    return f"{_PREFIX}{check_tenant(tenant)}."


# ----------------------------------------------------------------------------
# Name-operand tagging (dsvc / msrv): the tenant rides the existing
# ``name`` field as a ``,t=<tenant>`` suffix (bare ``t=<tenant>`` when the
# base name is empty) — absent for the default tenant, so untagged frames
# stay byte-identical.
# ----------------------------------------------------------------------------

_TAG_SEP = ",t="
_TAG_BARE = "t="


def tag_name(name: str, tenant: str) -> str:
    """Tag a request's ``name`` operand with the caller's tenant."""
    if tenant == DEFAULT_TENANT:
        return name
    check_tenant(tenant)
    if not name:
        return f"{_TAG_BARE}{tenant}"
    return f"{name}{_TAG_SEP}{tenant}"


def untag_name(name: str) -> tuple[str, str]:
    """Inverse of :func:`tag_name`: ``(bare_name, tenant)``."""
    if name.startswith(_TAG_BARE) and _TAG_SEP not in name:
        tenant = name[len(_TAG_BARE):]
        if _TENANT_RE.match(tenant):
            return "", tenant
        return name, DEFAULT_TENANT
    base, sep, tenant = name.rpartition(_TAG_SEP)
    if sep and _TENANT_RE.match(tenant):
        return base, tenant
    return name, DEFAULT_TENANT


# ----------------------------------------------------------------------------
# Per-tenant admission policy (the server core's weighted-fair dispatch).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission policy.

    ``weight`` steers the fair-dispatch share (stride scheduling: a
    tenant with weight 2 drains twice as fast as weight 1 under
    contention — idle tenants cost nothing).  ``max_inflight`` caps the
    tenant's dispatched-but-unanswered requests across ALL its
    connections; ``max_dispatch`` caps its queued (admitted, undispatched)
    requests.  0 = unlimited (the core's global bounds still apply).  A
    tenant at quota is SHED with a RETRY_LATER hint while other tenants'
    traffic flows — that is the isolation contract.
    """

    weight: float = 1.0
    max_inflight: int = 0
    max_dispatch: int = 0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.max_inflight < 0 or self.max_dispatch < 0:
            raise ValueError("tenant quotas must be >= 0 (0 = unlimited)")


def parse_quotas(spec: str) -> dict[str, TenantQuota]:
    """Parse a ``--tenant_quotas`` spec: comma-separated
    ``tenant=weight[:max_inflight[:max_dispatch]]`` entries, e.g.
    ``a=1:32:128,b=4`` — tenant ``a`` at weight 1 with 32 in-flight / 128
    queued caps, tenant ``b`` at weight 4, uncapped."""
    out: dict[str, TenantQuota] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        tenant, sep, rhs = entry.partition("=")
        if not sep:
            raise ValueError(
                f"bad --tenant_quotas entry {entry!r}: want "
                "tenant=weight[:max_inflight[:max_dispatch]]"
            )
        check_tenant(tenant.strip())
        parts = rhs.split(":")
        if len(parts) > 3:
            raise ValueError(
                f"bad --tenant_quotas entry {entry!r}: at most "
                "weight:max_inflight:max_dispatch"
            )
        try:
            weight = float(parts[0]) if parts[0] else 1.0
            max_inflight = int(parts[1]) if len(parts) > 1 and parts[1] else 0
            max_dispatch = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        except ValueError as e:
            raise ValueError(
                f"bad --tenant_quotas entry {entry!r}: {e}"
            ) from None
        out[tenant.strip()] = TenantQuota(weight, max_inflight, max_dispatch)
    return out
