"""dtxtop of the port: the root ``tools/dtxtop.py``'s live cluster scraper
over the port's planes::

    python -m distributed_tensorflow_examples_tpu_torch.tools.dtxtop --json \\
        --ps_hosts=h:7000,h:7001 --ps_shards=2 [--ps_replicas=1] \\
        [--data_service_hosts=h:7100] [--serve_hosts=h:7200,h:7201]

Dials every task of a running train-and-serve cluster over its wire's
``STATS`` op (PS shard servers, every replica; data services; serve
replicas) and renders one table, or with ``--json`` prints one snapshot.
The coordinator shard's lease registry is scraped too: leased serve
replicas are found there and scraped as roles, leased workers get rows of
their own.  A host list that a live reshard retired is followed to the
committed layout first.  The summary rolls the rows up by plane, by served
registry version and by tenant.  The wires are the root's, so either
package's dtxtop reads either package's cluster, with the same rows.

``--json`` exits 0 when every dialled role answered, 1 otherwise; a
mis-wired host list fails loudly (the role's row carries the wire's
wrong-service diagnostic).  It imports no torch: it runs beside a cluster
without paying a task's start-up.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time

from ..parallel import ps_service
from ..utils import flags as dtx_flags

#: Snapshot schema version (tests pin it).
SNAPSHOT_SCHEMA_VERSION = 1


def _scrape_ps(
    host: str, port: int, timeout_s: float,
    expect_shard: tuple[int, int] | None = None,
) -> dict:
    # The shard expectation forces the HELLO handshake, so a mis-wired
    # entry in --ps_hosts fails THIS scrape with the wire's full
    # diagnostic (wrong service / wrong shard, naming both ends) instead
    # of an opaque bad-status error.
    c = ps_service.PSClient(
        host, port, timeout_s=timeout_s, expect_shard=expect_shard,
    )
    try:
        return c.stats()
    finally:
        c.close()


def _scrape_dsvc(host: str, port: int, timeout_s: float) -> dict:
    from ..data import data_service

    # worker_id=-1 is a metadata-only probe: the scraper must never count
    # as a training worker in the dispatcher's liveness tables.
    c = data_service.DataServiceClient(
        host, port, worker_id=-1, op_timeout_s=timeout_s,
        reconnect_deadline_s=0.0, role="dtxtop",
    )
    try:
        return c.stats()
    finally:
        c.close()


def _scrape_serve(host: str, port: int, timeout_s: float) -> dict:
    from ..serve import ServeClient

    c = ServeClient(
        host, port, op_timeout_s=timeout_s, reconnect_deadline_s=0.0,
        role="dtxtop",
    )
    try:
        return c.stats()
    finally:
        c.close()


def resolve_shards(ps_addrs, ps_shards: int, ps_replicas: int) -> int:
    """The shard count a cluster's flags imply: explicit ``--ps_shards``
    wins; otherwise one shard per host DIVIDED by the replica tier (the
    ``--ps_shards=-1`` convention of ``flags.ps_shard_topology``) — a
    4-host ``--ps_replicas=2`` cluster is 2 shards, and deriving 4 here
    would pin every scrape's HELLO to a wrong identity and render a
    healthy cluster DOWN."""
    if ps_shards > 0:
        return ps_shards
    return max(1, len(ps_addrs) // max(1, ps_replicas))


def cluster_roles(
    ps_addrs=(), *, ps_shards: int = 0, ps_replicas: int = 1,
    dsvc_addrs=(), serve_addrs=(),
) -> list[dict]:
    """The task list a cluster's flags imply, one entry per dialable role.
    PS task i serves shard ``i % shards`` replica ``i // shards`` (the
    replica-major ``--ps_hosts`` convention — ``ps_shard.replica_major``
    is the one definition; this is only the naming of the flat order)."""
    roles = []
    n_shards = resolve_shards(ps_addrs, ps_shards, ps_replicas)
    for i, (h, p) in enumerate(ps_addrs):
        roles.append({
            "role": f"ps{i}", "kind": "ps", "addr": f"{h}:{p}",
            "shard": i % n_shards, "replica": i // n_shards,
        })
    for i, (h, p) in enumerate(dsvc_addrs):
        roles.append({
            "role": f"data_service{i}", "kind": "dsvc", "addr": f"{h}:{p}",
        })
    for i, (h, p) in enumerate(serve_addrs):
        roles.append({
            "role": f"serve{i}", "kind": "serve", "addr": f"{h}:{p}",
        })
    return roles


_SCRAPERS = {"ps": _scrape_ps, "dsvc": _scrape_dsvc, "serve": _scrape_serve}


def _serve_by_version(serve_rows: list[dict]) -> dict[int, list[dict]]:
    """Scraped serve roles grouped by served registry version."""
    out: dict[int, list[dict]] = {}
    for r in serve_rows:
        out.setdefault(int(r["stats"].get("model_version", 0)), []).append(r)
    return dict(sorted(out.items()))


def scrape_leases(
    ps_addrs, timeout_s: float, *, ps_shards: int = 0, ps_replicas: int = 1,
) -> list[dict]:
    """The coordinator shard's membership lease registry: the LIVE
    elastic member set (workers, serve replicas) straight off the wire.
    ONLY the coordinator shard's replicas host leases — and after a
    failover different members may be heartbeating into DIFFERENT
    replicas of the pair (each client alternates independently, and the
    registry is deliberately not replicated) — so every coordinator
    replica is scraped and the answers UNION by member id.  An empty
    cluster — or a PS without leases — contributes nothing, never an error
    (elastic discovery degrades to the static flag lists)."""
    from ..parallel import membership

    n_shards = resolve_shards(ps_addrs, ps_shards, ps_replicas)
    merged: dict[str, dict] = {}
    for host, port in membership.coordinator_addrs(
        ps_addrs, n_shards, ps_replicas
    ):
        try:
            c = ps_service.PSClient(host, port, timeout_s=timeout_s)
            try:
                for m in membership.live_members(c):
                    prev = merged.get(m["member"])
                    if prev is None or m["renewals"] > prev["renewals"]:
                        merged[m["member"]] = m
            finally:
                c.close()
        except Exception:  # noqa: BLE001 — try the next replica
            continue
    return list(merged.values())


def follow_reshard(
    ps_addrs, ps_shards: int, ps_replicas: int, timeout_s: float,
) -> tuple[list, int, int, dict]:
    """Chase committed reshard records: the given ``--ps_hosts`` may
    name a topology that live-resharded away since the operator copied
    it.  Each hop reads the current coordinator's committed record and
    re-targets; the PENDING record (a transition in flight) is surfaced
    too, so a mid-transition cluster reads at a glance.  Returns the
    resolved ``(ps_addrs, ps_shards, ps_replicas, reshard_info)``."""
    from ..parallel import membership, reshard

    info: dict = {"followed_from": None, "committed": 0, "pending": 0,
                  "pending_shards": 0}
    seen: set = set()
    for _ in range(4):  # bounded: a record cycle must not loop forever
        n_shards = resolve_shards(ps_addrs, ps_shards, ps_replicas)
        rec = pending = None
        for host, port in membership.coordinator_addrs(
            ps_addrs, n_shards, ps_replicas
        ):
            try:
                c = ps_service.PSClient(host, port, timeout_s=timeout_s)
                try:
                    rec = reshard.poll_committed(c, 0)
                    pending = reshard.poll_pending(c)
                finally:
                    c.close()
                break
            except Exception:  # noqa: BLE001 — try the next replica
                continue
        if pending is not None:
            info["pending"] = pending["version"]
            info["pending_shards"] = pending["shards"]
        if rec is None or tuple(rec["addrs"]) in seen:
            break
        seen.add(tuple(rec["addrs"]))
        info["committed"] = rec["version"]
        if rec["addrs"] != list(ps_addrs):
            if info["followed_from"] is None:
                info["followed_from"] = [f"{h}:{p}" for h, p in ps_addrs]
            ps_addrs = rec["addrs"]
            ps_shards, ps_replicas = rec["shards"], rec["replicas"]
            continue
        break
    return list(ps_addrs), ps_shards, ps_replicas, info


def snapshot(
    ps_addrs=(), *, ps_shards: int = 0, ps_replicas: int = 1,
    dsvc_addrs=(), serve_addrs=(), timeout_s: float = 5.0,
) -> dict:
    """One scrape of the whole cluster: every role's STATS table plus an
    aggregated summary.  A role that cannot be scraped (down, or a
    mis-wired address answering as the wrong service) is reported with
    ``ok: False`` and the diagnostic — missing observability is itself a
    loud finding, never a silent hole in the table.

    Elastic membership: the coordinator shard's lease registry is
    scraped too, and every LEASED serve replica whose address is not in
    the static ``serve_addrs`` is discovered and scraped as a live role —
    a dynamically-joined pool is never rendered as missing.  Leased
    workers (no dialable address) are reported in the ``members`` list.

    Live resharding: the committed layout epoch is FOLLOWED first —
    a host list naming a resharded-away topology resolves to the current
    one through the coordinator's records, and any pending (in-flight)
    transition is reported in ``summary.ps.reshard``."""
    from ..parallel import membership

    reshard_info = {"followed_from": None, "committed": 0, "pending": 0,
                    "pending_shards": 0}
    if ps_addrs:
        ps_addrs, ps_shards, ps_replicas, reshard_info = follow_reshard(
            list(ps_addrs), ps_shards, ps_replicas, timeout_s
        )
    members = (
        scrape_leases(
            ps_addrs, timeout_s, ps_shards=ps_shards,
            ps_replicas=ps_replicas,
        )
        if ps_addrs
        else []
    )
    static = {f"{h}:{p}" for h, p in serve_addrs}
    serve_addrs = list(serve_addrs)
    for m in members:
        if m["kind"] != "serve" or m["addr"] in static:
            continue
        addr = membership.unpack_addr(m["addr"])
        if addr is not None:
            serve_addrs.append(addr)
    roles = cluster_roles(
        ps_addrs, ps_shards=ps_shards, ps_replicas=ps_replicas,
        dsvc_addrs=dsvc_addrs, serve_addrs=serve_addrs,
    )
    n_shards = resolve_shards(ps_addrs, ps_shards, ps_replicas)

    def scrape_one(r: dict) -> None:
        host, port_s = r["addr"].rsplit(":", 1)
        try:
            if r["kind"] == "ps":
                r["stats"] = _scrape_ps(
                    host, int(port_s), timeout_s,
                    expect_shard=(r["shard"], n_shards),
                )
            else:
                r["stats"] = _SCRAPERS[r["kind"]](host, int(port_s), timeout_s)
            r["ok"] = True
        except Exception as e:  # noqa: BLE001 — every failure is a row
            r["ok"] = False
            r["error"] = f"{type(e).__name__}: {e}"

    # Roles are independent — scrape them concurrently, so one blackholed
    # host costs ONE timeout per refresh, not timeout x down-roles (a
    # sequential dial would degrade the live table to a frame per
    # N_down * timeout_s during exactly the outages it exists to show).
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=min(8, max(1, len(roles)))
    ) as pool:
        list(pool.map(scrape_one, roles))
    ps_rows = [r for r in roles if r["kind"] == "ps" and r["ok"]]
    serve_rows = [r for r in roles if r["kind"] == "serve" and r["ok"]]
    dsvc_rows = [r for r in roles if r["kind"] == "dsvc" and r["ok"]]
    summary = {
        "roles_total": len(roles),
        "roles_ok": sum(1 for r in roles if r["ok"]),
        "ps": {
            "reshard": reshard_info,
            "epochs": sorted({
                int(r["stats"].get("layout_version", 0)) for r in ps_rows
            }),
            "draining": sorted(
                r["role"] for r in ps_rows if r["stats"].get("draining")
            ),
            "reshard_syncs": sum(
                r["stats"].get("reshard_syncs", 0) for r in ps_rows
            ),
            "requests": sum(r["stats"]["requests"] for r in ps_rows),
            "deduped": sum(
                r["stats"]["acc_deduped"] + r["stats"]["gq_deduped"]
                for r in ps_rows
            ),
            "mirror_applies": sum(
                r["stats"]["mirror_applies"] for r in ps_rows
            ),
            "repl_syncs_served": sum(
                r["stats"]["repl_syncs_served"] for r in ps_rows
            ),
            "diverged": sorted(
                r["role"] for r in ps_rows if r["stats"]["diverged"]
            ),
            "shed_total": sum(
                r["stats"].get("shed_total", 0) for r in ps_rows
            ),
            "queue_deadline_drops": sum(
                r["stats"].get("queue_deadline_drops", 0) for r in ps_rows
            ),
            "leases_expired": sum(
                r["stats"].get("leases_expired", 0) for r in ps_rows
            ),
        },
        "dsvc": {
            "batches_served": sum(
                r["stats"]["batches_served"] for r in dsvc_rows
            ),
            "reassigned": sum(r["stats"]["reassigned"] for r in dsvc_rows),
            "shed_total": sum(
                r["stats"].get("shed_total", 0) for r in dsvc_rows
            ),
            "queue_deadline_drops": sum(
                r["stats"].get("queue_deadline_drops", 0) for r in dsvc_rows
            ),
        },
        "serve": {
            "model_steps": [r["stats"]["model_step"] for r in serve_rows],
            "model_versions": [
                r["stats"].get("model_version", 0) for r in serve_rows
            ],
            # Per-version rollup: the canary-vs-stable read — one
            # row per served registry version (0 = hot-tracking) with
            # replica count, summed qps, worst p99 and shed totals, so a
            # rolling flip's traffic split is visible in one scrape.
            "by_version": {
                str(v): {
                    "replicas": len(rows_v),
                    "qps": round(sum(
                        r["stats"].get("serve/qps", 0.0) for r in rows_v
                    ), 2),
                    "p99_ms": round(max(
                        (r["stats"].get("serve/latency_p99_ms", 0.0)
                         for r in rows_v),
                        default=0.0,
                    ), 3),
                    "sheds": sum(
                        r["stats"].get("shed_total", 0)
                        + r["stats"].get("overloads", 0)
                        for r in rows_v
                    ),
                    "predict_rows": sum(
                        r["stats"].get("predict_rows", 0) for r in rows_v
                    ),
                }
                for v, rows_v in _serve_by_version(serve_rows).items()
            },
            "predict_rows": sum(
                r["stats"]["predict_rows"] for r in serve_rows
            ),
            "qps": round(sum(
                r["stats"].get("serve/qps", 0.0) for r in serve_rows
            ), 2),
            "p99_ms": round(max(
                (r["stats"].get("serve/latency_p99_ms", 0.0)
                 for r in serve_rows),
                default=0.0,
            ), 3),
            "overloads": sum(
                r["stats"].get("overloads", 0) for r in serve_rows
            ),
            "shed_total": sum(
                r["stats"].get("shed_total", 0) for r in serve_rows
            ),
            "queue_deadline_drops": sum(
                r["stats"].get("queue_deadline_drops", 0) for r in serve_rows
            ),
        },
        # Client-side retry discipline: every Python service's STATS
        # carries its process registry ride-along, so the shared retry
        # helper's counters (parallel/retry.py) aggregate here per scrape
        # — a cluster-wide view of budget exhaustion and open breakers.
        # (The native PS has no Python registry; .get degrades to 0.)
        "retry": {
            key: sum(
                r["stats"].get("registry", {}).get(f"retry/{key}", 0)
                for r in ps_rows + dsvc_rows + serve_rows
            )
            for key in ("spent", "budget_exhausted", "breaker_open",
                        "breaker_fast_fails")
        },
    }
    # Per-tenant rollup: one row per tenant namespace across every
    # plane — admission counters from the Python cores (dsvc/msrv),
    # object/lease footprint from the native PS, dispatcher progress from
    # the data service, leased members from the registry.  A pre-tenant
    # cluster rolls up as one "default" row.
    tenants: dict[str, dict] = {}

    def _trow(t: str) -> dict:
        return tenants.setdefault(t, {
            "requests": 0, "inflight": 0, "queued": 0,
            "shed_total": 0, "shed_quota": 0,
            "ps_objects": 0, "ps_leases": 0,
            "dsvc_batches": 0, "dsvc_epochs": 0,
            "members": 0,
        })

    for r in ps_rows:
        for t, d in r["stats"].get("tenants", {}).items():
            row = _trow(t)
            row["ps_objects"] += int(d.get("objects", 0))
            row["ps_leases"] += int(d.get("leases", 0))
    for r in dsvc_rows + serve_rows:
        for t, d in r["stats"].get("core", {}).get("tenants", {}).items():
            row = _trow(t)
            for k in ("requests", "inflight", "queued",
                      "shed_total", "shed_quota"):
                row[k] += int(d.get(k, 0))
    for r in dsvc_rows:
        for t, d in r["stats"].get("tenants", {}).items():
            row = _trow(t)
            row["dsvc_batches"] += int(d.get("batches_served", 0))
            row["dsvc_epochs"] += int(d.get("epochs_completed", 0))
    for m in members:
        _trow(m.get("tenant", "default"))["members"] += 1
    summary["tenants"] = tenants
    summary["members"] = {
        "total": len(members),
        "workers": sorted(
            m["member"] for m in members if m["kind"] == "worker"
        ),
        "serve": sorted(
            m["member"] for m in members if m["kind"] == "serve"
        ),
    }
    return {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "time": time.time(),
        "roles": roles,
        "members": members,
        "summary": summary,
    }


def _fmt_ps_row(r: dict) -> str:
    s = r["stats"]
    flags = "".join((
        "R" if s.get("replicated") else "-",
        "P" if s.get("partitioned") else "-",
        "D" if s.get("diverged") else "-",
        # X = draining: this shard's layout was retired by a reshard and
        # the task is waiting out its last connections before exit.
        "X" if s.get("draining") else "-",
    ))
    return (
        f"{s['requests']:>9} conns={s['live_conns']:<3} "
        f"shard={s['shard_id']}/{s['shard_count']}"
        f"@v{s.get('layout_version', 0)} {flags} "
        f"dedup={s['acc_deduped'] + s['gq_deduped']:<5} "
        f"mirror={s['mirror_applies']:<6} fwd={s['fwd_ok']}"
        f"/{s['fwd_peer_down']}/{s['fwd_refused']} "
        f"syncs={s['repl_syncs_served']}"
        f"+r{s.get('reshard_syncs', 0)} "
        f"shed={s.get('shed_total', 0)}"
        f"/{s.get('queue_deadline_drops', 0)}"
    )


def _fmt_dsvc_row(r: dict) -> str:
    s = r["stats"]
    return (
        f"{s['requests']:>9} epoch={s['epoch']:<3} "
        f"batches={s['batches_served']:<7} "
        f"splits={s['splits_completed']}/{s['assigned_total']}"
        f"/{s['reassigned']} (done/assigned/reassigned) "
        f"workers={s['registered_workers']} "
        f"shed={s.get('shed_total', 0)}"
        f"/{s.get('queue_deadline_drops', 0)}"
    )


def _fmt_serve_row(r: dict) -> str:
    s = r["stats"]
    return (
        f"{s['requests']:>9} step={s['model_step']:<6} "
        f"version={s.get('model_version', 0):<4} "
        f"rows={s['predict_rows']:<7} overload={s['overloads']:<4} "
        f"p99={s.get('serve/latency_p99_ms', 0.0):7.2f}ms "
        f"qps={s.get('serve/qps', 0.0):7.1f} "
        f"batch_p50={s.get('batcher_batch_rows_p50', 0)} "
        f"shed={s.get('shed_total', 0)}"
        f"/{s.get('queue_deadline_drops', 0)}"
    )


_ROW_FMT = {"ps": _fmt_ps_row, "dsvc": _fmt_dsvc_row, "serve": _fmt_serve_row}


def render(snap: dict, prev: dict | None = None) -> str:
    """The human table.  With a previous snapshot, a per-role qps column
    is derived from the request-counter delta over the refresh window."""
    dt = (snap["time"] - prev["time"]) if prev else 0.0
    prev_reqs = {
        r["role"]: r["stats"]["requests"]
        for r in (prev["roles"] if prev else [])
        if r.get("ok")
    }
    lines = [
        f"dtxtop — {time.strftime('%H:%M:%S', time.localtime(snap['time']))}"
        f"  roles {snap['summary']['roles_ok']}/{snap['summary']['roles_total']} ok"
    ]
    lines.append(f"{'ROLE':<15} {'ADDR':<22} {'REQS':>9} detail")
    for r in snap["roles"]:
        head = f"{r['role']:<15} {r['addr']:<22}"
        if not r["ok"]:
            lines.append(f"{head} {'DOWN':>9} {r['error']}")
            continue
        qps = ""
        if dt > 0 and r["role"] in prev_reqs:
            qps = f" qps={max(0.0, (r['stats']['requests'] - prev_reqs[r['role']]) / dt):.1f}"
        lines.append(f"{head} {_ROW_FMT[r['kind']](r)}{qps}")
    for m in snap.get("members", ()):
        # Leased members without a dialable service (workers) still get a
        # row: the lease IS their observable surface.
        if m["kind"] == "serve" and m.get("addr"):
            continue  # already rendered as a scraped serve role above
        lines.append(
            f"{m['member']:<15} {'(lease)':<22} {'':>9} "
            f"kind={m['kind']} ttl={m['ttl_ms']}ms renewals={m['renewals']}"
        )
    su = snap["summary"]
    mem = su.get("members", {})
    lines.append(
        f"members: {mem.get('total', 0)} leased "
        f"(workers={','.join(mem.get('workers', [])) or 'none'} "
        f"serve={','.join(mem.get('serve', [])) or 'none'})"
    )
    # Per-version serve rollup: rendered whenever any replica is
    # pinned (a hot-tracking-only pool stays one implicit v0 and needs no
    # extra line).
    bv = su["serve"].get("by_version", {})
    if len(bv) > 1 or any(v != "0" for v in bv):
        lines.append("serve versions: " + " | ".join(
            f"v{v}: {d['replicas']}x qps={d['qps']} p99={d['p99_ms']}ms "
            f"sheds={d['sheds']}"
            for v, d in bv.items()
        ))
    # Per-tenant breakdown: rendered whenever any non-default
    # tenant exists (a single-tenant cluster keeps its frame).
    tns = su.get("tenants", {})
    if any(t != "default" for t in tns):
        for t in sorted(tns):
            d = tns[t]
            lines.append(
                f"tenant {t:<12} reqs={d['requests']} "
                f"shed={d['shed_total']}(quota={d['shed_quota']}) "
                f"inflight={d['inflight']} queued={d['queued']} | "
                f"ps obj={d['ps_objects']} leases={d['ps_leases']} | "
                f"dsvc batches={d['dsvc_batches']} "
                f"epochs={d['dsvc_epochs']} | members={d['members']}"
            )
    rs = su["ps"].get("reshard", {})
    if rs.get("committed") or rs.get("pending"):
        lines.append(
            f"reshard: epoch v{rs.get('committed', 0)} committed"
            + (
                f", v{rs['pending']} PENDING -> "
                f"{rs.get('pending_shards', '?')} shard(s) "
                f"(syncs={su['ps'].get('reshard_syncs', 0)}, "
                f"draining={','.join(su['ps'].get('draining', [])) or 'none'})"
                if rs.get("pending")
                else f" (draining={','.join(su['ps'].get('draining', [])) or 'none'})"
            )
            + (
                f" [followed from {','.join(rs['followed_from'])}]"
                if rs.get("followed_from")
                else ""
            )
        )
    lines.append(
        f"totals: ps_reqs={su['ps']['requests']} dedup={su['ps']['deduped']} "
        f"syncs={su['ps']['repl_syncs_served']} "
        f"diverged={su['ps']['diverged'] or 'none'} | "
        f"dsvc_batches={su['dsvc']['batches_served']} "
        f"reassigned={su['dsvc']['reassigned']} | "
        f"serve_steps={su['serve']['model_steps']} "
        f"qps={su['serve']['qps']} p99={su['serve']['p99_ms']}ms"
    )
    # Overload posture: shed answers per plane (total/queue-deadline
    # drops) and the client-side retry discipline's cluster-wide counters.
    rt = su.get("retry", {})
    lines.append(
        "overload: shed ps="
        f"{su['ps'].get('shed_total', 0)}"
        f"/{su['ps'].get('queue_deadline_drops', 0)} "
        f"dsvc={su['dsvc'].get('shed_total', 0)}"
        f"/{su['dsvc'].get('queue_deadline_drops', 0)} "
        f"serve={su['serve'].get('shed_total', 0)}"
        f"/{su['serve'].get('queue_deadline_drops', 0)} "
        f"(+{su['serve'].get('overloads', 0)} batcher) | "
        f"retry: spent={rt.get('spent', 0)} "
        f"budget_exhausted={rt.get('budget_exhausted', 0)} "
        f"breaker_open={rt.get('breaker_open', 0)} | "
        f"leases_expired={su['ps'].get('leases_expired', 0)}"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ps_hosts", default="", help="replica-major PS host list")
    ap.add_argument("--ps_shards", type=int, default=-1)
    ap.add_argument("--ps_replicas", type=int, default=1)
    ap.add_argument("--data_service_hosts", default="")
    ap.add_argument("--serve_hosts", default="")
    ap.add_argument("--timeout_s", type=float, default=5.0)
    ap.add_argument(
        "--json", action="store_true",
        help="one-shot JSON snapshot on stdout (exit 1 on any missing role)",
    )
    ap.add_argument(
        "--interval_s", type=float, default=2.0, help="live refresh cadence"
    )
    ap.add_argument(
        "--count", type=int, default=0,
        help="live refreshes before exiting (0 = until interrupted)",
    )
    args = ap.parse_args(argv)

    def addrs(spec, flag):
        return dtx_flags.parse_hostports(spec, flag) if spec else []

    ps_addrs = addrs(args.ps_hosts, "--ps_hosts")
    dsvc_addrs = addrs(args.data_service_hosts, "--data_service_hosts")
    serve_addrs = addrs(args.serve_hosts, "--serve_hosts")
    if not (ps_addrs or dsvc_addrs or serve_addrs):
        ap.error("nothing to scrape: give --ps_hosts/--data_service_hosts/"
                 "--serve_hosts")
    kw = dict(
        ps_shards=args.ps_shards, ps_replicas=args.ps_replicas,
        dsvc_addrs=dsvc_addrs, serve_addrs=serve_addrs,
        timeout_s=args.timeout_s,
    )
    if args.json:
        snap = snapshot(ps_addrs, **kw)
        print(json.dumps(snap))
        return 0 if snap["summary"]["roles_ok"] == snap["summary"]["roles_total"] else 1
    prev = None
    n = 0
    try:
        while True:
            snap = snapshot(ps_addrs, **kw)
            out = render(snap, prev)
            # Clear-and-home only on a tty; piped output stays appendable.
            if sys.stdout.isatty():
                print("\x1b[2J\x1b[H" + out, flush=True)
            else:
                print(out + "\n", flush=True)
            prev = snap
            n += 1
            if args.count and n >= args.count:
                return 0
            time.sleep(args.interval_s)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
