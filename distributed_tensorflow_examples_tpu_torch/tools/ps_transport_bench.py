"""Host-side PS transport microbenchmark of the port, the twin of the root
``tools/ps_transport_bench.py``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.ps_transport_bench            # 64 MB large payload
    python -m distributed_tensorflow_examples_tpu_torch.tools.ps_transport_bench --quick    # CI-sized (8 MB)
    python -m distributed_tensorflow_examples_tpu_torch.tools.ps_transport_bench --json out.json

Starts the port's native PS server (``native/ps_server.cc``) in-process
and drives it through the port's client (``parallel/ps_service.py``):
set/get/push round trips and MB/s at small and large payloads, on the
f32 and bf16 wire; cold full pulls against unchanged-step
``get_if_newer`` pulls; N threads pulling at once; the same bytes over
1/2/4 shard servers (``parallel/ps_shard.py``); and an unreplicated
server against a forwarding primary/backup pair.  Throughputs are also
given normalised by the host's memcpy (``*_frac_memcpy``,
``tools/_hostbench.py``).

The structural rule, from the result alone (the root's,
``tools/perf_gate.py``): a full pull's time is at least ``IF_NEWER_RATIO``
times an unchanged-step ``get_if_newer`` round trip, per wire dtype (an
if-newer pull moves O(header), not O(params)).  ``checks``: each wire's
pull returns the published vector.  The record's ``gates`` and
``checks`` hold the verdicts; only a false check exits non-zero.  Host
only, as the root tool is.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

from ..parallel import ps_service, ps_shard
from . import _hostbench

#: Full pull time over an unchanged-step if-newer round trip, at least.
IF_NEWER_RATIO = 10.0


def _time(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return time.perf_counter() - t0


def _payload(elems: int) -> np.ndarray:
    # Integers in [-125, 125]: exact on the bf16 wire too.
    return (np.arange(elems, dtype=np.float32) % 251) - 125.0


def bench_dtype(host: str, port: int, dtype: str, *, large_elems: int, small_elems: int,
                reps_large: int, reps_small: int) -> tuple[dict, bool]:
    """The rows of one wire dtype, and whether a pull returned what was
    published."""
    c = ps_service.PSClient(host, port, timeout_s=60.0, wire_dtype=dtype)
    large_mb = large_elems * 4 / 1e6  # the f32-equivalent payload
    flat = _payload(large_elems)
    small = np.arange(small_elems, dtype=np.float32)
    row: dict = {}

    # The parameter store: publish (set) and cold full pulls (get).
    ps = ps_service.RemoteParamStore(c, f"p_{dtype}", large_elems, cache_pulls=False)
    ps.set(0, flat)
    ps.get()
    row["set_mbs_large"] = reps_large * large_mb / _time(lambda: ps.set(1, flat), reps_large)
    row["get_mbs_large"] = reps_large * large_mb / _time(ps.get, reps_large)

    def set_get():  # one publish and one pull: the headline
        ps.set(2, flat)
        ps.get()

    row["set_get_mbs_large"] = reps_large * 2 * large_mb / _time(set_get, reps_large)
    step, got = ps.get()
    pulled_ok = step == 2 and np.array_equal(np.asarray(got, np.float32), flat)

    # The gradient path: a push and a pop.
    gq = ps_service.RemoteGradientQueue(c, f"g_{dtype}", large_elems, capacity=4)

    def push_pop():
        gq.push(0, flat)
        gq.pop()

    push_pop()
    row["push_pop_mbs_large"] = reps_large * 2 * large_mb / _time(push_pop, reps_large)

    # Small-payload round trips.
    pss = ps_service.RemoteParamStore(c, f"ps_{dtype}", small_elems, cache_pulls=False)
    pss.set(0, small)
    pss.get()
    row["set_rtt_us_small"] = _time(lambda: pss.set(1, small), reps_small) / reps_small * 1e6
    row["get_rtt_us_small"] = _time(pss.get, reps_small) / reps_small * 1e6

    # A versioned pull of an unchanged step moves O(header), not O(params).
    psc = ps_service.RemoteParamStore(c, f"p_{dtype}", large_elems)
    psc.get()  # fills the cache
    row["if_newer_rtt_us"] = _time(psc.get, reps_small) / reps_small * 1e6
    row["if_newer_wire_bytes"] = 12 + 2 + len(f"p_{dtype}") + 20  # response + request headers
    c.close()
    return row, pulled_ok


def bench_shards(host: str, *, counts: list[int], elems: int, reps: int, trials: int = 3) -> dict:
    """The same bytes pulled and published through 1/2/4 local shard
    servers by the sharded client, fresh servers a count, each row the
    best of ``trials`` passes; ``sharded_pull_speedup`` is the cold pull's
    MB/s over the 1-shard row's (absent without a 1-shard row)."""
    rows: dict = {}
    mb = elems * 4 / 1e6
    for n in counts:
        ports = [ps_service.start_server(0, shard_id=i, shard_count=n) for i in range(n)]
        try:
            group = ps_shard.ShardedPSClients([(host, p) for p in ports], role="bench0",
                                              timeout_s=120.0)
            st = ps_shard.ShardedParamStore(group, "p_sh", ps_shard.ShardLayout(elems, n),
                                            cache_pulls=False)
            flat = _payload(elems)
            st.set(0, flat)
            st.get()
            row: dict = {"shards": n, "set_mbs": 0.0, "get_mbs": 0.0}
            for _ in range(max(1, trials)):
                row["set_mbs"] = max(row["set_mbs"], reps * mb / _time(lambda: st.set(1, flat), reps))
                row["get_mbs"] = max(row["get_mbs"], reps * mb / _time(st.get, reps))
            rows[str(n)] = row
            group.close()
        finally:
            for p in ports:
                ps_service.stop_server(p)
    base_get = rows.get("1", {}).get("get_mbs")
    if base_get:
        for row in rows.values():
            row["sharded_pull_speedup"] = row["get_mbs"] / base_get
    return rows


def bench_replication(host: str, *, counts: list[int], elems: int, reps: int,
                      trials: int = 3) -> dict:
    """The same publish and push traffic against one server (1) and a
    forwarding primary/backup pair (2), best of ``trials``; the overheads
    are the 1-replica MB/s over this row's."""
    rows: dict = {}
    mb = elems * 4 / 1e6
    for n in counts:
        ports = [ps_service.start_server(0) for _ in range(n)]
        if n > 1:
            ps_service.set_server_peer(ports[0], (host, ports[1]))
            ps_service.set_server_peer(ports[1], (host, ports[0]))
            ps_service.resync_server(ports[1], wait_s=10.0)
        try:
            c = ps_service.PSClient(host, ports[0], timeout_s=120.0, worker_tag=1,
                                    addrs=[(host, p) for p in ports] if n > 1 else None)
            st = ps_service.RemoteParamStore(c, "p_rep", elems, cache_pulls=False)
            flat = _payload(elems)
            st.set(0, flat)
            st.get()
            gq = ps_service.RemoteGradientQueue(c, "g_rep", elems, capacity=4)

            def push_pop():
                gq.push(0, flat)
                gq.pop()

            push_pop()
            row: dict = {"replicas": n, "set_mbs": 0.0, "push_pop_mbs": 0.0}
            for _ in range(max(1, trials)):
                row["set_mbs"] = max(row["set_mbs"], reps * mb / _time(lambda: st.set(1, flat), reps))
                row["push_pop_mbs"] = max(row["push_pop_mbs"], reps * 2 * mb / _time(push_pop, reps))
            rows[str(n)] = row
            c.close()
        finally:
            for p in ports:
                ps_service.stop_server(p)
    base = rows.get("1")
    if base:
        for row in rows.values():
            row["replicated_set_overhead"] = base["set_mbs"] / row["set_mbs"]
            row["replicated_push_overhead"] = base["push_pop_mbs"] / row["push_pop_mbs"]
    return rows


def bench_concurrent_get(host: str, port: int, *, clients: int, elems: int, reps: int) -> dict:
    """``clients`` threads pulling the same published vector at once: every
    worker pulling before every gradient."""
    setup = ps_service.PSClient(host, port, timeout_s=60.0)
    ps = ps_service.RemoteParamStore(setup, "p_conc", elems, cache_pulls=False)
    ps.set(0, np.ones(elems, np.float32))
    errs: list = []

    def worker():
        try:
            c = ps_service.PSClient(host, port, timeout_s=120.0)
            p = ps_service.RemoteParamStore(c, "p_conc", elems, cache_pulls=False)
            for _ in range(reps):
                p.get()
            c.close()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    setup.close()
    if errs:
        raise errs[0]
    return {"clients": clients, "get_mbs_aggregate": clients * reps * elems * 4 / 1e6 / dt}


def gates(detail: dict) -> dict:
    """Per wire dtype: a full pull takes at least ``IF_NEWER_RATIO`` times
    an unchanged-step if-newer round trip."""
    out = {}
    for dtype, row in detail.items():
        if isinstance(row, dict) and "if_newer_rtt_us" in row and row.get("get_mbs_large"):
            full_pull_us = detail["large_mb"] / row["get_mbs_large"] * 1e6
            out[f"{dtype}_if_newer_ge_{IF_NEWER_RATIO:g}x"] = (
                full_pull_us >= IF_NEWER_RATIO * row["if_newer_rtt_us"])
    return out


def run(args) -> dict:
    large_elems = int(args.large_mb * 1e6 / 4)
    small_elems = max(1, int(args.small_kb * 1024 / 4))
    port = ps_service.start_server(0)
    checks = {}
    try:
        detail: dict = {
            "large_mb": args.large_mb,
            "small_kb": args.small_kb,
            "memcpy_mbs": _hostbench.memcpy_mbs(large_elems * 4),
            # Loopback sharding is CPU parallelism: whether this host can
            # show a sharded speedup at all.
            "cpus": os.cpu_count() or 1,
        }
        for dtype in args.dtypes:
            detail[dtype], checks[f"{dtype}_pull_equals_published"] = bench_dtype(
                "127.0.0.1", port, dtype, large_elems=large_elems, small_elems=small_elems,
                reps_large=args.reps_large, reps_small=args.reps_small)
            for k in ("set_mbs_large", "get_mbs_large", "set_get_mbs_large", "push_pop_mbs_large"):
                detail[dtype][k + "_frac_memcpy"] = detail[dtype][k] / detail["memcpy_mbs"]
        detail["concurrent"] = bench_concurrent_get(
            "127.0.0.1", port, clients=args.clients, elems=large_elems,
            reps=max(2, args.reps_large // 2))
    finally:
        ps_service.stop_server(port)
    # Each axis on servers of its own, the main server down.
    detail["shards"] = bench_shards("127.0.0.1", counts=getattr(args, "shards_axis", [1, 2]),
                                    elems=large_elems, reps=args.reps_large)
    detail["replicas"] = bench_replication(
        "127.0.0.1", counts=getattr(args, "replicas_axis", [1, 2]), elems=large_elems,
        reps=args.reps_large)
    detail["gates"] = gates(detail)
    detail["checks"] = checks
    return detail


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large-mb", type=float, default=64.0,
                    help="large payload size (f32-equivalent MB)")
    ap.add_argument("--small-kb", type=float, default=4.0)
    ap.add_argument("--clients", type=int, default=4, help="threads in the concurrent-get row")
    ap.add_argument("--reps-large", type=int, default=8)
    ap.add_argument("--reps-small", type=int, default=200)
    ap.add_argument("--dtypes", default="f32,bf16")
    ap.add_argument("--shards", default="1,2,4",
                    help="shard-scaling axis: local shard-server counts (same total bytes a row)")
    ap.add_argument("--replicas", default="1,2",
                    help="replication axis: 1 = one server, 2 = a forwarding primary/backup pair")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: 8 MB large payload, 2 clients, few reps")
    ap.add_argument("--json", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if args.quick:
        args.large_mb = min(args.large_mb, 8.0)
        args.clients = min(args.clients, 2)
        args.reps_large = min(args.reps_large, 4)
        args.reps_small = min(args.reps_small, 50)
    args.dtypes = [d for d in args.dtypes.split(",") if d]
    args.shards_axis = [int(s) for s in args.shards.split(",") if s]
    args.replicas_axis = [int(s) for s in args.replicas.split(",") if s]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    detail = run(args)
    _hostbench.emit({"metric": "ps_transport_set_get_mbs",
                     "value": round(detail[args.dtypes[0]]["set_get_mbs_large"], 1),
                     "unit": "MB/s", "detail": _hostbench.rounded(detail, 4)}, args.json)
    # The rules' verdicts are printed in ``gates``; only a failed
    # correctness check fails the command.
    return 0 if all(detail["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
