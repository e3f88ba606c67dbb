"""Serving-plane microbenchmark of the port, the twin of the root
``tools/serving_bench.py``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.serving_bench                # full rows, on the card
    python -m distributed_tensorflow_examples_tpu_torch.tools.serving_bench --quick        # CI-sized
    python -m distributed_tensorflow_examples_tpu_torch.tools.serving_bench --device=cpu   # the apply on the CPU

Prices the online inference plane end to end on loopback: in-process PS
shard servers (``parallel/ps_service.py``) publish a 512-512-128 MLP's
flat parameters, one ``serve.ModelReplicaServer`` tracks them, and
client threads drive predicts through the whole stack: wire framing, the
micro-batcher, the padded apply (a plain torch function of the published
parameters, under ``torch.inference_mode()`` on ``--device``), and the
per-request scatter.  Three regimes:

- **single**: one client, one request at a time; each pays the whole
  round trip and its own apply window (``max_wait_ms`` included);
- **batched**: ``--client-sweep`` concurrent clients; requests that arrive
  during an apply coalesce into the next one.  The headline row is the
  widest sweep count;
- **concurrency**: ``--clients=64,256`` connections, each at a fixed
  per-client rate, so the p99 ratio between the widest and narrowest
  counts prices the server core's per-connection cost.

Rows are best-of-``--trials``; MB/s counts request and response payload
bytes, normalised by the host's memcpy (``tools/_hostbench.py``).  The
rules, from the result alone (the root's, ``tools/perf_gate.py``):
``batched_speedup = batched.qps / single.qps >= 3.0`` at ``max_batch >=
32``, and p99 at the widest connection count <= 3x p99 at the narrowest;
a rule that does not apply reads null.  ``checks``: one served
prediction equals the plain float64 apply of the published parameters
within ``TOL_PREDICT``.  Only a false check exits non-zero; the gates
are printed.  The apply runs on the card unless ``--device=cpu``;
without a card the default raises, as every entry point of the port
does.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

from ..parallel import ps_service, ps_shard
from ..serve import ModelReplicaServer, ServeClient
from ..utils import device as device_lib
from . import _hostbench

# A serving-shaped model: a 2-layer MLP whose padded 32-row apply has
# enough work for coalescing to amortise (a trivially cheap apply measures
# only the wire and thread overhead, which batching does not amortise).
D_IN, D_HID, D_OUT = 512, 512, 128
PARAM_SHAPES = {"b1": (D_HID,), "w1": (D_IN, D_HID), "w2": (D_HID, D_OUT)}
NUM_ELEMS = D_IN * D_HID + D_HID + D_HID * D_OUT
#: The rules (``tools/perf_gate.py``'s ``serving_speedup`` and
#: ``concurrent_p99_ratio``).
SERVING_SPEEDUP = 3.0
SPEEDUP_MIN_BATCH = 32
CONCURRENT_P99_RATIO = 3.0
#: A served float32 prediction against the float64 apply, relative to the
#: largest |logit|: each logit sums 512 float32 products of ~0.03, which
#: rounds to ~1e-7 of the logit; a wrong weight, bias or row is O(1).
TOL_PREDICT = 1e-4


def predict_fn(params, batch):
    """The served apply: relu(x @ w1 + b1) @ w2, row-wise."""
    h = torch.relu(batch["x"] @ params["w1"] + params["b1"])
    return h @ params["w2"]


def published_flat(num_elems: int = NUM_ELEMS) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(size=num_elems).astype(np.float32) * 0.05


def plain_apply(flat: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``predict_fn`` in float64 numpy over the flat vector in the
    parameters' tree order (b1, w1, w2)."""
    f = flat.astype(np.float64)
    b1, w1 = f[:D_HID], f[D_HID : D_HID + D_IN * D_HID].reshape(D_IN, D_HID)
    w2 = f[D_HID + D_IN * D_HID :].reshape(D_HID, D_OUT)
    return np.maximum(x.astype(np.float64) @ w1 + b1, 0.0) @ w2


def publish_params(addrs, flat: np.ndarray, step: int = 1):
    group = ps_shard.ShardedPSClients(addrs, role="bench_pub", op_timeout_s=10.0)
    pstore = ps_shard.ShardedParamStore(group, "params", ps_shard.ShardLayout(flat.size, len(addrs)))
    pstore.set(step, flat)
    return group


def _inputs(rows: int) -> np.ndarray:
    return np.random.default_rng(7).normal(size=(rows, D_IN)).astype(np.float32)


def _latency_row(lat: list[list[float]], dt: float, **head) -> dict:
    all_lat = np.concatenate([np.asarray(l) for l in lat if l])
    return {**head, "requests": int(all_lat.size), "qps": all_lat.size / dt,
            "p50_ms": float(np.percentile(all_lat, 50) * 1e3),
            "p99_ms": float(np.percentile(all_lat, 99) * 1e3)}


def drive(addr, *, clients: int, n_requests: int, rows: int, seconds_cap: float) -> dict:
    """``n_requests`` predicts over ``clients`` threads, each one at a time
    on its own connection; qps and latency percentiles over them all.  A
    failed request raises."""
    per = max(1, n_requests // clients)
    lat: list[list[float]] = [[] for _ in range(clients)]
    errors: list = []
    x = _inputs(rows)
    start = threading.Barrier(clients + 1)

    def body(ci: int) -> None:
        try:
            c = ServeClient(*addr, role=f"bench{ci}_sv")
            c.predict({"x": x})  # warm: connect outside the window
            start.wait()
            t_end = time.perf_counter() + seconds_cap
            for _ in range(per):
                t0 = time.perf_counter()
                c.predict({"x": x})
                lat[ci].append(time.perf_counter() - t0)
                if time.perf_counter() > t_end:
                    break
            c.close()
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=body, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass  # a client failed; errors[0] carries the cause
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return _latency_row(lat, dt, clients=clients)


def drive_paced(addr, *, clients: int, rate_per_client: float, duration_s: float,
                rows: int) -> dict:
    """``clients`` connections, each issuing requests at a fixed rate (a
    paced load, open-loop per client); latency per request.  Per-client
    behaviour is constant while the connection count grows, so the p99
    ratio isolates the server core's per-connection cost.  A failed
    request raises."""
    per = max(1, int(rate_per_client * duration_s))
    lat: list[list[float]] = [[] for _ in range(clients)]
    errors: list = []
    x = _inputs(rows)
    start = threading.Barrier(clients + 1)
    period = 1.0 / rate_per_client

    def body(ci: int) -> None:
        try:
            c = ServeClient(*addr, role=f"bench{ci}_sv")
            c.predict({"x": x})
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            # Abort, not a timed wait: a timed wait can itself break the
            # barrier while 255 peers warm slowly, hiding the real failure.
            errors.append(e)
            start.abort()
            return
        try:
            start.wait()
        except threading.BrokenBarrierError:
            c.close()
            return
        try:
            # A fixed per-client phase spreads the arrivals uniformly.
            next_t = time.perf_counter() + (ci % 16) * period / 16
            for _ in range(per):
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += period
                t0 = time.perf_counter()
                c.predict({"x": x})
                lat[ci].append(time.perf_counter() - t0)
            c.close()
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return _latency_row(lat, dt, clients=clients, rate_per_client=rate_per_client)


def gates(detail: dict) -> dict:
    """The rules from the result alone; None where a rule does not apply
    (``max_batch`` under 32, or fewer than two connection counts)."""
    out = {"batched_speedup_ge_3": None, "concurrent_p99_ratio_le_3": None}
    if detail.get("max_batch", 0) >= SPEEDUP_MIN_BATCH and detail.get("batched_speedup") is not None:
        out["batched_speedup_ge_3"] = detail["batched_speedup"] >= SERVING_SPEEDUP
    ratio = (detail.get("concurrency") or {}).get("p99_ratio")
    if ratio is not None:
        out["concurrent_p99_ratio_le_3"] = ratio <= CONCURRENT_P99_RATIO
    return out


def check_predict(addr, flat: np.ndarray, rows: int = 4) -> float:
    """One served prediction's largest error against :func:`plain_apply`,
    relative to the largest |logit|."""
    x = _inputs(rows)
    c = ServeClient(*addr, role="bench_check_sv")
    try:
        _step, out = c.predict({"x": x})
    finally:
        c.close()
    got = np.asarray(out["output"], np.float64)
    want = plain_apply(flat, x)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def run(args) -> dict:
    device = device_lib.resolve(args.device)
    flat = published_flat()
    ports = [ps_service.start_server(0, shard_id=i, shard_count=args.ps_shards)
             for i in range(args.ps_shards)]
    group = server = None
    try:
        addrs = [("127.0.0.1", p) for p in ports]
        group = publish_params(addrs, flat)
        server = ModelReplicaServer(
            PARAM_SHAPES, predict_fn, addrs, device=device,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            queue_depth=max(256, 4 * args.max_batch), role="bench_serve",
        )
        if not server.wait_for_model(30.0):
            raise RuntimeError("replica never pulled the published params")
        addr = ("127.0.0.1", server.port)
        # Payload bytes a request: input rows + output rows (what the wire
        # moves), for the memcpy normalisation.
        payload_bytes = args.rows * (D_IN + D_OUT) * 4
        err = check_predict(addr, flat)
        detail: dict = {
            "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
            "rows_per_request": args.rows, "ps_shards": args.ps_shards,
            "payload_bytes": payload_bytes, "cpus": os.cpu_count() or 1,
            "memcpy_mbs": _hostbench.memcpy_mbs(1 << 24), "device": str(device),
            "predict_max_rel_err": err,
        }
        detail["single"] = _hostbench.best_of(args.trials, lambda: drive(
            addr, clients=1, n_requests=args.n_single, rows=args.rows,
            seconds_cap=args.seconds_cap), "qps")
        sweep = {str(nc): _hostbench.best_of(args.trials, lambda nc=nc: drive(
            addr, clients=nc, n_requests=args.n_batched, rows=args.rows,
            seconds_cap=args.seconds_cap), "qps") for nc in args.client_sweep}
        detail["client_sweep"] = sweep
        # The headline batched row: the widest count, the one that can fill
        # max_batch.
        detail["batched"] = sweep[str(max(args.client_sweep))]
        if args.clients:
            conc = {str(nc): drive_paced(
                addr, clients=nc, rate_per_client=args.concurrency_rate,
                duration_s=args.concurrency_secs, rows=args.rows) for nc in args.clients}
            lo, hi = str(min(args.clients)), str(max(args.clients))
            ratio = (conc[hi]["p99_ms"] / conc[lo]["p99_ms"]
                     if lo != hi and conc[lo]["p99_ms"] > 0 else None)
            detail["concurrency"] = {"rate_per_client": args.concurrency_rate,
                                     "duration_s": args.concurrency_secs,
                                     "clients": conc, "p99_ratio": ratio}
        for row in ("single", "batched"):
            detail[row]["stream_mbs"] = detail[row]["qps"] * payload_bytes / 1e6
            detail[row]["stream_mbs_frac_memcpy"] = detail[row]["stream_mbs"] / detail["memcpy_mbs"]
        detail["batched_speedup"] = detail["batched"]["qps"] / detail["single"]["qps"]
        detail["server_stats"] = {
            k: v for k, v in server.stats().items()
            if k.startswith(("batcher_", "serve/")) or k in ("requests", "predict_rows", "overloads")
        }
        detail["gates"] = gates(detail)
        detail["checks"] = {"predict_equals_plain_apply": err <= TOL_PREDICT}
        return detail
    finally:
        if server is not None:
            server.stop()
        if group is not None:
            group.close()
        for p in ports:
            ps_service.stop_server(p)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-batch", type=int, default=32,
                    help="micro-batcher row budget (the speedup rule applies at >= 32)")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="coalescing window, applied to both regimes (the single row pays "
                    "it in full; the batched row amortises it)")
    ap.add_argument("--rows", type=int, default=1, help="rows per predict request")
    ap.add_argument("--ps-shards", type=int, default=2)
    ap.add_argument("--client-sweep", type=int, nargs="+", default=[4, 16, 32],
                    help="concurrent-client counts for the batched rows")
    ap.add_argument("--clients", type=int, nargs="+", default=[64, 256],
                    help="connection counts of the concurrency axis (paced per-client "
                    "load); an empty list skips the axis")
    ap.add_argument("--concurrency-rate", type=float, default=2.0,
                    help="per-client request rate (req/s) on the concurrency axis")
    ap.add_argument("--concurrency-secs", type=float, default=10.0,
                    help="per-row wall time on the concurrency axis")
    ap.add_argument("--n-single", type=int, default=300, help="single-client measured requests")
    ap.add_argument("--n-batched", type=int, default=2000,
                    help="total measured requests per batched row")
    ap.add_argument("--trials", type=int, default=3, help="best-of-N")
    ap.add_argument("--seconds-cap", type=float, default=20.0, help="per-trial wall cap")
    ap.add_argument("--device", default=None,
                    help="torch device of the apply; default cuda (no silent CPU)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: fewer requests, 1 trial, small sweep")
    ap.add_argument("--json", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if args.quick:
        args.client_sweep = [4, 32]
        args.n_single = min(args.n_single, 80)
        args.n_batched = min(args.n_batched, 600)
        args.trials = 1
        args.seconds_cap = min(args.seconds_cap, 10.0)
        args.concurrency_secs = min(args.concurrency_secs, 5.0)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    detail = run(args)
    # 6 decimals: the *_frac_memcpy rows are tiny (KB payloads against
    # GB/s memcpy) and must not round to 0.
    rec = {"metric": "serving_qps", "value": round(detail["batched"]["qps"], 1),
           "unit": "req/s", "detail": _hostbench.rounded(detail, 6)}
    rec["detail"]["predict_max_rel_err"] = detail["predict_max_rel_err"]  # ~1e-7: unrounded
    _hostbench.emit(rec, args.json)
    # The rules' verdicts are printed in ``gates``; only a failed
    # correctness check fails the command.
    return 0 if all(detail["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
