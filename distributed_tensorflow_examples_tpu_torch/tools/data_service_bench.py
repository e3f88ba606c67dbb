"""Data-service streaming microbenchmark of the port, the twin of the root
``tools/data_service_bench.py``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.data_service_bench            # 512-row (~1.5 MB raw) batches
    python -m distributed_tensorflow_examples_tpu_torch.tools.data_service_bench --quick    # CI-sized
    python -m distributed_tensorflow_examples_tpu_torch.tools.data_service_bench --json out.json

Prices the disaggregation tax: the same ``.npz`` shard directory is
consumed once through the local loader (``data/filestream.py``, the path
a training host runs) and once through the port's data service
(``data/data_service.py``) over loopback, server-side decode, split
dispatch and the batch wire included.  Each row gives MB/s of decoded
batch bytes and ``stream_mbs_frac_memcpy`` (normalised by the host's
memcpy, ``tools/_hostbench.py``); the remote row also a heartbeat's round
trip, measured before the stream starts.

The rule, from the result alone (the root's acceptance contract):
``remote.stream_mbs >= 0.5 * local.stream_mbs`` at 1 MB+ raw batches; a
``--quick`` run's batches are smaller, where per-batch round trips
legitimately dominate, so its gate reads null.  ``checks``: the remote
batches have the local ones' fields, shapes and dtypes.  The record's
``gates`` and ``checks`` hold the verdicts; only a false check exits
non-zero.
Host only, as the root tool is.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import numpy as np

from ..data import data_service, filestream
from . import _hostbench

#: remote >= REMOTE_LOCAL_RATIO x local MB/s at raw batches of at least
#: RULE_MIN_BATCH_MB (``tools/perf_gate.py``'s ``remote_local_ratio``).
REMOTE_LOCAL_RATIO = 0.5
RULE_MIN_BATCH_MB = 1.0


def batch_nbytes(b: dict) -> int:
    return sum(np.asarray(v).nbytes for v in b.values())


def layout(b: dict) -> dict:
    return {k: (tuple(np.asarray(v).shape), str(np.asarray(v).dtype)) for k, v in b.items()}


def make_shards(d: str, *, rows: int, rows_per_shard: int, hw: int) -> None:
    rng = np.random.default_rng(0)
    filestream.write_array_shards(
        d,
        {
            "image": rng.integers(0, 255, size=(rows, hw, hw, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, size=rows).astype(np.int64),
        },
        rows_per_shard=rows_per_shard,
    )


def drain(it, n_batches: int) -> tuple[float, float, dict]:
    """(seconds, decoded MB, first batch) for ``n_batches`` pulled from
    ``it`` after one warm batch (connect, cache fill)."""
    first = next(it)
    mb_per = batch_nbytes(first) / 1e6
    t0 = time.perf_counter()
    for _ in range(n_batches):
        next(it)
    return time.perf_counter() - t0, n_batches * mb_per, first


def bench_local(shard_dir: str, *, batch_rows: int, n_batches: int, seed: int) -> tuple[dict, dict]:
    pipe = filestream.FileStreamPipeline(
        shard_dir, batch_size=batch_rows,
        decode_fn=filestream.image_decode_fn(augment=True, seed=seed),
        seed=seed, process_index=0, process_count=1,
    )
    dt, mb, first = drain(iter(pipe), n_batches)
    return {"stream_mbs": mb / dt, "batches_per_s": n_batches / dt}, first


def bench_remote(shard_dir: str, *, batch_rows: int, n_batches: int, seed: int) -> tuple[dict, dict]:
    server = data_service.DataServiceServer(
        filestream.list_shards(shard_dir), batch_size=batch_rows,
        decode_fn=filestream.image_decode_fn(augment=True, seed=seed), seed=seed,
    )
    try:
        src = data_service.RemoteDatasetSource(
            f"dsvc://127.0.0.1:{server.port}", worker_id=0, role="bench_ds")
        try:
            row = {}
            # The small-op round trip, before the batch stream starts: the
            # prefetch thread shares the lock-serialised client, so a
            # heartbeat during multi-MB pulls would measure queueing.
            src._client.heartbeat()
            reps = 50
            t0 = time.perf_counter()
            for _ in range(reps):
                src._client.heartbeat()
            row["heartbeat_rtt_us"] = (time.perf_counter() - t0) / reps * 1e6
            dt, mb, first = drain(src.batches(repeat=True), n_batches)
            row.update({"stream_mbs": mb / dt, "batches_per_s": n_batches / dt})
        finally:
            src.close()
        return row, first
    finally:
        server.stop()


def gates(detail: dict) -> dict:
    """The rule from the result alone: remote within 2x of local at 1 MB+
    raw batches (None below that size, where it does not apply)."""
    if detail["raw_batch_mb"] < RULE_MIN_BATCH_MB:
        return {"remote_ge_half_local": None}
    return {"remote_ge_half_local": detail["remote"]["stream_mbs"]
            >= REMOTE_LOCAL_RATIO * detail["local"]["stream_mbs"]}


def run(args) -> dict:
    d = tempfile.mkdtemp(prefix="dtx_dsvc_bench_")
    try:
        make_shards(d, rows=args.shards * args.rows_per_shard,
                    rows_per_shard=args.rows_per_shard, hw=args.hw)
        raw_batch_mb = args.batch_rows * args.hw * args.hw * 3 / 1e6
        detail: dict = {
            "batch_rows": args.batch_rows,
            "raw_batch_mb": round(raw_batch_mb, 3),
            "shards": args.shards,
            "memcpy_mbs": _hostbench.memcpy_mbs(max(1 << 22, int(raw_batch_mb * 4e6))),
        }
        kw = dict(batch_rows=args.batch_rows, n_batches=args.n_batches, seed=args.seed)
        detail["local"], local_first = bench_local(d, **kw)
        detail["remote"], remote_first = bench_remote(d, **kw)
        for row in ("local", "remote"):
            detail[row]["stream_mbs_frac_memcpy"] = detail[row]["stream_mbs"] / detail["memcpy_mbs"]
        detail["remote_over_local"] = detail["remote"]["stream_mbs"] / detail["local"]["stream_mbs"]
        detail["gates"] = gates(detail)
        detail["checks"] = {"remote_batch_layout": layout(remote_first) == layout(local_first)}
        return detail
    finally:
        shutil.rmtree(d, ignore_errors=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-rows", type=int, default=512,
                    help="rows per batch (512 x 32x32x3 uint8 = 1.5 MB raw, 6 MB decoded f32: "
                    "the 1 MB+ regime of the rule)")
    ap.add_argument("--hw", type=int, default=32, help="image height/width")
    ap.add_argument("--rows-per-shard", type=int, default=2048)
    ap.add_argument("--shards", type=int, default=6)
    ap.add_argument("--n-batches", type=int, default=40,
                    help="measured batches per source (after 1 warmup)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="CI-sized: smaller shards, fewer batches")
    ap.add_argument("--json", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_rows = min(args.batch_rows, 256)
        args.rows_per_shard = min(args.rows_per_shard, 1024)
        args.shards = min(args.shards, 4)
        args.n_batches = min(args.n_batches, 12)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    detail = run(args)
    _hostbench.emit({"metric": "data_service_stream_mbs",
                     "value": round(detail["remote"]["stream_mbs"], 1), "unit": "MB/s",
                     "detail": _hostbench.rounded(detail, 4)}, args.json)
    # The rules' verdicts are printed in ``gates``; only a failed
    # correctness check fails the command.
    return 0 if all(detail["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
