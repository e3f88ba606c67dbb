"""Helpers the port's host benchmarks share (``loader_bench``,
``data_service_bench``, ``serving_bench``, ``ps_transport_bench``): the
host memcpy normaliser, the best-of-N loop and the JSON record writer.

A ``*_frac_memcpy`` row is a throughput divided by :func:`memcpy_mbs` on
the same host: a copy-per-send regression costs a fixed multiple of
memcpy, so the normalised number compares across hosts of very
different speed (the root tools' convention).
"""

from __future__ import annotations

import json
import time

import numpy as np


def memcpy_mbs(nbytes: int, reps: int = 8) -> float:
    """Host memcpy bandwidth in MB/s at ``nbytes`` a copy (one warm copy,
    then ``reps`` timed ones): the root tools' normaliser."""
    src = np.ones(max(1, nbytes // 4), np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    t0 = time.perf_counter()
    for _ in range(reps):
        np.copyto(dst, src)
    return reps * src.nbytes / (time.perf_counter() - t0) / 1e6


def best_of(trials: int, fn, key: str) -> dict:
    """The row of ``trials`` calls of ``fn`` with the largest ``key``: the
    noise-floor estimator of a throughput microbenchmark on a shared host."""
    rows = [fn() for _ in range(max(1, trials))]
    return max(rows, key=lambda r: r[key])


def rounded(value, digits: int):
    """``value`` with every float, at any depth of dicts and lists, rounded
    to ``digits`` decimals."""
    if isinstance(value, dict):
        return {k: rounded(v, digits) for k, v in value.items()}
    if isinstance(value, list):
        return [rounded(v, digits) for v in value]
    return round(value, digits) if isinstance(value, float) else value


def emit(record: dict, json_path: str = "") -> None:
    """Print ``record`` as one JSON line, and write it to ``json_path``
    too when one is given (the root tools' ``--json``)."""
    if json_path:
        with open(json_path, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
