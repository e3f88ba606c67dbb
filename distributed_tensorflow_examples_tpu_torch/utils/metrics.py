"""Metrics writer: the tf.summary event-file role (SURVEY.md T4, section 5.5).

Primary sink is JSONL (``<log_dir>/metrics.jsonl``) — trivially parseable by
the bench harness and tests.  If TensorBoard's pure-python writer is importable
(it ships with the baked TF install), scalars are mirrored into real event
files so standard tooling works; its absence degrades silently.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np


class LatencyRecorder:
    """Ring buffer of recent op wall times -> latency/throughput scalars
    (r10 satellite, the serving plane's ``serve/latency_*`` family).

    ``record(seconds)`` is O(1) and thread-safe (many connection handlers
    record concurrently); :meth:`percentile_scalars` reduces the retained
    window into ``<prefix>/latency_p50_ms`` / ``p90`` / ``p99`` plus
    ``<prefix>/qps`` (events per second across the window's wall-time
    span).  One tag family, so dashboards glob ``serve/latency_*``."""

    def __init__(self, capacity: int = 2048):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self._cap = int(capacity)
        self._dur = np.zeros(self._cap, np.float64)
        self._at = np.zeros(self._cap, np.float64)
        self._n = 0  # total ever recorded; ring index is _n % _cap
        self._lock = threading.Lock()

    def record(self, seconds: float, *, at: float | None = None) -> None:
        """Record one op's wall time.  ``at`` (monotonic seconds) defaults
        to now — tests pass explicit stamps for deterministic qps."""
        with self._lock:
            i = self._n % self._cap
            self._dur[i] = seconds
            self._at[i] = time.monotonic() if at is None else at
            self._n += 1

    def __len__(self) -> int:
        return min(self._n, self._cap)

    @property
    def total(self) -> int:
        """Ops ever recorded (the ring only bounds the percentile window)."""
        return self._n

    def percentile_scalars(self, prefix: str) -> dict[str, float]:
        """The retained window as scalar tags; empty dict when nothing has
        been recorded yet (emitters skip the write instead of publishing
        zeros that read as impossibly fast ops)."""
        with self._lock:
            m = min(self._n, self._cap)
            if m == 0:
                return {}
            dur = self._dur[:m].copy()
            at = self._at[:m].copy()
        out = {
            f"{prefix}/latency_p{p}_ms": float(np.percentile(dur, p) * 1e3)
            for p in (50, 90, 99)
        }
        span = float(at.max() - at.min())
        out[f"{prefix}/qps"] = (m - 1) / span if m >= 2 and span > 0 else 0.0
        return out


class MetricsWriter:
    def __init__(self, log_dir: str | None, *, tensorboard: bool = True):
        self.log_dir = log_dir
        self._f = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
            if tensorboard:
                try:  # optional dependency — degrade to JSONL-only
                    from tensorboard.summary.writer.event_file_writer import (
                        EventFileWriter,
                    )
                    from tensorboard.compat.proto.summary_pb2 import Summary
                    from tensorboard.compat.proto.event_pb2 import Event

                    self._tb = EventFileWriter(log_dir)
                    self._Summary, self._Event = Summary, Event
                except Exception:
                    self._tb = None

    def scalars(self, step: int, values: dict[str, float]) -> None:
        if self._f is not None:
            self._f.write(
                json.dumps({"step": step, "time": time.time(), **values}) + "\n"
            )
        if self._tb is not None:
            summ = self._Summary(
                value=[
                    self._Summary.Value(tag=k, simple_value=float(v))
                    for k, v in values.items()
                ]
            )
            self._tb.add_event(
                self._Event(step=step, wall_time=time.time(), summary=summ)
            )

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        """Flush + close both sinks.  Idempotent: teardown paths (context
        exit, ``Experiment.finish``, test fixtures) may all call it."""
        f, self._f = self._f, None
        tb, self._tb = self._tb, None
        if f is not None:
            f.flush()
            f.close()
        if tb is not None:
            tb.flush()
            tb.close()

    # Context manager: ``with MetricsWriter(d) as w: ...`` guarantees the
    # TensorBoard event file is flushed — the JSONL sink is line-buffered,
    # but TB events buffer in the writer thread and are LOST on an exit
    # that skips close() (the abrupt-exit gap this closes).
    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
