"""Hooks around the host-side train loop: the port of
``distributed_tensorflow_examples_tpu/train/hooks.py``.

- ``StopAtStepHook``  — stop at a global step.
- ``StepCounterHook`` — steps/sec and examples/sec/chip.
- ``LoggingHook``     — periodic metric logging.
- ``CheckpointHook``  — periodic and final save via ``train.checkpoint``.
- ``SummaryHook``     — metric series to ``utils.metrics.MetricsWriter``.
- ``ProfilerHook``    — a ``torch.profiler`` trace window and its summary.

Hooks observe the loop between steps; reading a metric (``float(v)``)
synchronises with the device, so only the logging and summary cadences
do it.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import torch

log = logging.getLogger("dtx.hooks")


class Hook:
    """Lifecycle: begin(loop) -> [before_step / after_step]* -> end(loop)."""

    def begin(self, loop) -> None: ...

    def before_step(self, loop) -> None: ...

    def after_step(self, loop, metrics: dict[str, Any]) -> None: ...

    def end(self, loop) -> None: ...


class StopAtStepHook(Hook):
    def __init__(self, last_step: int):
        self.last_step = last_step

    def begin(self, loop):
        # An auto-resumed session may already be at/past the target.
        if loop.step >= self.last_step:
            loop.request_stop(f"already at step {loop.step} >= {self.last_step}")

    def after_step(self, loop, metrics):
        if loop.step >= self.last_step:
            loop.request_stop(f"reached step {self.last_step}")


class StepCounterHook(Hook):
    """steps/sec + examples/sec(/chip; the port trains on one).  Timing
    starts at the first after_step, so the first step's one-off costs
    (kernel builds, the allocator's first growth) stay out of the rate."""

    def __init__(self, every_steps: int = 100, batch_size: int | None = None):
        self.every = every_steps
        self.batch_size = batch_size
        self._t0 = None
        self._s0 = 0
        self.last_steps_per_sec: float | None = None
        self.last_examples_per_sec_per_chip: float | None = None

    def begin(self, loop):
        self._t0 = None

    def after_step(self, loop, metrics):
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._s0 = loop.step
            return
        if loop.step - self._s0 < self.every:
            return
        now = time.perf_counter()
        steps = loop.step - self._s0
        self.last_steps_per_sec = steps / (now - self._t0)
        msg = f"step {loop.step}: {self.last_steps_per_sec:.1f} steps/sec"
        if self.batch_size:
            eps = self.last_steps_per_sec * self.batch_size
            self.last_examples_per_sec_per_chip = eps
            msg += (
                f", {eps:.0f} examples/sec"
                f" ({self.last_examples_per_sec_per_chip:.0f}/chip)"
            )
        log.info(msg)
        loop.record(
            steps_per_sec=self.last_steps_per_sec,
            examples_per_sec_per_chip=self.last_examples_per_sec_per_chip,
        )
        self._t0, self._s0 = now, loop.step


class LoggingHook(Hook):
    """Every N steps, fetch the metrics and log them (delta-based cadence,
    so it holds under unroll > 1)."""

    def __init__(self, every_steps: int = 100):
        self.every = every_steps
        self._last = 0

    def begin(self, loop):
        self._last = loop.step

    def after_step(self, loop, metrics):
        if loop.step - self._last < self.every:
            return
        self._last = loop.step
        parts = ", ".join(f"{k}={v:.4f}" for k, v in sorted(scalars(metrics).items()))
        log.info("step %d: %s", loop.step, parts)


class CheckpointHook(Hook):
    """Periodic + final save through a ``checkpoint.CheckpointManager``."""

    def __init__(self, manager, every_steps: int = 1000):
        self.mgr = manager
        self.every_steps = every_steps
        self._last_s = 0

    def begin(self, loop):
        self._last_s = loop.step

    def after_step(self, loop, metrics):
        if loop.step - self._last_s >= self.every_steps:
            self.mgr.save(loop.step, loop.state)
            self._last_s = loop.step

    def end(self, loop):
        self.mgr.save(loop.step, loop.state)
        self.mgr.wait()


class SummaryHook(Hook):
    """Writes scalar metrics to a ``utils.metrics.MetricsWriter`` every N
    steps."""

    def __init__(self, writer, every_steps: int = 100):
        self.writer = writer
        self.every = every_steps
        self._last = 0

    def begin(self, loop):
        self._last = loop.step

    def after_step(self, loop, metrics):
        if loop.step - self._last < self.every:
            return
        self._last = loop.step
        self.writer.scalars(loop.step, scalars(metrics))

    def end(self, loop):
        self.writer.flush()


class ProfilerHook(Hook):
    """A ``torch.profiler`` trace of steps [start, start + count): the JAX
    hook's ``jax.profiler`` window, with its straddle arithmetic under
    ``steps_per_call``.  It records host activity, and the device's when
    the loop's state lives on a CUDA device.  At the stop it synchronises
    the device and writes, under ``log_dir/plugins/profile/<run>/``, the
    Chrome trace and a JSON summary of the window
    (``tools/profile_step.py``'s reader), each named for the rank
    (``rank<r>.pt.trace.json``, ``rank<r>.summary.json``), and keeps the
    window's ``trace`` and ``summary``.  A window on a CUDA device that
    recorded no device time raises: that profile would be silently
    empty."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._active = False
        self._prof = None
        self.trace_path: str | None = None
        self.trace = None  # the window's tools/profile_step.py Trace
        self.summary: dict | None = None

    def before_step(self, loop):
        # Straddle check: under unroll>1 the observed step advances by
        # steps_per_call and may jump over [start, stop) entirely; activate
        # whenever the upcoming call overlaps the window.
        upcoming_end = loop.step + getattr(loop, "steps_per_call", 1)
        if not self._active and loop.step < self.stop and upcoming_end > self.start:
            self._start(loop)
            self._active = True

    def after_step(self, loop, metrics):
        if self._active and loop.step >= self.stop:
            self._stop()
            self._active = False

    def end(self, loop):
        if self._active:
            self._stop()
            self._active = False

    def _start(self, loop) -> None:
        from torch.profiler import ProfilerActivity, profile

        from .state import leaves

        params = getattr(getattr(loop, "state", None), "params", None)
        first = next(iter(leaves(params)), None) if params is not None else None
        self._cuda = first is not None and first.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        if self._cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        import json
        import os

        from ..parallel import dist
        from ..tools import profile_step

        if self._cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        run = os.path.join(self.log_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        rank = dist.process_index()
        self.trace_path = os.path.join(run, f"rank{rank}.pt.trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self.trace = profile_step.load(self._prof)
        self.summary = profile_step.summary(self.trace, wall_ms=wall_ms)
        self.summary["export_s"] = time.perf_counter() - t0
        with open(os.path.join(run, f"rank{rank}.summary.json"), "w") as f:
            json.dump(self.summary, f)
        self._prof = None
        log.info("profiled steps [%d, %d): %s; device busy %.3f ms of %.3f ms; trace %s",
                 self.start, self.stop, "cuda" if self._cuda else "cpu",
                 self.summary["busy_ms"], wall_ms, self.trace_path)
        if self._cuda and self.summary["busy_ms"] <= 0:
            raise RuntimeError(f"the profiled window recorded no device time ({self.trace_path})")


def scalars(metrics: dict[str, Any]) -> dict[str, float]:
    """The scalar entries of ``metrics`` as host floats."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                out[k] = float(v)
        elif isinstance(v, (int, float)):
            out[k] = float(v)
    return out
