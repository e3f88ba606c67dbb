"""Hooks around the host-side train loop: the port of
``distributed_tensorflow_examples_tpu/train/hooks.py``.

- ``StopAtStepHook``  — stop at a global step.
- ``StepCounterHook`` — steps/sec and examples/sec/chip.
- ``LoggingHook``     — periodic metric logging.
- ``CheckpointHook``  — periodic and final save via ``train.checkpoint``.
- ``SummaryHook``     — metric series to ``utils.metrics.MetricsWriter``.
- ``ProfilerHook``    — waits for the port's tools item (A12).

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
    """The JAX package's trace window; the port's profiler twin is the
    tools item of its roadmap (A12)."""

    def __init__(self, log_dir: str):
        raise NotImplementedError(
            "ProfilerHook waits for the port's tools item (A12: a "
            "torch.profiler twin of tools/profile_step.py)"
        )


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
