"""TrainSession: the port of
``distributed_tensorflow_examples_tpu/train/loop.py``.

Runs ``state, metrics = step_fn(state, batch)`` until a hook requests
stop: hook dispatch around every step, auto-resume from the newest
checkpoint before the first step, and a final ``end`` for every hook.
Under data parallelism every rank resumes from the same checkpoint, and
before the first step the ranks prove that they hold the same
parameters (``state.check_replicas_equal``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable, Sequence

from ..parallel import collectives
from .hooks import Hook
from .state import TrainState, check_replicas_equal

log = logging.getLogger("dtx.loop")


class TrainSession:
    """``session.run(batches)``, or step at a time via ``run_step``."""

    def __init__(
        self,
        step_fn: Callable,
        state: TrainState,
        *,
        hooks: Sequence[Hook] = (),
        checkpoint_manager=None,
        steps_per_call: int = 1,
    ):
        self.step_fn = step_fn
        self.state = state
        self.hooks = list(hooks)
        self.ckpt = checkpoint_manager
        self.steps_per_call = steps_per_call
        self._stop_reason: str | None = None
        self.records: dict[str, Any] = {}
        self.last_metrics: dict[str, Any] = {}
        self._host_step = int(state.step)

    def should_stop(self) -> bool:
        return self._stop_reason is not None

    def request_stop(self, reason: str = "") -> None:
        if self._stop_reason is None:
            self._stop_reason = reason or "requested"

    @property
    def step(self) -> int:
        return self._host_step

    def record(self, **kv) -> None:
        """Hooks publish summary values here (e.g. steps/sec) for callers."""
        self.records.update({k: v for k, v in kv.items() if v is not None})

    def _begin(self):
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.state)
            if restored is not None:
                self.state = restored
                self._host_step = int(restored.step)
                self.record(resumed_at=self._host_step)
                log.info("auto-resumed at step %d", self.step)
        if collectives.axis_size() > 1:
            digest = check_replicas_equal(self.state.params)
            log.info("replicas equal at step %d: params sha256 %s", self.step, digest[:16])
        for h in self.hooks:
            h.begin(self)

    def _end(self):
        for h in self.hooks:
            h.end(self)

    def run_step(self, batch) -> dict[str, Any]:
        for h in self.hooks:
            h.before_step(self)
        self.state, metrics = self.step_fn(self.state, batch)
        self._host_step += self.steps_per_call
        self.last_metrics = metrics
        for h in self.hooks:
            h.after_step(self, metrics)
        return metrics

    def run(self, batches: Iterable) -> TrainState:
        """Full managed run: begin (restore + hooks), loop, end (final save)."""
        self._begin()
        try:
            if not self.should_stop():
                for batch in batches:
                    self.run_step(batch)
                    if self.should_stop():
                        break
                else:
                    self.request_stop("data exhausted")
        finally:
            self._end()
        log.info("training stopped: %s", self._stop_reason)
        return self.state
