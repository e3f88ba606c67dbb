"""Preemption-aware checkpointing: the port of
``distributed_tensorflow_examples_tpu/train/preemption.py``.

A SIGTERM flips a flag; the loop, at its only safe point (between
steps), saves a checkpoint and requests a clean stop.  Resume is the
ordinary auto-restore of ``TrainSession``.
"""

from __future__ import annotations

import logging
import signal
import threading

from .hooks import Hook

log = logging.getLogger("dtx.preemption")


class PreemptionCheckpointHook(Hook):
    """Save-and-stop on SIGTERM.  Installed while the session runs;
    restores the previous signal handlers at end."""

    def __init__(self, manager):
        self.mgr = manager
        self._flag = threading.Event()
        self._prev: dict = {}

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def _handler(self, signum, frame):
        log.warning("received signal %d: will checkpoint and stop", signum)
        self._flag.set()

    def begin(self, loop):
        try:
            self._prev[signal.SIGTERM] = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            # Not the main thread: fall back to manual .trigger().
            log.info("cannot install a SIGTERM handler here")

    def trigger(self) -> None:
        """Manual preemption signal (tests / external watchers)."""
        self._flag.set()

    def after_step(self, loop, metrics):
        if self._flag.is_set() and not loop.should_stop():
            self.mgr.save(loop.step, loop.state)
            self.mgr.wait()
            loop.request_stop(f"preempted at step {loop.step} (checkpoint saved)")

    def end(self, loop):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
