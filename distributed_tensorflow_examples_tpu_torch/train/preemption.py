"""Preemption-aware checkpointing: the port of
``distributed_tensorflow_examples_tpu/train/preemption.py``.

A SIGTERM flips a flag; the loop, at its only safe point (between
steps), saves a checkpoint and requests a clean stop.  Resume is the
ordinary auto-restore of ``TrainSession``.

Under data parallelism a save is a collective (the chief writes, a
barrier follows), and a signal may reach one rank only, or the ranks at
different steps.  So after every step the ranks sum their flags (one
all-reduce of one number): all of them save and stop at the first step
after which any rank holds the flag.
"""

from __future__ import annotations

import logging
import signal
import threading

import torch

from ..parallel import collectives
from .hooks import Hook
from .state import leaves

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

    def _any_rank_preempted(self, loop) -> bool:
        flag = self._flag.is_set()
        world = collectives.world()  # every rank, whatever the mesh's axes
        if world is None or world.size == 1:
            return flag
        device = leaves(loop.state.params)[0].device  # the rank's card under nccl
        t = torch.tensor([float(flag)], device=device)
        with collectives.use_group(world):
            collectives.all_reduce_sum_(t, tag="preempt")
        if t.item() > 0:
            self._flag.set()
        return self._flag.is_set()

    def after_step(self, loop, metrics):
        if self._any_rank_preempted(loop) and not loop.should_stop():
            self.mgr.save(loop.step, loop.state)
            self.mgr.wait()
            loop.request_stop(f"preempted at step {loop.step} (checkpoint saved)")

    def end(self, loop):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
