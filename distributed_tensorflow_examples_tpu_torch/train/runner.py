"""Experiment runner on one device: the port of
``distributed_tensorflow_examples_tpu/train/runner.py``.

flags -> state on the device -> train step -> hooks (stop, step counter,
logging, summary, checkpoint, preemption) -> ``TrainSession``, plus the
host-to-device infeed and the ``FINAL`` line the scrapers read.  A mesh
beyond one device (``--mesh`` other than empty or ``data=1``) waits for
the port's multi-device items (A5 data parallel, A8 model parallel).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable

from ..data import pipeline as pipeline_lib
from ..utils import device as device_lib
from ..utils.metrics import MetricsWriter
from . import hooks as hooks_lib
from .checkpoint import CheckpointManager
from .loop import TrainSession
from .preemption import PreemptionCheckpointHook
from .state import create_state
from .step import build_train_step


def check_single_device_mesh(mesh: str) -> None:
    """Accept the meshes that mean one device: '' or data=1."""
    spec = (mesh or "").replace(" ", "")
    if spec in ("", "data=1"):
        return
    raise NotImplementedError(
        f"--mesh={mesh!r}: the port trains on one device so far; data "
        "parallel waits for its multi-device item (A5) and model-parallel "
        "axes for its model-parallel slice (A8)"
    )


class Experiment:
    """One configured training run on one device.

    ``init_fn(seed) -> params | (params, model_state)`` (numpy or tensor
    leaves), the framework-standard ``loss_fn``, and an optimizer such as
    ``train.optim.ClippedAdamW``.  ``flags`` carries the JAX CLI's names:
    seed, mesh, unroll, grad_accum, log_dir, train_steps,
    log_every_steps, checkpoint_every_steps, batch_size (and optionally
    device).
    """

    def __init__(
        self,
        *,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer,
        flags,
        device=None,
        extra_hooks: Iterable[hooks_lib.Hook] = (),
    ):
        check_single_device_mesh(getattr(flags, "mesh", ""))
        self.flags = flags
        self.device = device_lib.resolve(device or getattr(flags, "device", None))
        self.optimizer = optimizer
        self.state = create_state(init_fn, optimizer, flags.seed, self.device)
        self.step_fn = build_train_step(
            loss_fn, optimizer, unroll=flags.unroll,
            grad_accum=getattr(flags, "grad_accum", 1),
        )
        self.log_dir = flags.log_dir or None
        self.writer = MetricsWriter(self.log_dir)
        self.ckpt = None
        if self.log_dir:
            self.ckpt = CheckpointManager(os.path.join(self.log_dir, "ckpt"))
        self.hooks = [
            hooks_lib.StopAtStepHook(flags.train_steps),
            hooks_lib.StepCounterHook(
                every_steps=flags.log_every_steps, batch_size=flags.batch_size
            ),
            hooks_lib.LoggingHook(every_steps=flags.log_every_steps),
            hooks_lib.SummaryHook(self.writer, every_steps=flags.log_every_steps),
        ]
        if self.ckpt is not None:
            self.hooks.append(
                hooks_lib.CheckpointHook(
                    self.ckpt, every_steps=flags.checkpoint_every_steps
                )
            )
            self.hooks.append(PreemptionCheckpointHook(self.ckpt))
        self.hooks.extend(extra_hooks)
        self.session = TrainSession(
            self.step_fn,
            self.state,
            hooks=self.hooks,
            checkpoint_manager=self.ckpt,
            steps_per_call=flags.unroll,
        )

    def batches(self, local_iter):
        """Host batches -> prefetched device batches (stacked for unroll
        when configured)."""
        it = iter(local_iter)
        if self.flags.unroll > 1:
            it = pipeline_lib.stack_for_unroll(it, self.flags.unroll)
        return pipeline_lib.prefetch_to_device(it, self.device)

    def run(self, local_iter) -> Any:
        """Managed run over the given batch iterator; returns final state."""
        final = self.session.run(self.batches(local_iter))
        self.state = final
        return final

    def finish(self, **final_metrics) -> None:
        """Print the FINAL line (the contract tests/bench scrape) and close."""
        parts = [f"FINAL step={self.session.step}"]
        sps = self.session.records.get("steps_per_sec") or 0.0
        parts.append(f"steps_per_sec={sps:.1f}")
        eps = self.session.records.get("examples_per_sec_per_chip") or 0.0
        parts.append(f"examples_per_sec_per_chip={eps:.0f}")
        for k, v in final_metrics.items():
            parts.append(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
        print(" ".join(parts), flush=True)
        self.writer.close()
        if self.ckpt is not None:
            self.ckpt.close()
