"""Experiment runner on one device: the port of
``distributed_tensorflow_examples_tpu/train/runner.py``.

flags -> mesh -> state on the device -> train step -> hooks (stop, step
counter, logging, summary, checkpoint, preemption) -> ``TrainSession``,
plus the host-to-device infeed, the full-split ``evaluate`` and the
``FINAL`` line the scrapers read.  A mesh beyond one device (``--mesh``
other than empty or ``data=1``) waits for the port's multi-device items
(A5 data parallel, A8 model parallel): ``parallel.mesh.build_mesh``
raises; so do ``--zero_opt`` (A8) and ``--profile`` (A12), through
``utils.flags.check_training_flags``; ``--deterministic`` turns on
``utils.determinism``, as the JAX ``Experiment`` does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable

from ..data import pipeline as pipeline_lib
from ..parallel.mesh import MeshSpec, build_mesh
from ..utils import determinism
from ..utils import device as device_lib
from ..utils import flags as flags_lib
from ..utils import threefry
from ..utils.metrics import MetricsWriter
from . import hooks as hooks_lib
from .checkpoint import CheckpointManager
from .loop import TrainSession
from .preemption import PreemptionCheckpointHook
from .state import create_state
from .step import build_eval_step, build_train_step


class Experiment:
    """One configured training run on one device.

    ``init_fn(seed) -> params | (params, model_state)`` (numpy or tensor
    leaves), the framework-standard ``loss_fn`` (or ``loss_fn_factory(mesh)``
    for a loss that needs the mesh, as the JAX ``Experiment`` takes it),
    and an optimizer such as ``train.optim.ClippedAdamW`` or ``SGD``.
    ``flags`` carries the JAX CLI's names: seed, mesh, unroll, grad_accum,
    log_dir, train_steps, log_every_steps, checkpoint_every_steps,
    batch_size (and optionally device).  ``mesh`` defaults to the one
    ``--mesh`` describes.
    """

    def __init__(
        self,
        *,
        init_fn: Callable,
        loss_fn: Callable | None = None,
        optimizer,
        flags,
        device=None,
        mesh=None,
        extra_hooks: Iterable[hooks_lib.Hook] = (),
        loss_fn_factory: Callable | None = None,
    ):
        self.flags = flags
        flags_lib.check_training_flags(flags)
        if getattr(flags, "deterministic", False):
            determinism.enable()
        self.device = device_lib.resolve(device or getattr(flags, "device", None))
        self.mesh = (
            mesh if mesh is not None
            else build_mesh(MeshSpec.parse(getattr(flags, "mesh", "")), self.device)
        )
        if loss_fn is None:
            if loss_fn_factory is None:
                raise ValueError("pass loss_fn or loss_fn_factory")
            loss_fn = loss_fn_factory(self.mesh)
        self._loss_fn = loss_fn
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

    def evaluate(
        self, arrays: dict, *, eval_fn: Callable | None = None,
        batch_size: int | None = None,
    ) -> dict[str, float]:
        """Full-split eval of numpy ``arrays``: metrics averaged over the
        complete batches of ``batch_size`` (default ``--batch_size``; the
        ragged tail is left out).  ``eval_fn(params, model_state, batch) ->
        metrics``; by default the loss's own metrics, under the JAX
        ``evaluate``'s key, ``key(0)``."""
        if eval_fn is None:
            loss_fn = self._loss_fn

            def eval_fn(params, mstate, batch):
                return loss_fn(params, mstate, batch, threefry.key(0))[1][1]

        step = build_eval_step(eval_fn)
        n = len(next(iter(arrays.values())))
        ebs = min(batch_size or self.flags.batch_size, n)
        if ebs <= 0:
            return {}
        sums: dict[str, float] = {}
        count = 0
        for i in range(0, (n // ebs) * ebs, ebs):
            batch = pipeline_lib.to_device({k: v[i : i + ebs] for k, v in arrays.items()}, self.device)
            for k, v in step(self.state, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / count for k, v in sums.items()}

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
