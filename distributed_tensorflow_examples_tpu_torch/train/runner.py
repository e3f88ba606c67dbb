"""Experiment runner: the port of
``distributed_tensorflow_examples_tpu/train/runner.py``.

flags -> process world -> mesh -> state on the rank's device -> train
step -> hooks (stop, step counter, logging, summary, checkpoint,
preemption, profiler) -> ``TrainSession``, plus the host-to-device
infeed, the full-split ``evaluate`` and the ``FINAL`` line the scrapers
read.

The world comes from ``parallel.dist.initialize`` (``TF_CONFIG`` or
nothing: one process); a ``ps``/``evaluator`` task prints and exits 0.
``--mesh`` must tile the world with its ``slice``, ``data``, ``pipe``,
``expert``, ``seq`` and ``model`` axes; the state is laid
out by the model's rule table (``rules``,
``train/state.py::create_sharded_state``), with the optimizer slots
ZeRO-1 sharded under ``--zero_opt``.  ``--profile`` with a log dir adds
a ``ProfilerHook`` window (steps 10-15), as the JAX runner does.  On a
world of 2 or more, ``--watchdog`` starts the peer watchdog; the metrics
writer and the ``FINAL`` line are the chief's; ``evaluate`` splits each
batch over the ranks and averages.  ``--deterministic`` turns on
``utils.determinism``, as the JAX ``Experiment`` does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Iterable

from ..data import pipeline as pipeline_lib
from ..parallel import collectives, dist, sharding
from ..parallel.mesh import MeshSpec, build_mesh
from ..utils import determinism
from ..utils import device as device_lib
from ..utils import threefry
from ..utils.metrics import MetricsWriter
from . import hooks as hooks_lib
from .checkpoint import CheckpointManager
from .loop import TrainSession
from .preemption import PreemptionCheckpointHook
from .state import create_sharded_state
from .step import build_eval_step, build_train_step

log = logging.getLogger("dtx.runner")


class Experiment:
    """One configured training run on this rank's device.

    ``init_fn(seed) -> params | (params, model_state)`` (numpy or tensor
    leaves), the framework-standard ``loss_fn`` (or ``loss_fn_factory(mesh)``
    for a loss that needs the mesh, as the JAX ``Experiment`` takes it),
    and an optimizer such as ``train.optim.ClippedAdamW`` or ``SGD``.
    ``flags`` carries the JAX CLI's names: seed, mesh, unroll, grad_accum,
    log_dir, train_steps, log_every_steps, checkpoint_every_steps,
    batch_size (the global batch; and optionally device, watchdog,
    watchdog_grace_secs).  ``mesh`` defaults to the one ``--mesh``
    describes over the world.  ``rules``: the model's sharding rule table
    (its ``SHARDING_RULES``), as the JAX ``Experiment`` takes it.
    ``row_sharded_state``: the model state is split by rows over the data
    ranks (the LSTM's carry), which the checkpoint gathers.
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
        row_sharded_state: bool = False,
        rules=(),
    ):
        self.flags = flags
        if getattr(flags, "deterministic", False):
            determinism.enable()
        requested = device or getattr(flags, "device", None)
        cluster = dist.initialize(device=requested)
        if cluster.is_ps_task:
            print(f"TF_CONFIG task type {cluster.task_type!r}: synchronous data "
                  "parallelism needs no parameter servers; exiting 0.", flush=True)
            raise SystemExit(0)
        self.device = dist.device() if dist.is_initialized() else device_lib.resolve(requested)
        if getattr(flags, "watchdog", True):
            dist.start_watchdog(grace_s=getattr(flags, "watchdog_grace_secs", 10.0))
        self.mesh = (
            mesh if mesh is not None
            else build_mesh(MeshSpec.parse(getattr(flags, "mesh", "")), self.device)
        )
        log.info("mesh: %s over %d rank(s); this rank %d (slice %d, data %d, pipe %d, "
                 "expert %d, seq %d, model %d) on %s", self.mesh.shape, self.mesh.size,
                 dist.process_index(), self.mesh.slice_index, self.mesh.data_index,
                 self.mesh.pipe_index, self.mesh.expert_index, self.mesh.seq_index,
                 self.mesh.model_index, self.device)
        if loss_fn is None:
            if loss_fn_factory is None:
                raise ValueError("pass loss_fn or loss_fn_factory")
            loss_fn = loss_fn_factory(self.mesh)
        self._loss_fn = loss_fn
        self.optimizer = optimizer
        with self.mesh.axes():  # an init_fn may read the data axis (the LSTM's carry)
            self.state, self.specs = create_sharded_state(
                init_fn, optimizer, flags.seed, self.device, mesh=self.mesh, rules=rules,
                zero_opt_sharding=getattr(flags, "zero_opt", False))
        self.step_fn = build_train_step(
            loss_fn, optimizer, mesh=self.mesh, unroll=flags.unroll,
            grad_accum=getattr(flags, "grad_accum", 1),
        )
        self.log_dir = flags.log_dir or None
        self.writer = MetricsWriter(self.log_dir if dist.is_chief() else None)
        self.ckpt = None
        if self.log_dir:
            self.ckpt = CheckpointManager(os.path.join(self.log_dir, "ckpt"),
                                          row_sharded_state=row_sharded_state,
                                          param_specs=self.specs["params"],
                                          state_specs=self.specs["model_state"])
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
        if getattr(flags, "profile", False) and self.log_dir:
            self.hooks.append(hooks_lib.ProfilerHook(self.log_dir))
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
        """Managed run over the given batch iterator, under the mesh's
        axes (the streams, the checkpoint and the hooks read them); returns
        final state."""
        with self.mesh.axes():
            final = self.session.run(self.batches(local_iter))
        self.state = final
        return final

    def evaluate(
        self, arrays: dict, *, eval_fn: Callable | None = None,
        batch_size: int | None = None,
    ) -> dict[str, float]:
        """Full-split eval of numpy ``arrays``: metrics averaged over the
        complete batches of ``batch_size`` (default ``--batch_size``)
        rounded down to a multiple of the row shards (the ragged tail is
        left out).  Each rank evaluates its rows of every batch and the
        ranks' means are averaged: the batch's.  ``eval_fn(params,
        model_state, batch) -> metrics``; by default the loss's own
        metrics, under the JAX ``evaluate``'s key, ``key(0)``."""
        if eval_fn is None:
            loss_fn = self._loss_fn

            def eval_fn(params, mstate, batch):
                return loss_fn(params, mstate, batch, threefry.key(0))[1][1]

        step = build_eval_step(eval_fn)
        n = len(next(iter(arrays.values())))
        dp = self.mesh.row_shards
        ebs = min(batch_size or self.flags.batch_size, n // dp * dp)
        ebs = (ebs // dp) * dp
        if ebs <= 0:
            return {}
        rows = sharding.rank_rows(ebs, self.mesh.row_index, dp)
        sums: dict[str, float] = {}
        count = 0
        for i in range(0, (n // ebs) * ebs, ebs):
            local = {k: v[i : i + ebs][rows] for k, v in arrays.items()}
            with self.mesh.axes():
                metrics = step(self.state, pipeline_lib.to_device(local, self.device))
                if dp > 1:
                    metrics = {k: collectives.pmean(v.detach().float(), "batch", tag="eval")
                               for k, v in metrics.items()}
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / count for k, v in sums.items()}

    def finish(self, **final_metrics) -> None:
        """The chief prints the FINAL line (the contract tests/bench
        scrape; throughput of the global batch); every rank closes and
        leaves the watchdog cleanly."""
        if dist.is_chief():
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
        dist.stop_watchdog()
        dist.barrier("finish")
