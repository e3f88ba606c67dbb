"""CLI-level runner for the PS-emulation modes (SURVEY.md D5, section 3.1/3.2):
the port of the thread path of ``distributed_tensorflow_examples_tpu/train/
ps_experiment.py``.

One shared path so every example honors ``--sync_replicas`` uniformly:

- ``--sync_replicas=false``           -> async mode (W2: each worker's
  gradient applies immediately, in arrival order).
- ``--ps_emulation --sync_replicas``  -> token-gated sync_replicas mode (W1:
  accumulate ``--replicas_to_aggregate`` grads, drop stale, chief applies,
  workers proceed on tokens).

Both run on ``parallel.async_ps.AsyncPSTrainer`` (the port's native C++
accumulator / token-queue / gradient-queue services, worker threads
computing gradients on the device) with checkpoint/resume under
``--log_dir/ps_ckpt`` and print the JAX package's FINAL line, field for
field.  ``--deterministic`` selects the fixed round-robin interleave and
turns on ``utils.determinism``.  The reference's one-process-per-task
launch (``--job_name=ps|chief|worker`` with ``--ps_hosts``) is the port's
item A9b and raises here.

Note on model_state: the emulation keeps non-parameter state at its initial
value — the reference's async-PS scripts hosted only *variables* on PS
tasks.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..bridge import params_from_numpy
from ..data.pipeline import to_device
from ..models import layers
from ..utils import device as device_lib

log = logging.getLogger("dtx.ps_experiment")


def worker_count(FLAGS) -> int:
    """Emulated worker count from the legacy cluster flags (the ONE place
    this is computed — CLIs that shard data per worker must use it too)."""
    return max(2, len(FLAGS.worker_hosts.split(",")) if FLAGS.worker_hosts else 2)


def run_ps_emulation(
    *,
    init_fn: Callable,
    loss_fn: Callable,
    optimizer,
    batches_for_worker: Callable[[int, int, int], Iterator[dict]],
    FLAGS,
    mode: str,
    eval_fn: Callable[[Any], dict[str, float]] | None = None,
    model_state: Any = None,
):
    """Run W1/W2 PS-emulation training on ``FLAGS.device`` (the card unless
    ``cpu``); returns the trainer, with the final params as
    ``trainer.params`` and ``eval_fn``'s metrics as ``trainer.metrics``.

    ``init_fn(seed) -> params | (params, model_state)``;
    ``batches_for_worker(worker_id, local_batch_size, n_workers)`` yields
    that worker's local numpy batches (its data shard; the count is passed
    so data sharding can never diverge from the thread count);
    ``eval_fn(params)`` computes final metrics for the FINAL line.
    """
    from ..parallel.async_ps import AsyncPSTrainer
    from ..utils import determinism
    from ..utils.flags import is_cross_process_ps

    if is_cross_process_ps(FLAGS):
        raise NotImplementedError(
            "a cross-process PS task role (--job_name with --ps_hosts under PS "
            "emulation) waits for the port's PS transport (A9b)"
        )
    n_workers = worker_count(FLAGS)
    r2a = getattr(FLAGS, "replicas_to_aggregate", 0) or n_workers
    if getattr(FLAGS, "grad_accum", 1) > 1:
        log.warning(
            "--grad_accum=%d is ignored in PS-emulation mode (per-worker "
            "gradients apply individually; accumulation is a mesh-trainer "
            "feature)", FLAGS.grad_accum,
        )
    log.info(
        "PS emulation mode=%s: %d workers%s (native accumulator/token "
        "services; semantics notes in parallel.async_ps)",
        mode,
        n_workers,
        f", replicas_to_aggregate={r2a}" if mode == "sync_replicas" else "",
    )
    if getattr(FLAGS, "deterministic", False):
        determinism.enable()
    acfg = _ps_cfg(FLAGS, mode, n_workers)
    params = init_fn(FLAGS.seed)
    if isinstance(params, tuple):  # init_fn returning (params, model_state)
        params, model_state = params
    trainer = AsyncPSTrainer(
        acfg, loss_fn, optimizer, params, model_state=model_state,
        seed=FLAGS.seed, device=getattr(FLAGS, "device", None),
    )
    local_bs = max(1, FLAGS.batch_size // n_workers)
    t0 = time.perf_counter()
    final_params = trainer.run(
        [iter(batches_for_worker(w, local_bs, n_workers)) for w in range(n_workers)]
    )
    dt = time.perf_counter() - t0  # training window only (eval excluded)

    trainer.metrics = eval_fn(final_params) if eval_fn is not None else {}
    sps = trainer.global_step / dt if dt > 0 else 0.0
    losses = [l for (_, _, l) in trainer.history] or [float("nan")]
    _print_final(
        step=trainer.global_step, dt=dt, mode=mode, metrics=trainer.metrics,
        # Sync mode consumes replicas_to_aggregate worker batches per
        # applied step — count them all, over the run's one device.
        eps_per_chip=sps * local_bs * (r2a if mode == "sync_replicas" else 1),
        extra={
            "stale_dropped": trainer.total_dropped,
            "first_loss": f"{losses[0]:.4f}",
            "last_loss": f"{losses[-1]:.4f}",
        },
    )
    return trainer


def _print_final(
    *, step: int, dt: float, mode: str, metrics: dict, extra: dict, eps_per_chip: float,
):
    """The scrapable FINAL line of the PS paths — the JAX package's fields,
    in its order."""
    sps = step / dt if dt > 0 else 0.0
    parts = [
        f"FINAL step={step}",
        f"steps_per_sec={sps:.1f}",
        f"examples_per_sec_per_chip={eps_per_chip:.0f}",
        f"mode={mode}",
    ]
    for k, v in extra.items():
        parts.append(f"{k}={v}")
    for k, v in metrics.items():
        parts.append(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
    print(" ".join(parts), flush=True)


def _ps_cfg(FLAGS, mode: str, n_workers: int):
    from ..parallel.async_ps import AsyncPSConfig

    r2a = getattr(FLAGS, "replicas_to_aggregate", 0) or n_workers
    return AsyncPSConfig(
        num_workers=n_workers,
        mode=mode,
        replicas_to_aggregate=r2a if mode == "sync_replicas" else None,
        max_staleness=getattr(FLAGS, "max_staleness", None) or None,
        # --deterministic: async applies keep their stale-params semantics
        # but run on the fixed round-robin schedule (reproducible runs).
        fixed_interleave=bool(getattr(FLAGS, "deterministic", False)),
        train_steps=FLAGS.train_steps,
        ckpt_dir=os.path.join(FLAGS.log_dir, "ps_ckpt") if FLAGS.log_dir else None,
        checkpoint_every=FLAGS.checkpoint_every_steps,
    )


def array_eval_fn(apply_logits: Callable, test: dict[str, np.ndarray], batch_size: int,
                  device=None):
    """Standard accuracy eval over array test splits for the FINAL line: the
    mean over the complete batches of ``min(batch_size, n)`` rows, on
    ``device`` (the card unless ``cpu``)."""

    def eval_fn(params):
        dev = device_lib.resolve(device)
        p = params_from_numpy(params, dev)
        n = len(test["label"])
        ebs = min(batch_size, n)
        with torch.no_grad():
            accs = [
                float(layers.accuracy(apply_logits(p, b), b["label"]))
                for b in (to_device({k: v[i : i + ebs] for k, v in test.items()}, dev)
                          for i in range(0, (n // ebs) * ebs, ebs))
            ]
        return {"test_accuracy": float(np.mean(accs))}

    return eval_fn

