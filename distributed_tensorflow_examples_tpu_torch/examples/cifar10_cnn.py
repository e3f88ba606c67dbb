"""CIFAR-10 CNN example of the port: the twin of ``examples/cifar10_cnn.py``
(W2), with the JAX CLI's flag names and defaults: its sync path on one
device, or its PS emulation.

The CNN from the JAX init's weights, plain SGD at ``--learning_rate``,
CIFAR-10 from ``--data_dir`` (``cifar10.npz`` or ``cifar-10-batches-py/``)
or the synthetic splits through ``data.streams`` (the JAX CLI's source
resolution), evaluation on the test split and the ``FINAL ...
test_accuracy=`` line.  Runs on the card unless ``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn \\
        --batch_size=256 --train_steps=1000

``--sync_replicas=false`` runs W2 as the reference ran it, async SGD: each
worker's gradient applied alone, in arrival order, to the host-hosted
parameters (``--max_staleness`` bounds how old it may be), and
``--ps_emulation`` the token-gated sync mode, both on the in-process PS
emulation (``train/ps_experiment.py``) with the JAX CLI's warmup, a
linear ramp from ``--learning_rate / 10`` over ``--warmup_steps`` applies
(20 when 0); ``--deterministic`` applies on a fixed round-robin
interleave, reproducible bit for bit::

    python -m distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn \
        --sync_replicas=false --worker_hosts=a:1,b:1 --max_staleness=4

``--job_name=ps`` prints and exits 0 and the TF-1 cluster flags are
mapped (``utils/flags.py``); a cross-process PS task waits for the port's
PS transport (A9b); streamed shard directories and ``dsvc://`` sources
for its data planes (A10).
"""

from __future__ import annotations

import argparse
import sys

from ..data import datasets, streams
from ..models import cnn
from ..train import Experiment, optim, ps_experiment
from ..utils import flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=128, default_steps=1000)
    flags.add_legacy_cluster_flags(p)
    return p


def run_training(args, *, extra_hooks=()):
    """Data -> Experiment -> run -> test-split eval -> FINAL line.  Returns
    the finished Experiment, with its data as ``exp.source`` and the eval's
    metrics as ``exp.test_metrics``.  Under ``--sync_replicas=false`` or
    ``--ps_emulation``, the PS emulation instead: returns its
    ``AsyncPSTrainer`` (``trainer.metrics`` the eval's), and takes no
    hooks."""
    src = streams.resolve_image_source(
        args.data_dir,
        fallback=lambda: datasets.cifar10(args.data_dir, seed=args.seed),
        name="cifar10",
    )
    cfg = cnn.Config()
    if not args.sync_replicas or args.ps_emulation:
        if extra_hooks:
            raise ValueError("the PS emulation takes no training hooks")
        # The JAX CLI's warmup (default 20 applies): the first async applies
        # land on stale params at full magnitude; a linear ramp keeps them
        # from collapsing the relu stack onto the uniform plateau.
        warmup = args.warmup_steps if args.warmup_steps > 0 else 20
        lr = optim.linear_schedule(args.learning_rate / 10.0, args.learning_rate, warmup)
        trainer = ps_experiment.run_ps_emulation(
            init_fn=lambda seed: cnn.init_numpy(cfg, seed),
            loss_fn=cnn.loss_fn(cfg),
            optimizer=optim.SGD(lr),
            batches_for_worker=lambda w, bs, nw: streams.train_iter(
                src, batch_size=bs, seed=args.seed, worker=w, n_workers=nw),
            FLAGS=args,
            mode="sync_replicas" if args.sync_replicas else "async",
            eval_fn=ps_experiment.array_eval_fn(
                lambda p, b: cnn.apply(cfg, p, b["image"]), src.ds.test, args.batch_size,
                device=args.device),
        )
        trainer.source = src
        return trainer
    exp = Experiment(
        init_fn=lambda seed: cnn.init_numpy(cfg, seed),
        loss_fn=cnn.loss_fn(cfg),
        optimizer=optim.SGD(args.learning_rate),
        flags=args,
        extra_hooks=extra_hooks,
    )
    exp.source = src
    exp.run(streams.train_iter(src, batch_size=args.batch_size, seed=args.seed))
    exp.test_metrics = exp.evaluate(src.ds.test)
    exp.finish(test_accuracy=exp.test_metrics.get("accuracy", 0.0))
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
