"""CIFAR-10 CNN example of the port: the twin of ``examples/cifar10_cnn.py``
(W2), its sync path on one device, with the JAX CLI's flag names and
defaults.

The CNN from the JAX init's weights, plain SGD at ``--learning_rate``,
CIFAR-10 from ``--data_dir`` (``cifar10.npz`` or ``cifar-10-batches-py/``)
or the synthetic splits through ``data.streams`` (the JAX CLI's source
resolution), evaluation on the test split and the ``FINAL ...
test_accuracy=`` line.  Runs on the card unless ``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn \\
        --batch_size=256 --train_steps=1000

``--job_name=ps`` prints and exits 0 and the TF-1 cluster flags are
mapped (``utils/flags.py``).  The reference's async PS mode
(``--sync_replicas=false``, the workload's own shape) and
``--ps_emulation`` wait for the port's PS plane (A9); streamed shard
directories and ``dsvc://`` sources for its data planes (A10).
"""

from __future__ import annotations

import argparse
import sys

from ..data import datasets, streams
from ..models import cnn
from ..train import Experiment, optim
from ..utils import flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=128, default_steps=1000)
    flags.add_legacy_cluster_flags(p)
    return p


def run_training(args, *, extra_hooks=()) -> Experiment:
    """Data -> Experiment -> run -> test-split eval -> FINAL line.  Returns
    the finished Experiment, with its data as ``exp.source`` and the eval's
    metrics as ``exp.test_metrics``."""
    src = streams.resolve_image_source(
        args.data_dir,
        fallback=lambda: datasets.cifar10(args.data_dir, seed=args.seed),
        name="cifar10",
    )
    cfg = cnn.Config()
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
