"""MNIST MLP example of the port: the twin of ``examples/mnist_mlp.py``
(W1, the reference's SyncReplicasOptimizer workload), its sync path on
one device, with the JAX CLI's flag names and defaults.

The MLP (``--hidden_units``, a comma list) from the JAX init's weights,
plain SGD at ``--learning_rate``, MNIST from ``--data_dir/mnist.npz`` or
the synthetic splits, evaluation on the test split and the ``FINAL ...
test_accuracy=`` line at the end.  Runs on the card unless
``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp \\
        --batch_size=512 --train_steps=2000

``--job_name=ps`` prints and exits 0, and the other TF-1 cluster flags are
accepted and mapped (``utils/flags.py``); the PS-emulation modes
(``--ps_emulation``, ``--sync_replicas=false``) wait for the port's PS
plane (A9).
"""

from __future__ import annotations

import argparse
import sys

from ..data import datasets
from ..data.pipeline import InMemoryPipeline
from ..models import mlp
from ..train import Experiment, optim
from ..utils import flags


def _int_list(text: str) -> tuple[int, ...]:
    return tuple(int(h) for h in text.split(",") if h.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=128, default_steps=1000)
    flags.add_legacy_cluster_flags(p)
    p.add_argument("--hidden_units", type=_int_list, default=(128, 128),
                   help="MLP hidden layer widths (comma list).")
    return p


def run_training(args, *, extra_hooks=()) -> Experiment:
    """Data -> Experiment -> run -> test-split eval -> FINAL line.  Returns
    the finished Experiment, with its data as ``exp.source`` and the eval's
    metrics as ``exp.test_metrics``."""
    ds = datasets.mnist(args.data_dir, seed=args.seed)
    cfg = mlp.Config(hidden=tuple(args.hidden_units))
    exp = Experiment(
        init_fn=lambda seed: mlp.init_numpy(cfg, seed),
        loss_fn=mlp.loss_fn(cfg),
        optimizer=optim.SGD(args.learning_rate),
        flags=args,
        extra_hooks=extra_hooks,
    )
    exp.source = ds
    exp.run(InMemoryPipeline(ds.train, batch_size=args.batch_size, seed=args.seed))
    exp.test_metrics = exp.evaluate(ds.test)
    exp.finish(test_accuracy=exp.test_metrics.get("accuracy", 0.0))
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
