"""MNIST MLP example of the port: the twin of ``examples/mnist_mlp.py``
(W1, the reference's SyncReplicasOptimizer workload), with the JAX CLI's
flag names and defaults: its sync path (data parallel over the ranks of
``TF_CONFIG``, each its strided share of the global batch), or its PS
emulation.

The MLP (``--hidden_units``, a comma list) from the JAX init's weights,
plain SGD at ``--learning_rate``, MNIST from ``--data_dir/mnist.npz`` or
the synthetic splits, evaluation on the test split and the ``FINAL ...
test_accuracy=`` line at the end.  Runs on the card unless
``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp \\
        --batch_size=512 --train_steps=2000

``--ps_emulation`` runs W1 as the reference ran it, SyncReplicasOptimizer's
token-gated accumulate/drop-stale/chief-apply, and ``--sync_replicas=false``
the async apply path, both on the in-process PS emulation
(``train/ps_experiment.py``: one worker thread per ``--worker_hosts``
entry, at least 2, each on its own data stream at seed ``--seed + w``,
``--batch_size`` split between them; gradients on the device, parameters
on the host, the port's native accumulator and queues between them)::

    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp \
        --ps_emulation --worker_hosts=a:1,b:1 --train_steps=200

The reference's own launch, one process per task, runs W1 across real
processes over the port's socket PS service (``train/ps_experiment.py::
run_ps_cluster_task``): a PS task (host-only), the chief and the workers
(on the card unless ``--device=cpu``), each with its ``--task_index``::

    ARGS="--ps_emulation --ps_hosts=127.0.0.1:2222 --worker_hosts=a:1,b:1 --train_steps=200"
    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp $ARGS --job_name=ps &
    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp $ARGS --job_name=chief &
    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp $ARGS --job_name=worker --task_index=0 &
    python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp $ARGS --job_name=worker --task_index=1

The chief prints ``CHIEF_PLATFORM=`` and ``FINAL ... mode=sync_replicas_cluster
workers=2 ...``; ``--ps_tasks=0`` has the chief host the service instead
of a PS task.

The parameters may live on N shards of 2 replicas each: ``--ps_hosts``
lists shards x 2 entries, replica-major (the primaries, then the backups;
task i serves shard i % N), and a client whose primary dies fails over to
the backup without a chief reseed.  A live reshard to M shards starts M
joiner PS tasks, each with ``--ps_reshard_to=V:<M hosts>`` (V above
``--ps_layout_version``) and its ``--task_index``; the chief adopts the new
layout between two applies and every worker follows.  A serve replica
hot-tracks the run's parameters and answers predicts of
``{"image": [N, 784]}``::

    H="127.0.0.1"
    ARGS="--ps_emulation --ps_shards=2 --ps_replicas=2 --ps_layout_version=1 \
      --ps_hosts=$H:2222,$H:2223,$H:2224,$H:2225 --worker_hosts=a:1,b:1"
    for i in 0 1 2 3; do python -m ...mnist_mlp $ARGS --job_name=ps --task_index=$i & done
    python -m ...mnist_mlp $ARGS --job_name=serve --serve_hosts=$H:7200 &
    # ... the chief and the workers as above, then, while they train:
    for j in 0 1 2; do python -m ...mnist_mlp $ARGS --job_name=ps --task_index=$j \
      --ps_reshard_to=2:$H:2230,$H:2231,$H:2232 & done

``--job_name=ps`` without a PS-emulation mode prints and exits 0, and the
other TF-1 cluster flags are accepted and mapped (``utils/flags.py``).
"""

from __future__ import annotations

import argparse
import sys

from ..data import datasets
from ..data.pipeline import InMemoryPipeline
from ..models import mlp
from ..train import Experiment, optim, ps_experiment
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


def run_training(args, *, extra_hooks=()):
    """Data -> Experiment -> run -> test-split eval -> FINAL line.  Returns
    the finished Experiment, with its data as ``exp.source`` and the eval's
    metrics as ``exp.test_metrics``.  Under ``--ps_emulation`` or
    ``--sync_replicas=false``, the PS emulation instead: returns its
    trainer (``trainer.metrics`` the eval's; None from a PS or worker task
    of a cross-process launch), and takes no hooks."""
    ds = datasets.mnist(args.data_dir, seed=args.seed)
    cfg = mlp.Config(hidden=tuple(args.hidden_units))
    if not args.sync_replicas or args.ps_emulation:
        if extra_hooks:
            raise ValueError("the PS emulation takes no training hooks")
        trainer = ps_experiment.run_ps_emulation(
            init_fn=lambda seed: mlp.init_numpy(cfg, seed),
            loss_fn=mlp.loss_fn(cfg),
            optimizer=optim.SGD(args.learning_rate),
            batches_for_worker=lambda w, bs, nw: InMemoryPipeline(
                ds.train, batch_size=bs, seed=args.seed + w, process_index=0, process_count=1),
            FLAGS=args,
            mode="sync_replicas" if args.sync_replicas else "async",
            eval_fn=ps_experiment.array_eval_fn(
                lambda p, b: mlp.apply(cfg, p, b["image"]), ds.test, args.batch_size,
                device=args.device),
            # The row-wise apply a --job_name=serve replica serves.
            predict_fn=lambda p, b: mlp.apply(cfg, p, b["image"]),
        )
        if trainer is not None:
            trainer.source = ds
        return trainer
    exp = Experiment(
        init_fn=lambda seed: mlp.init_numpy(cfg, seed),
        loss_fn=mlp.loss_fn(cfg),
        optimizer=optim.SGD(args.learning_rate),
        flags=args,
        extra_hooks=extra_hooks,
    )
    exp.source = ds
    exp.run(InMemoryPipeline(ds.train, batch_size=args.batch_size, seed=args.seed,
                             process_index=exp.mesh.data_index,
                             process_count=exp.mesh.shape["data"],
                             microbatches=args.grad_accum))
    exp.test_metrics = exp.evaluate(ds.test)
    exp.finish(test_accuracy=exp.test_metrics.get("accuracy", 0.0))
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
