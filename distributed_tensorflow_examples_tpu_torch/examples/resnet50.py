"""ResNet-50 example of the port: the twin of ``examples/resnet50.py`` (W3,
the reference's MirroredStrategy workload), with the JAX CLI's flag names.

SGD with momentum, the stepwise decay at 60% and 80% of the run (x0.1
each), L2 1e-4 on every conv/dense kernel, bf16 compute; an ImageNet-shaped
synthetic dataset (``--synthetic_examples`` train images, 256 test
images); evaluation on the test split and the ``FINAL ... test_accuracy=``
line at the end.  Runs on the card unless ``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.resnet50 \\
        --batch_size=256 --train_steps=500 --image_size=224 --learning_rate=0.1

By default BatchNorm is plain torch, as the JAX example leaves its fused
path off.  :func:`run_training` takes the JAX ``Experiment``'s
``loss_fn_factory``: ``lambda mesh: resnet.loss_fn(cfg, mesh=mesh)`` sends
every BatchNorm through the statistics kernels (``ops/bn.py``).
``--job_name=ps`` prints and exits 0, as the JAX CLI does, and the other
TF-1 cluster flags are accepted and mapped (``utils/flags.py``): the JAX
CLI has no PS branch, so ``--ps_emulation`` and ``--sync_replicas=false``
train as usual, and only a cross-process PS task raises (A9b); ghost-batch BN
(``--bn_ghost_slices``) and streamed ``--data_dir`` sources wait for the
port's items A8 and A10.

On a world of N ranks (the reference's MirroredStrategy; ``TF_CONFIG``,
one process per rank, ``utils/multiprocess.py``) each rank trains on its
strided share of every global batch (``--batch_size / N`` rows), the
gradients mean-all-reduced, BatchNorm synchronised over the ranks (the
plain path's sums, or the fused path's B6/B7 partial sums), and the
chief prints FINAL::

    TF_CONFIG='{"cluster": {"worker": ["localhost:7000", "localhost:7000"]},
                "task": {"type": "worker", "index": 0}}' \
        python -m distributed_tensorflow_examples_tpu_torch.examples.resnet50 ...
"""

from __future__ import annotations

import argparse
import sys

from ..data import datasets, streams
from ..models import layers, resnet
from ..train import Experiment, optim
from ..utils import flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=256, default_steps=1000)
    # The example's own.
    add("--image_size", type=int, default=224, help="Input image resolution.")
    add("--num_classes", type=int, default=1000, help="Label classes.")
    add("--momentum", type=float, default=0.9, help="SGD momentum.")
    add("--synthetic_examples", type=int, default=2048, help="Synthetic train-set size.")
    add("--bn_ghost_slices", type=int, default=0,
        help=">0 scopes BN statistics to slice-local groups (waits for A8).")
    flags.add_legacy_cluster_flags(p)
    return p


def config_from_args(args) -> resnet.Config:
    return resnet.Config(num_classes=args.num_classes, bn_ghost_slices=args.bn_ghost_slices)


def lr_schedule(args):
    """Stepwise decay at 60% and 80% of the run, as the JAX example builds
    it (for a tiny ``--train_steps`` the two boundaries fold into one)."""
    return optim.piecewise_constant_schedule(
        args.learning_rate,
        {int(args.train_steps * 0.6): 0.1, int(args.train_steps * 0.8): 0.1},
    )


def eval_fn_for(cfg: resnet.Config):
    """Test-split metrics with BatchNorm in inference mode (running stats)."""

    def eval_fn(params, mstate, batch):
        logits, _ = resnet.apply(cfg, params, mstate, batch["image"], train=False)
        return {
            "accuracy": layers.accuracy(logits, batch["label"]),
            "loss": layers.softmax_cross_entropy(logits, batch["label"]),
        }

    return eval_fn


def run_training(args, *, loss_fn_factory=None, extra_hooks=()) -> Experiment:
    """The training job: data -> Experiment -> run -> test-split eval ->
    FINAL line.  ``loss_fn_factory(mesh)`` replaces the default
    ``resnet.loss_fn(cfg)``.  Returns the finished Experiment, with its
    data as ``exp.source`` and the eval's metrics as ``exp.test_metrics``."""
    cfg = config_from_args(args)
    resnet.sharding_rules(cfg)  # ghost-batch BN raises here (A8)
    src = streams.resolve_image_source(
        args.data_dir,
        fallback=lambda: datasets.imagenet_synthetic(
            image_size=args.image_size, n_train=args.synthetic_examples,
            num_classes=args.num_classes, seed=args.seed,
        ),
        name="imagenet",
    )
    exp = Experiment(
        init_fn=lambda seed: resnet.init_numpy(cfg, seed),
        loss_fn=None if loss_fn_factory else resnet.loss_fn(cfg),
        loss_fn_factory=loss_fn_factory,
        optimizer=optim.SGD(lr_schedule(args), momentum=args.momentum),
        flags=args,
        device=args.device,
        extra_hooks=extra_hooks,
    )
    exp.source = src
    exp.run(streams.train_iter(src, batch_size=args.batch_size, seed=args.seed))
    exp.test_metrics = exp.evaluate(src.ds.test, eval_fn=eval_fn_for(cfg))
    exp.finish(test_accuracy=exp.test_metrics.get("accuracy", 0.0))
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
