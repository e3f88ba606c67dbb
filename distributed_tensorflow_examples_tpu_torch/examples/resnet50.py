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
TF-1 cluster flags are accepted and mapped (``utils/flags.py``); ghost-batch BN
(``--bn_ghost_slices``), streamed ``--data_dir`` sources and a mesh beyond
one device wait for the port's items A8, A10 and A5.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..data import datasets, streams
from ..models import layers, resnet
from ..train import Experiment, optim
from ..utils import flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    add("--job_name", default="", help="'' or 'worker' trains; 'ps' exits 0 (no PS needed).")
    # Training (the JAX package's define_training_flags names and defaults).
    add("--batch_size", type=int, default=256, help="GLOBAL batch size.")
    add("--train_steps", type=int, default=1000, help="Stop after this many steps.")
    add("--data_dir", default=None, help="Dataset directory (synthetic if absent).")
    add("--log_dir", default=None, help="Checkpoints + metrics directory.")
    add("--learning_rate", type=float, default=0.01, help="Base learning rate.")
    add("--seed", type=int, default=0, help="Global RNG seed.")
    add("--log_every_steps", type=int, default=100, help="Metric logging cadence.")
    add("--checkpoint_every_steps", type=int, default=1000, help="Save cadence.")
    add("--unroll", type=int, default=1, help="Steps per step call.")
    add("--grad_accum", type=int, default=1,
        help="Gradient-accumulation microbatches per step.")
    add("--mesh", default="", help='Mesh spec; only "" or "data=1" (one device).')
    # The example's own.
    add("--image_size", type=int, default=224, help="Input image resolution.")
    add("--num_classes", type=int, default=1000, help="Label classes.")
    add("--momentum", type=float, default=0.9, help="SGD momentum.")
    add("--synthetic_examples", type=int, default=2048, help="Synthetic train-set size.")
    add("--bn_ghost_slices", type=int, default=0,
        help=">0 scopes BN statistics to slice-local groups (waits for A8).")
    add("--device", default=None, help="torch device; default cuda (no silent CPU).")
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
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if flags.resolve_legacy_cluster(args)["is_legacy_ps_process"]:
        print("job_name=ps: parameter servers are not needed by the port's sync "
              "training; exiting 0.")
        return 0
    if args.job_name not in ("", "worker"):
        raise SystemExit(f"--job_name={args.job_name}: '' or 'worker' trains; 'ps' exits 0")
    run_training(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
