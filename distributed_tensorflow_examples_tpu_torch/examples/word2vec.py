"""word2vec example of the port: the twin of ``examples/word2vec.py``
(W4, the reference's PS-sharded-embedding workload), with the JAX CLI's
flag names and defaults.

Skip-gram pairs (``--window``) from the text corpus under ``--data_dir``
(``text8`` or ``corpus.txt``) or the synthetic stream, NCE or sampled
softmax over ``--num_sampled`` log-uniform negatives drawn from each
step's key, plain SGD; then the loss on 4096 fresh pairs (seed
``--seed + 999``, in batches of 1024) and the ``FINAL ... eval_loss=``
line.  Runs on the card unless ``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.word2vec \\
        --batch_size=512 --train_steps=2000

``--job_name=ps`` prints and exits 0 and the TF-1 cluster flags are mapped
(``utils/flags.py``); the JAX CLI has no PS branch, so ``--ps_emulation``
and ``--sync_replicas=false`` train as usual here too, and so does a
cross-process PS task role, as there.  On a world of ranks
(``TF_CONFIG``) the mesh is D data x M model (``--mesh``, default all
data): each data index draws ``--batch_size / D`` pairs a step from its
own stream (seed ``--seed + data index``), as the JAX CLI does per host,
and the M model ranks of one data index read the same pairs.  Both
tables (and the nce bias) shard their vocab rows over ``model``
(``models.word2vec.SHARDING_RULES``), the reference's PS-sharded table::

    # two ranks, one table split in two: each with its own TF_CONFIG index
    python -m distributed_tensorflow_examples_tpu_torch.examples.word2vec \
        --mesh=data=1,model=2
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..data import datasets, pipeline
from ..models import word2vec
from ..train import Experiment, optim
from ..utils import flags

#: The evaluation pairs: one draw of this many, scored in batches of 1024.
EVAL_PAIRS = 4096
EVAL_BATCH = 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=256, default_steps=2000)
    flags.add_legacy_cluster_flags(p)
    add("--vocab_size", type=int, default=10000, help="Vocabulary size (most-frequent cut).")
    add("--embedding_dim", type=int, default=128, help="Embedding dimension.")
    add("--num_sampled", type=int, default=64, help="Negative samples per batch (NCE).")
    add("--window", type=int, default=5, help="Skip-gram window half-width.")
    add("--nce_loss", default="nce", choices=["nce", "sampled_softmax"], help="Loss variant.")
    return p


def config_from_args(args) -> word2vec.Config:
    return word2vec.Config(vocab_size=args.vocab_size, dim=args.embedding_dim,
                           num_sampled=args.num_sampled, loss=args.nce_loss)


def run_training(args, *, extra_hooks=()) -> Experiment:
    """Corpus -> Experiment -> run -> eval on fresh pairs -> FINAL line.
    Returns the finished Experiment, with the eval's metrics as
    ``exp.eval_metrics``."""
    ids, vocab, source = datasets.text_corpus(
        args.data_dir, vocab_size=args.vocab_size, seed=args.seed
    )
    logging.info("corpus source: %s (%d tokens, vocab %d)", source, len(ids), len(vocab))
    cfg = config_from_args(args)
    exp = Experiment(
        init_fn=lambda seed: word2vec.init_numpy(cfg, seed),
        loss_fn=word2vec.loss_fn(cfg),
        optimizer=optim.SGD(args.learning_rate),
        flags=args,
        extra_hooks=extra_hooks,
        rules=word2vec.SHARDING_RULES,
    )
    local_batch = args.batch_size // exp.mesh.shape["data"]
    exp.run(pipeline.rank_batches(
        lambda rank: datasets.skipgram_batches(
            ids, batch_size=local_batch, window=args.window, seed=args.seed + rank),
        args.grad_accum, exp.mesh.data_index, exp.mesh.shape["data"]))
    eval_pairs = next(datasets.skipgram_batches(
        ids, batch_size=EVAL_PAIRS, window=args.window, seed=args.seed + 999
    ))
    exp.eval_metrics = exp.evaluate(eval_pairs, batch_size=EVAL_BATCH)
    exp.finish(eval_loss=exp.eval_metrics.get("loss", 0.0))
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
