"""PTB LSTM example of the port: the twin of ``examples/ptb_lstm.py`` (W5,
the reference's MultiWorkerMirroredStrategy workload), with the JAX CLI's
flag names and defaults.

A word-level LSTM language model over truncated-BPTT windows
(``--seq_len``) of PTB under ``--data_dir`` (``ptb.train.txt``,
``ptb.valid.txt``) or the synthetic streams, the carry threaded from
window to window in the train state, ``clip_by_global_norm(--clip_norm)``
then SGD; then the validation perplexity as the JAX CLI computes it and
the ``FINAL ... valid_perplexity=`` line.  Runs on the card unless
``--device=cpu``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.ptb_lstm \\
        --batch_size=64 --seq_len=20 --train_steps=2000

On a world of N ranks (``TF_CONFIG``, one process each; see
``utils/multiprocess.py``) each rank trains on a contiguous block of the
token stream with ``--batch_size / N`` rows and its own carry of those
rows, the gradients mean-all-reduced before the clip, as the JAX CLI
splits the rows over hosts; the validation runs on every rank, and the
chief prints FINAL.

``--job_name=ps`` prints and exits 0 and the TF-1 cluster flags are mapped
(``utils/flags.py``); the JAX CLI has no PS branch, so ``--ps_emulation``
and ``--sync_replicas=false`` train as usual here too, and only a
cross-process PS task raises (A9b).
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from ..data import datasets, pipeline
from ..models import lstm
from ..parallel import dist, sharding
from ..train import Experiment, optim
from ..train.state import as_state_leaves
from ..utils import flags, threefry

#: Validation reads at most this many windows.
MAX_EVAL_WINDOWS = 50


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    flags.add_job_name_flag(p)
    flags.add_training_flags(p, default_batch_size=64, default_steps=2000)
    flags.add_legacy_cluster_flags(p)
    add("--vocab_size", type=int, default=10000, help="Vocabulary size.")
    add("--hidden_dim", type=int, default=200, help="Embedding + LSTM hidden width.")
    add("--num_layers", type=int, default=2, help="LSTM stack depth.")
    add("--seq_len", type=int, default=20, help="Truncated-BPTT window length.")
    add("--clip_norm", type=float, default=5.0, help="Global-norm gradient clip (PTB recipe).")
    return p


def config_from_args(args) -> lstm.Config:
    return lstm.Config(vocab_size=args.vocab_size, dim=args.hidden_dim,
                       num_layers=args.num_layers)


def valid_perplexity(cfg: lstm.Config, params, valid_ids, *, batch_size: int,
                     seq_len: int, device) -> float:
    """The JAX CLI's validation: a zero carry of ``eval_rows`` rows
    threaded over at most ``MAX_EVAL_WINDOWS`` windows of the held-out
    stream, each window's loss under ``key(0)``; the exp (float32) of the
    mean loss."""
    eval_rows = min(batch_size, max(1, len(valid_ids) // (seq_len + 1)))
    carry = as_state_leaves(lstm.zero_carry(cfg, eval_rows), device)
    windows = datasets.lm_batches(valid_ids, batch_size=eval_rows, seq_len=seq_len)
    n_eval = max(1, (len(valid_ids) // eval_rows - 1) // seq_len)
    loss_f = lstm.loss_fn(cfg)
    total, count = 0.0, 0
    with torch.no_grad():
        for _ in range(min(n_eval, MAX_EVAL_WINDOWS)):
            batch = pipeline.to_device(next(windows), device)
            loss, (carry, _m) = loss_f(params, carry, batch, threefry.key(0))
            total += float(loss)
            count += 1
    return float(torch.exp(torch.tensor(total / count, dtype=torch.float32)))


def run_training(args, *, extra_hooks=()) -> Experiment:
    """Streams -> Experiment -> run -> validation -> FINAL line.  Returns
    the finished Experiment, with the perplexity as
    ``exp.valid_perplexity``."""
    train_ids, valid_ids, _vocab, source = datasets.ptb(
        args.data_dir, vocab_size=args.vocab_size, seed=args.seed
    )
    logging.info("ptb source: %s (%d train / %d valid tokens)", source, len(train_ids),
                 len(valid_ids))
    cfg = config_from_args(args)
    exp = Experiment(
        # The carry of this rank's rows (the world is up when init runs).
        init_fn=lambda seed: lstm.init_numpy(
            cfg, seed, batch_size=args.batch_size // dist.process_count()),
        loss_fn=lstm.loss_fn(cfg),
        optimizer=optim.SGD(args.learning_rate, clip_norm=args.clip_norm),
        flags=args,
        extra_hooks=extra_hooks,
        row_sharded_state=True,
    )
    local_ids, local_rows = sharding.stream_block(train_ids, args.batch_size)
    exp.run(datasets.lm_batches(local_ids, batch_size=local_rows, seq_len=args.seq_len))
    exp.valid_perplexity = valid_perplexity(
        cfg, exp.state.params, valid_ids, batch_size=args.batch_size, seq_len=args.seq_len,
        device=exp.device,
    )
    exp.finish(valid_perplexity=exp.valid_perplexity)
    return exp


def main(argv=None) -> int:
    return flags.train_main(build_parser(), run_training, argv)


if __name__ == "__main__":
    sys.exit(main())
