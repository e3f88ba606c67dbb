"""Transformer LM example of the port: train (the default job) or serve.

The port's twin of ``examples/transformer_lm.py``, with the JAX CLI's
flag names.  Training (``--job_name`` empty or ``worker``) runs the
port's ``Experiment`` on one device over the text corpus (synthetic
unless ``--data_dir`` holds one), with attention through the flash
kernels (forward and backward) under ``--attention=auto`` or ``flash``
on the card, and publishes the trained weights to ``--registry_dir``
when given::

    python -m distributed_tensorflow_examples_tpu_torch.examples.transformer_lm \\
        --batch_size=8 --seq_len=2048 --vocab_size=32000 --dim=1024 \\
        --n_layers=12 --n_heads=8 --train_steps=100 --learning_rate=1e-3 \\
        --log_dir=/tmp/lm --registry_dir=/models

``--job_name=serve`` hosts one registry-pinned replica of a published
version: stepped KV-cache decode sessions (streamed tokens over
DECODE_OPEN/NEXT/CLOSE, at most ``--seq_len`` positions each) beside the
row-wise logits predict path::

    python -m distributed_tensorflow_examples_tpu_torch.examples.transformer_lm \\
        --job_name=serve --registry_dir=/models --serve_model_version=1 \\
        --serve_hosts=127.0.0.1:7200 --vocab_size=32000 --dim=1024 \\
        --n_layers=12 --n_heads=8 --seq_len=2048

Training takes the JAX CLI's ``--mesh``: ``data`` x ``expert`` x ``seq``
x ``model`` over the ranks of a ``TF_CONFIG`` world (one process a rank),
laid out by ``transformer.sharding_rules`` (Megatron blocks and
vocab-parallel tables over ``model``, experts over ``expert``), each rank
on its rows of the global batch (its data x expert row shard's block of
the corpus) and its slice of the sequence (its seq index's columns),
attention over a seq axis as the ring (the flash kernels per hop on the
card) or, with ``--attention=ulysses``, as all-to-all sequence
parallelism::

    python -m distributed_tensorflow_examples_tpu_torch.examples.transformer_lm \\
        --mesh=data=1,seq=2,model=2 --batch_size=2 --seq_len=8192 ...

``--moe_experts=E`` swaps every block's MLP for a mixture of experts
(top-2 GShard routing, ``--moe_capacity_factor``, ``--moe_group_size``),
whose experts shard over ``expert``::

    python -m distributed_tensorflow_examples_tpu_torch.examples.transformer_lm \\
        --moe_experts=8 --mesh=data=1,expert=2 --batch_size=4 --seq_len=2048 ...

Both run on the card unless ``--device=cpu``.  The reference's TF-1
cluster flags are accepted and mapped (``utils/flags.py``):
``--job_name=ps`` prints and exits 0, ``--ps_hosts`` is logged and
ignored, ``--worker_hosts`` logged; the JAX CLI has no PS branch, so
``--ps_emulation`` and ``--sync_replicas=false`` train as usual, and so
does a cross-process PS task role (``--job_name=ps|chief|worker`` with
``--ps_hosts``), as there; a serve replica serves its pinned version
whatever ``--ps_hosts`` says, at the replica's defaults (32 rows, 5 ms,
a queue of 128, no queue deadline), which the ``--serve_*`` flags do not
change, as in JAX.  ``--sample_tokens=N`` greedily
decodes N tokens after training from the corpus's first 16 tokens and
logs them (on a data x expert mesh, as in JAX, the prompt tiled once per
row shard and decoded sharded).  On a world of N ranks (``TF_CONFIG``)
each row shard trains on a contiguous block of the corpus with
``--batch_size`` / (data x expert) rows, as the JAX CLI shards it over
hosts, and, as there, a multi-process run skips the registry publish.
Pipeline stages and ``--sample_tokens`` under a ``seq`` or ``model`` axis
(decode under a mesh) wait for the port's item A8b-2b.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..data import datasets, pipeline
from ..models import transformer
from ..parallel import dist, sharding
from ..parallel.mesh import MeshSpec
from ..serve import ModelRegistry, host_serve_task
from ..train import Experiment, optim
from ..train.checkpoint import flat_params_of
from ..utils import flags


#: The corpus tokens ``--sample_tokens`` decodes from.
PROMPT_LEN = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add = p.add_argument
    add("--job_name", default="",
        help="'' or 'worker' trains (the default); 'serve' hosts a replica; "
             "'ps' exits 0 (no PS needed).")
    flags.add_training_flags(p, default_batch_size=8, default_steps=500)
    add("--clip_norm", type=float, default=1.0, help="Global-norm gradient clip.")
    add("--remat", type=flags.parse_bool, nargs="?", const=True, default=False,
        help="Rematerialise blocks in backward.")
    add("--loss_chunks", type=int, default=0,
        help=">1 chunks the LM head + cross-entropy over the sequence.")
    add("--sample_tokens", type=int, default=0,
        help=">0 greedy-decodes this many tokens after training.")
    add("--pipeline_stages", type=int, default=1,
        help=">1 waits for the port's pipeline axis (A8b-2b).")
    add("--moe_experts", type=int, default=0,
        help='>0 swaps every block\'s MLP for a mixture-of-experts FFN sharded over the '
             'mesh "expert" axis (pass e.g. --mesh "data=2,expert=4"); top-2 routing, '
             "Switch aux loss.")
    add("--moe_capacity_factor", type=float, default=1.25, help="Expert capacity factor.")
    add("--moe_group_size", type=int, default=1024,
        help="GShard routing-group size G (capacity is per group).")
    # Model.
    add("--vocab_size", type=int, default=8192)
    add("--dim", type=int, default=256)
    add("--n_layers", type=int, default=4)
    add("--n_heads", type=int, default=8)
    add("--seq_len", type=int, default=512)
    add("--attention", default="auto", choices=["auto", "xla", "flash", "ulysses"],
        help="auto/xla/flash choose the kernel (and the ring's per-hop compute under a "
             "seq axis); ulysses: all-to-all sequence parallelism instead of the ring.")
    # --registry_dir, --serve_model_version, --serve_hosts and the --serve_*
    # limits are legacy cluster flags.
    flags.add_legacy_cluster_flags(p)
    return p


def config_from_args(args) -> transformer.Config:
    return transformer.Config(
        vocab_size=args.vocab_size, dim=args.dim, n_layers=args.n_layers,
        n_heads=args.n_heads, max_seq_len=args.seq_len,
        attention=args.attention, pipeline_stages=args.pipeline_stages,
        moe_experts=args.moe_experts, moe_capacity_factor=args.moe_capacity_factor,
        moe_group_size=args.moe_group_size, remat=args.remat,
        loss_chunks=args.loss_chunks,
    )


def serve_port(serve_hosts: str, task_index: int) -> int:
    """The port of entry ``task_index`` of ``--serve_hosts`` (0 = any)."""
    if not serve_hosts:
        return 0
    entries = [e.strip() for e in serve_hosts.split(",") if e.strip()]
    host_port = entries[min(task_index, len(entries) - 1)]
    host, sep, port = host_port.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--serve_hosts entry {host_port!r} is not host:port")
    return int(port)


def _serve(args) -> None:
    if not args.registry_dir or args.serve_model_version < 1:
        raise SystemExit(
            "--job_name=serve needs --registry_dir and --serve_model_version "
            "(the transformer serves pinned registry versions)"
        )
    cfg = config_from_args(args)
    host_serve_task(
        param_shapes=transformer.param_shapes(cfg),
        predict_fn=lambda p, b: transformer.apply(cfg, p, b["x"]),
        decode_fns=transformer.serve_decode_fns(cfg),
        decode_max_len=args.seq_len,
        port=serve_port(args.serve_hosts, args.task_index),
        device=args.device,
        # The JAX transformer's serve task passes no --serve_* flag: its
        # replica serves at host_serve_task's defaults, and so does this.
        registry_dir=args.registry_dir,
        model_name="transformer_lm",
        model_version=args.serve_model_version,
    )


def _publish_to_registry(args, exp) -> int | None:
    """Publish the trained params as a NEW immutable registry version (the
    artifact a pinned serve replica loads); None on a multi-process run,
    as in the JAX CLI."""
    if dist.process_count() > 1:
        logging.warning("--registry_dir publish skipped on multi-process runs; restore "
                        "the checkpoint in one process and publish there.")
        return None
    version = ModelRegistry(args.registry_dir).publish(
        "transformer_lm",
        flat_params_of(exp.state),
        step=int(exp.state.step),
        source=f"transformer_lm seed={args.seed}",
    )
    logging.info(
        "registry: published transformer_lm/v%d under %s "
        "(serve it: --job_name=serve --serve_model_version=%d)",
        version, args.registry_dir, version,
    )
    return version


def run_training(args, *, extra_hooks=()) -> Experiment:
    """The training job: corpus -> Experiment -> run -> publish -> FINAL
    line.  Returns the finished Experiment (``exp.published_version``
    when ``--registry_dir`` was given)."""
    cfg = config_from_args(args)
    transformer.param_shapes(cfg)  # pipeline stages raise here (A8b-2b)
    spec = MeshSpec.parse(args.mesh)
    if args.sample_tokens > 0 and (spec.seq != 1 or spec.model != 1):
        raise NotImplementedError(
            "--sample_tokens under a 'seq' or 'model' mesh axis (decode under a mesh) "
            "waits for the port's item A8b-2b"
        )
    if args.sample_tokens > 0 and PROMPT_LEN + args.sample_tokens > args.seq_len:
        # Refused before training: generate() would raise after the whole
        # run and lose the FINAL line.
        raise SystemExit(
            f"--sample_tokens={args.sample_tokens} + {PROMPT_LEN} prompt "
            f"tokens exceeds --seq_len={args.seq_len}"
        )
    ids, _vocab, source = datasets.text_corpus(
        args.data_dir,
        vocab_size=args.vocab_size,
        synth_tokens=max(2_000_000, args.batch_size * (args.seq_len + 1) * 50),
        seed=args.seed,
    )
    logging.info("corpus source: %s (%d tokens)", source, len(ids))
    exp = Experiment(
        init_fn=lambda seed: transformer.init_numpy(cfg, seed),
        loss_fn_factory=lambda mesh: transformer.loss_fn(cfg, mesh=mesh),
        optimizer=optim.ClippedAdamW(args.learning_rate, args.clip_norm),
        flags=args,
        device=args.device,
        extra_hooks=extra_hooks,
        rules=transformer.sharding_rules(cfg),
    )
    mesh = exp.mesh
    shards = mesh.row_shards

    def rank_stream(rank):
        block, rows = sharding.stream_block(ids, args.batch_size, rank, shards)
        return datasets.lm_batches(block, batch_size=rows, seq_len=args.seq_len)

    batches = pipeline.rank_batches(rank_stream, args.grad_accum, mesh.row_index, shards)
    exp.run(pipeline.seq_columns(batches, mesh.seq_index, mesh.shape.get("seq", 1)))
    if args.sample_tokens > 0:
        # KV-cache greedy decode from a corpus prompt, its rows covering the
        # row shards (data x expert), decoded on the training mesh.
        prompt = np.tile(np.asarray(ids[:PROMPT_LEN], np.int32)[None], (shards, 1))
        out = transformer.generate(cfg, exp.state.params, prompt,
                                   max_new_tokens=args.sample_tokens, mesh=mesh)
        logging.info("sampled token ids: %s", out[0, PROMPT_LEN:].tolist())
    if args.registry_dir:
        exp.published_version = _publish_to_registry(args, exp)
    m = exp.session.last_metrics
    exp.finish(final_perplexity=float(m.get("perplexity", 0.0)))
    return exp


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if flags.exits_as_ps_task(args):
        return 0
    if args.job_name == "serve":
        _serve(args)
    elif args.job_name in ("", "worker") or flags.is_cross_process_ps(args):
        run_training(args)  # a PS task role trains here, as in JAX (no PS branch)
    else:
        raise SystemExit(
            f"--job_name={args.job_name}: the port trains (empty or 'worker'), "
            "serves ('serve') or exits 0 ('ps')"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
