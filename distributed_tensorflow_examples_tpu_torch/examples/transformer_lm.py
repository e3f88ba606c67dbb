"""Transformer LM serve task of the port: host one registry-pinned replica.

The port's twin of ``examples/transformer_lm.py --job_name=serve``, with
the same flag names for the serve subset::

    python -m distributed_tensorflow_examples_tpu_torch.examples.transformer_lm \\
        --job_name=serve --registry_dir=/models --serve_model_version=1 \\
        --serve_hosts=127.0.0.1:7200 --vocab_size=32000 --dim=1024 \\
        --n_layers=12 --n_heads=8 --seq_len=2048

It serves the row-wise logits predict path on the card (``--device=cpu``
to run on the CPU), with attention through the flash kernel under
``--attention=auto`` or ``flash``.  Training and the KV-cache decode path
wait for later slices of the port.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..models import transformer
from ..serve import host_serve_task


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--job_name", default="serve",
                   help="Only 'serve' in this slice of the port.")
    p.add_argument("--registry_dir", default="",
                   help="Model registry root holding the served version.")
    p.add_argument("--serve_model_version", type=int, default=0,
                   help="Registry version to pin (>= 1).")
    p.add_argument("--serve_hosts", default="",
                   help="Comma-separated host:port list; this task binds "
                        "the port of entry --task_index.")
    p.add_argument("--task_index", type=int, default=0)
    p.add_argument("--vocab_size", type=int, default=8192)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=4)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--attention", default="auto",
                   choices=["auto", "xla", "flash", "ulysses"])
    p.add_argument("--max_batch", type=int, default=32,
                   help="Rows of one padded apply.")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (no silent CPU).")
    return p


def config_from_args(args) -> transformer.Config:
    return transformer.Config(
        vocab_size=args.vocab_size, dim=args.dim, n_layers=args.n_layers,
        n_heads=args.n_heads, max_seq_len=args.seq_len,
        attention=args.attention,
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.job_name != "serve":
        raise SystemExit(
            f"--job_name={args.job_name}: this slice of the port serves only "
            "(--job_name=serve); training comes with a later slice"
        )
    if not args.registry_dir or args.serve_model_version < 1:
        raise SystemExit(
            "--job_name=serve needs --registry_dir and --serve_model_version "
            "(the transformer serves pinned registry versions)"
        )
    cfg = config_from_args(args)
    host_serve_task(
        param_shapes=transformer.param_shapes(cfg),
        predict_fn=lambda p, b: transformer.apply(cfg, p, b["x"]),
        port=serve_port(args.serve_hosts, args.task_index),
        device=args.device,
        max_batch=args.max_batch,
        registry_dir=args.registry_dir,
        model_name="transformer_lm",
        model_version=args.serve_model_version,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
