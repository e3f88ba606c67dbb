"""The example CLIs' shared flags: training, and the legacy TF-1 cluster
flags, accepted and mapped.

:func:`add_training_flags` is the twin of ``utils/flags.py::
define_training_flags`` in the JAX package, on argparse, with its names
and defaults; :func:`check_training_flags` refuses, naming the port's
item that brings it, what the port cannot run yet (``--zero_opt`` A8,
``--profile`` A12; a model-parallel ``--mesh`` axis A8 through
``parallel.mesh``).  ``--watchdog`` starts the peer watchdog on a world
of 2 or more (``parallel/dist.py``); ``--deterministic`` turns on
``utils.determinism``.

The legacy flags are the twin of ``define_legacy_cluster_flags`` and of
``resolve_legacy_cluster``.  The reference scripts were launched with
``--ps_hosts``/``--worker_hosts``/``--job_name``/``--task_index``.  As in
the JAX package, ``--ps_emulation`` or ``--sync_replicas=false`` selects
the in-process PS emulation (the MNIST and CIFAR-10 CLIs run it,
``train/ps_experiment.py``; the other CLIs have no PS branch and train as
usual), and ``--ps_hosts`` under it is validated and logged as the PS
topology (:func:`ps_shard_topology`).  Without it PS hosts map to nothing
(a notice says so), the worker count is logged, and a ``--job_name=ps``
task has nothing to do (the CLI prints and exits 0).  A cross-process task
role (:func:`is_cross_process_ps`: a ``ps``/``chief``/``worker`` task with
``--ps_hosts`` under PS emulation, or a serve replica tracking
``--ps_hosts``) is the port's PS transport, A9b, and raises.
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable

log = logging.getLogger("dtx.flags")


def parse_bool(text: str) -> bool:
    """An argparse type for the reference's boolean flags."""
    low = str(text).lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def add_training_flags(parser: argparse.ArgumentParser, default_batch_size: int = 128,
                       default_steps: int = 1000) -> None:
    """The training flags every example takes, with the JAX package's
    names and defaults, plus ``--device`` (the card unless ``cpu``)."""
    add = parser.add_argument
    add("--batch_size", type=int, default=default_batch_size, help="GLOBAL batch size.")
    add("--train_steps", type=int, default=default_steps, help="Stop after this many steps.")
    add("--data_dir", default=None, help="Dataset directory (synthetic if absent).")
    add("--log_dir", default=None, help="Checkpoints + metrics directory.")
    add("--learning_rate", type=float, default=0.01, help="Base learning rate.")
    add("--warmup_steps", type=int, default=0,
        help="Linear warmup steps (read by the CIFAR-10 PS emulation; 0 = 20).")
    add("--seed", type=int, default=0, help="Global RNG seed.")
    add("--log_every_steps", type=int, default=100, help="Metric logging cadence.")
    add("--checkpoint_every_steps", type=int, default=1000, help="Save cadence.")
    add("--unroll", type=int, default=1, help="Steps per step call.")
    add("--grad_accum", type=int, default=1,
        help="Gradient-accumulation microbatches per step.")
    add("--mesh", default="", help='Mesh spec, e.g. "data=2" ("" = data over every rank).')
    add("--profile", type=parse_bool, nargs="?", const=True, default=False,
        help="Profiler trace window (waits for the port's tools, A12).")
    add("--obs_events_dir", default="", help="Flight-recorder dump directory.")
    add("--platform", default="", help="(JAX platform; unused by the port).")
    add("--zero_opt", type=parse_bool, nargs="?", const=True, default=False,
        help="ZeRO-1 optimizer sharding (waits for A8).")
    add("--watchdog", type=parse_bool, nargs="?", const=True, default=True,
        help="Multi-process peer watchdog (a world of 2 or more ranks).")
    add("--watchdog_grace_secs", type=float, default=10.0,
        help="Heartbeat staleness after which a peer is declared dead.")
    add("--deterministic", type=parse_bool, nargs="?", const=True, default=False,
        help="Run-to-run determinism (utils.determinism); under PS emulation also "
             "the fixed round-robin interleave.")
    add("--device", default=None, help="torch device; default cuda (no silent CPU).")


def check_training_flags(args) -> None:
    """Raise ``NotImplementedError`` naming the port's item for what it
    cannot run yet."""
    if getattr(args, "zero_opt", False):
        raise NotImplementedError(
            "--zero_opt (ZeRO-1 optimizer sharding) waits for the port's "
            "model-parallel item (A8)")
    if getattr(args, "profile", False):
        raise NotImplementedError(
            "--profile (a profiler trace window) waits for the port's tools item (A12)")


def add_legacy_cluster_flags(parser: argparse.ArgumentParser) -> None:
    """``--ps_hosts``, ``--worker_hosts``, ``--task_index``,
    ``--sync_replicas``, ``--ps_emulation``, ``--replicas_to_aggregate``
    and ``--max_staleness``, with the reference's defaults (``--job_name``
    each CLI defines with its own roles)."""
    add = parser.add_argument
    add("--ps_hosts", default="", help="(legacy) comma-separated PS host:port list.")
    add("--worker_hosts", default="", help="(legacy) comma-separated worker host:port list.")
    add("--task_index", type=int, default=0, help="(legacy) task index within the job.")
    add("--sync_replicas", type=parse_bool, nargs="?", const=True, default=True,
        help="(legacy) sync/async DP; false runs the async PS emulation where a CLI has one.")
    add("--ps_emulation", type=parse_bool, nargs="?", const=True, default=False,
        help="Run the PS-emulation trainer (token-gated sync_replicas mode).")
    add("--replicas_to_aggregate", type=int, default=0,
        help="(legacy, sync_replicas) gradients to aggregate per update; 0 = "
             "number of workers.")
    add("--max_staleness", type=int, default=0,
        help="(async mode) drop gradients older than this many applied steps; "
             "0 = unbounded (the reference's async behavior).")


def is_cross_process_ps(args) -> bool:
    """True when the CLI requests the reference's one-process-per-task PS
    launch (SURVEY.md sections 3.1/3.2): a PS-emulation mode is selected,
    a PS service address is given, and this process was assigned a task
    role.  The ``serve`` job is a model replica that needs both a bind
    address (``--serve_hosts``) and the PS topology it pulls params from.
    The port's item A9b brings both.  (The JAX predicate also answers for
    the ``data_service`` job, which no port CLI has: A10.)"""
    if getattr(args, "job_name", "") == "serve":
        return bool(getattr(args, "serve_hosts", "")) and bool(getattr(args, "ps_hosts", ""))
    return (
        getattr(args, "job_name", "") in ("chief", "worker", "ps")
        and bool(getattr(args, "ps_hosts", ""))
        and (getattr(args, "ps_emulation", False) or not getattr(args, "sync_replicas", True))
    )


def parse_hostports(spec: str, flag: str = "--ps_hosts") -> list[tuple[str, int]]:
    """Validate a comma-separated ``host:port`` list into addr tuples.
    Malformed entries (empty, missing/non-numeric port, duplicates) fail
    the launch loudly — a typo'd shard list must never silently collapse
    onto fewer servers than the operator asked for."""
    addrs: list[tuple[str, int]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        host, sep, port_s = entry.rpartition(":")
        if not entry or not sep or not host or not port_s.isdigit():
            raise ValueError(f"{flag} entry {entry!r} is not host:port (full list: {spec!r})")
        addr = (host, int(port_s))
        if addr in addrs:
            raise ValueError(f"{flag} lists {entry!r} twice ({spec!r})")
        addrs.append(addr)
    return addrs


def ps_shard_topology(args) -> tuple[list[tuple[str, int]], int, int]:
    """The validated PS shard topology: the FULL ``--ps_hosts`` address
    list plus the resolved shard count (``--ps_shards``; -1 = one shard
    per host) and replica count (``--ps_replicas``).  Shard i's PRIMARY is
    ``addrs[i]`` and replica r of shard i is ``addrs[r*shards + i]``
    (replica-major), as in the JAX package."""
    addrs = parse_hostports(args.ps_hosts)
    raw = getattr(args, "ps_shards", -1)
    n = -1 if raw is None else int(raw)
    r = int(getattr(args, "ps_replicas", 1) or 1)
    if r not in (1, 2):
        raise ValueError(
            f"--ps_replicas={r} unsupported (1 = unreplicated, 2 = "
            "primary/backup pairs; deeper chains are not implemented)"
        )
    if n < 0:
        if len(addrs) % r:
            raise ValueError(
                f"--ps_replicas={r} does not tile {len(addrs)} --ps_hosts "
                "entries (need shards*replicas hosts)"
            )
        n = len(addrs) // r
    if n == 0 or n * r > len(addrs):
        raise ValueError(
            f"--ps_shards={n} x --ps_replicas={r} invalid for {len(addrs)} "
            f"--ps_hosts entries (need shards*replicas <= {len(addrs)}, "
            "or -1 shards for one shard per host)"
        )
    return addrs, n, r


def resolve_legacy_cluster(args) -> dict:
    """The legacy cluster flags of ``args``, logged and mapped; returns the
    reference's info dict: ``ps_hosts`` and ``worker_hosts`` (the lists,
    when given; under PS emulation the validated topology, with
    ``ps_shards`` and ``ps_replicas``) and ``is_legacy_ps_process``
    (``--job_name=ps``: the CLI prints and exits 0).  Raises
    ``NotImplementedError`` naming A9b for a cross-process task role."""
    if is_cross_process_ps(args):
        raise NotImplementedError(
            f"--job_name={getattr(args, 'job_name', '')} with --ps_hosts under PS "
            "emulation (a cross-process PS task, or a serve replica tracking the "
            "PS) waits for the port's PS transport (A9b)"
        )
    info = {}
    emulation = getattr(args, "ps_emulation", False) or not getattr(args, "sync_replicas", True)
    if getattr(args, "ps_hosts", ""):
        if emulation:
            addrs, n_shards, n_replicas = ps_shard_topology(args)
            info["ps_hosts"] = [f"{h}:{p}" for h, p in addrs]
            info["ps_shards"] = n_shards
            info["ps_replicas"] = n_replicas
            log.info(
                "--ps_hosts given with PS emulation: %d host(s), %d shard(s) x %d "
                "replica(s): %s; the in-process emulation hosts the parameters "
                "itself.", len(addrs), n_shards, n_replicas,
                ",".join(info["ps_hosts"][: n_shards * n_replicas]),
            )
        else:
            info["ps_hosts"] = args.ps_hosts.split(",")
            log.warning(
                "--ps_hosts given: the port trains synchronously (data parallel over "
                "the ranks) and needs no parameter servers. Ignoring %d PS hosts.",
                len(info["ps_hosts"]),
            )
    if getattr(args, "worker_hosts", ""):
        info["worker_hosts"] = args.worker_hosts.split(",")
        log.info(
            "--worker_hosts given (%d workers): %s", len(info["worker_hosts"]),
            "PS emulation — one worker thread per entry" if emulation
            else "the equivalent data-parallel degree is the world: launch one "
            "process per rank with TF_CONFIG (see parallel.dist, utils.multiprocess).",
        )
    info["is_legacy_ps_process"] = getattr(args, "job_name", "") == "ps"
    return info


def add_job_name_flag(parser: argparse.ArgumentParser) -> None:
    """``--job_name`` of a CLI that trains: '' or 'worker' trains, 'ps'
    exits 0."""
    parser.add_argument("--job_name", default="",
                        help="'' or 'worker' trains; 'ps' exits 0 (no PS needed).")


def exits_as_ps_task(args) -> bool:
    """Resolve the legacy cluster flags; for a ``--job_name=ps`` task
    print the notice and return True (the CLI then exits 0, as the JAX
    CLIs do)."""
    if resolve_legacy_cluster(args)["is_legacy_ps_process"]:
        print("job_name=ps: parameter servers are not needed by the port's sync "
              "training; exiting 0.")
        return True
    return False


def train_main(parser: argparse.ArgumentParser, run_training: Callable, argv=None) -> int:
    """The main of a CLI that only trains: parse ``argv``, exit 0 on a PS
    task, refuse a ``--job_name`` other than '' or 'worker', else
    ``run_training(args)``."""
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if exits_as_ps_task(args):
        return 0
    if args.job_name not in ("", "worker"):
        raise SystemExit(f"--job_name={args.job_name}: '' or 'worker' trains; 'ps' exits 0")
    run_training(args)
    return 0
