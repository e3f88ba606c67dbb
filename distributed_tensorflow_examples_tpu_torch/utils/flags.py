"""The example CLIs' shared flags: training, and the legacy TF-1 cluster
flags, accepted and mapped.

:func:`add_training_flags` is the twin of ``utils/flags.py::
define_training_flags`` in the JAX package, on argparse, with its names
and defaults; :func:`check_training_flags` refuses, naming the port's
item that brings it, what one device cannot run yet (``--zero_opt`` A8,
``--profile`` A12, a ``--mesh`` beyond one device A5 through
``parallel.mesh``), and logs the multi-process knobs (``--watchdog``,
``--deterministic``) as A5's.

The legacy flags are the twin of ``define_legacy_cluster_flags`` and of
``resolve_legacy_cluster``.  The
reference scripts were launched with ``--ps_hosts``/``--worker_hosts``/
``--job_name``/``--task_index``; the port trains synchronously on one
device, so those flags are parsed, logged and mapped: PS hosts map to
nothing (a notice says so), the worker count is logged, and a
``--job_name=ps`` task has nothing to do (the CLI prints and exits 0).
The reference's PS-emulation modes (``--ps_emulation``,
``--sync_replicas=false``, a serve replica tracking a PS) come with the
port's PS plane (A9) and raise here.
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
        help="Linear warmup steps (read only by the reference's async paths, A9).")
    add("--seed", type=int, default=0, help="Global RNG seed.")
    add("--log_every_steps", type=int, default=100, help="Metric logging cadence.")
    add("--checkpoint_every_steps", type=int, default=1000, help="Save cadence.")
    add("--unroll", type=int, default=1, help="Steps per step call.")
    add("--grad_accum", type=int, default=1,
        help="Gradient-accumulation microbatches per step.")
    add("--mesh", default="", help='Mesh spec; only "" or "data=1" (one device).')
    add("--profile", type=parse_bool, nargs="?", const=True, default=False,
        help="Profiler trace window (waits for the port's tools, A12).")
    add("--obs_events_dir", default="", help="Flight-recorder dump directory.")
    add("--platform", default="", help="(JAX platform; unused by the port).")
    add("--zero_opt", type=parse_bool, nargs="?", const=True, default=False,
        help="ZeRO-1 optimizer sharding (waits for A8).")
    add("--watchdog", type=parse_bool, nargs="?", const=True, default=True,
        help="Multi-process peer watchdog (A5; one process needs none).")
    add("--watchdog_grace_secs", type=float, default=10.0,
        help="Heartbeat staleness after which a peer is declared dead.")
    add("--deterministic", type=parse_bool, nargs="?", const=True, default=False,
        help="Run-to-run determinism knob (A5).")
    add("--device", default=None, help="torch device; default cuda (no silent CPU).")


def check_training_flags(args) -> None:
    """Raise ``NotImplementedError`` naming the port's item for what it
    cannot run on one device yet; log the multi-process knobs."""
    if getattr(args, "zero_opt", False):
        raise NotImplementedError(
            "--zero_opt (ZeRO-1 optimizer sharding) waits for the port's "
            "model-parallel item (A8)")
    if getattr(args, "profile", False):
        raise NotImplementedError(
            "--profile (a profiler trace window) waits for the port's tools item (A12)")
    if getattr(args, "deterministic", False) or getattr(args, "watchdog", False):
        log.info("--watchdog=%s --deterministic=%s: the multi-device spine (A5) brings "
                 "both; one device runs without them", getattr(args, "watchdog", False),
                 getattr(args, "deterministic", False))


def add_legacy_cluster_flags(parser: argparse.ArgumentParser) -> None:
    """``--ps_hosts``, ``--worker_hosts``, ``--task_index``,
    ``--sync_replicas`` and ``--ps_emulation``, with the reference's
    defaults (``--job_name`` each CLI defines with its own roles)."""
    add = parser.add_argument
    add("--ps_hosts", default="", help="(legacy) comma-separated PS host:port list.")
    add("--worker_hosts", default="", help="(legacy) comma-separated worker host:port list.")
    add("--task_index", type=int, default=0, help="(legacy) task index within the job.")
    add("--sync_replicas", type=parse_bool, nargs="?", const=True, default=True,
        help="(legacy) sync/async DP; async waits for the PS plane (A9).")
    add("--ps_emulation", type=parse_bool, nargs="?", const=True, default=False,
        help="Run the PS-emulation trainer (waits for the PS plane, A9).")


def _ps_emulation(args) -> bool:
    """Whether the flags ask for one of the reference's PS-emulation modes:
    a serve replica given both ``--serve_hosts`` and ``--ps_hosts`` (it
    would track the PS), or ``--ps_emulation``/``--sync_replicas=false``
    (the reference's cross-process PS launch needs one of these too)."""
    tracks_ps = (getattr(args, "job_name", "") == "serve" and bool(getattr(args, "ps_hosts", ""))
                 and bool(getattr(args, "serve_hosts", "")))
    return (tracks_ps or getattr(args, "ps_emulation", False)
            or not getattr(args, "sync_replicas", True))


def resolve_legacy_cluster(args) -> dict:
    """The legacy cluster flags of ``args``, logged and mapped; returns the
    reference's info dict: ``ps_hosts`` and ``worker_hosts`` (the lists,
    when given) and ``is_legacy_ps_process`` (``--job_name=ps``: the CLI
    prints and exits 0).  Raises ``NotImplementedError`` naming A9 where
    the reference would run its PS emulation."""
    if _ps_emulation(args):
        raise NotImplementedError(
            "PS emulation (--ps_emulation, --sync_replicas=false, or a serve "
            "replica tracking --ps_hosts) waits for the port's PS plane (A9)"
        )
    info = {}
    if getattr(args, "ps_hosts", ""):
        info["ps_hosts"] = args.ps_hosts.split(",")
        log.warning(
            "--ps_hosts given: the port trains synchronously on one device and "
            "needs no parameter servers. Ignoring %d PS hosts.",
            len(info["ps_hosts"]),
        )
    if getattr(args, "worker_hosts", ""):
        info["worker_hosts"] = args.worker_hosts.split(",")
        log.info(
            "--worker_hosts given (%d workers): the port trains on one device; "
            "multi-device data parallelism waits for A5.",
            len(info["worker_hosts"]),
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
