"""The legacy TF-1 cluster flags of the example CLIs, accepted and mapped.

The port's twin of ``utils/flags.py::define_legacy_cluster_flags`` and of
``resolve_legacy_cluster`` in the JAX package, on argparse.  The
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

log = logging.getLogger("dtx.flags")


def parse_bool(text: str) -> bool:
    """An argparse type for the reference's boolean flags."""
    low = str(text).lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


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
