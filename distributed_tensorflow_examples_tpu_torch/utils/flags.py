"""The example CLIs' shared flags: training, and the legacy TF-1 cluster
flags, accepted and mapped.

:func:`add_training_flags` is the twin of ``utils/flags.py::
define_training_flags`` in the JAX package, on argparse, with its names
and defaults; ``--profile`` with a ``--log_dir`` traces a window of
steps (``train/hooks.py::ProfilerHook``, as the JAX runner adds it);
``--mesh`` takes every axis of the JAX package (``parallel.mesh``).
``--zero_opt`` shards the optimizer slots (ZeRO-1,
``train/state.py``).  ``--watchdog`` starts the peer watchdog on a world
of 2 or more (``parallel/dist.py``); ``--deterministic`` turns on
``utils.determinism``.

The legacy flags are the twin of ``define_legacy_cluster_flags`` and of
``resolve_legacy_cluster``.  The reference scripts were launched with
``--ps_hosts``/``--worker_hosts``/``--job_name``/``--task_index``.  As in
the JAX package, ``--ps_emulation`` or ``--sync_replicas=false`` selects
the PS emulation (the MNIST and CIFAR-10 CLIs run it,
``train/ps_experiment.py``; the other CLIs have no PS branch and train as
usual), and ``--ps_hosts`` under it is validated and logged as the PS
topology (:func:`ps_shard_topology`).  Without it PS hosts map to nothing
(a notice says so), the worker count is logged, and a ``--job_name=ps``
task has nothing to do (the CLI prints and exits 0).  A cross-process
task role (:func:`is_cross_process_ps`: a ``ps``/``chief``/``worker`` task
with ``--ps_hosts`` under PS emulation, a serve replica tracking
``--ps_hosts``, a ``data_service`` task) is the reference's
one-process-per-task launch: the MNIST and CIFAR-10 CLIs run its PS,
chief, worker and serve roles over the port's socket service, at
``--ps_shards`` x ``--ps_replicas`` (:func:`ps_shard_topology`, the JAX
validation), pinned to ``--ps_layout_version``, with ``--ps_reshard_to``
joiners (:func:`parse_reshard_to`) and the ``--tenant`` /
``--tenant_quotas`` pair, and the ``data_service`` task that serves
``--data_dir``'s shards to workers reading ``dsvc://host:port``; the
other CLIs train, as the JAX ones do.  ``--serve_max_batch``, ``--serve_max_wait_ms``,
``--serve_queue_depth``, ``--serve_queue_deadline_ms``,
``--serve_refresh_ms``, ``--registry_dir`` and ``--serve_model_version``
are accepted with the JAX defaults (the transformer's pinned replica
serves at those defaults, as the JAX one does).
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
    add("--mesh", default="",
        help='Mesh spec over the ranks, e.g. "data=2", "data=1,model=2", "data=2,expert=2" '
             'or "data=1,seq=2,model=2" ("" = data over every rank; the model and expert '
             "axes shard the leaves a model's rules name, the seq axis the sequence).")
    add("--profile", type=parse_bool, nargs="?", const=True, default=False,
        help="Capture a torch.profiler trace window (under --log_dir).")
    add("--obs_events_dir", default="", help="Flight-recorder dump directory.")
    add("--platform", default="", help="(JAX platform; unused by the port).")
    add("--zero_opt", type=parse_bool, nargs="?", const=True, default=False,
        help="ZeRO-1: shard the big replicated leaves' optimizer slots over the data axis.")
    add("--watchdog", type=parse_bool, nargs="?", const=True, default=True,
        help="Multi-process peer watchdog (a world of 2 or more ranks).")
    add("--watchdog_grace_secs", type=float, default=10.0,
        help="Heartbeat staleness after which a peer is declared dead.")
    add("--deterministic", type=parse_bool, nargs="?", const=True, default=False,
        help="Run-to-run determinism (utils.determinism); under PS emulation also "
             "the fixed round-robin interleave.")
    add("--device", default=None, help="torch device; default cuda (no silent CPU).")


def add_legacy_cluster_flags(parser: argparse.ArgumentParser) -> None:
    """The reference's legacy cluster flags with its defaults and help:
    ``--ps_hosts``, ``--worker_hosts``, ``--task_index``,
    ``--sync_replicas``, ``--ps_emulation``, ``--replicas_to_aggregate``,
    ``--max_staleness``, the cross-process PS launch's ``--ps_tasks``,
    ``--ps_listen_all``, ``--ps_restarts``, ``--ps_wire_dtype``,
    ``--ps_prefetch``, ``--membership_leases``, ``--lease_ttl_s``, the
    service hosts, the serving replicas' ``--serve_*`` limits and registry
    pin, the PS topology (``--ps_shards``, ``--ps_replicas``,
    ``--ps_layout_version``, ``--ps_reshard_to``) and the tenancy pair
    (``--job_name`` each CLI defines with its own roles)."""
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
    add("--ps_tasks", type=int, default=-1,
        help="Cross-process PS launch: number of dedicated --job_name=ps processes "
             "in the cluster (-1 = one per --ps_hosts entry, the reference "
             "convention; 0 = no PS task, the chief hosts the state service "
             "in-process).")
    add("--ps_listen_all", type=parse_bool, nargs="?", const=True, default=False,
        help="Bind the (unauthenticated) PS state service on ALL interfaces so "
             "workers on other hosts can reach it.  Off = loopback only.  Required "
             "whenever the task's --ps_hosts entry is not a literal loopback address.")
    add("--ps_restarts", type=int, default=3,
        help="Cross-process PS launch: run the --job_name=ps task under "
             "utils.supervisor.supervise() with this restart budget, so a PS crash "
             "is healed by PS restart + client reconnect.  0 disables supervision.")
    add("--ps_wire_dtype", default="f32",
        help="Cross-process PS wire encoding: f32 (exact) or bf16 (half the "
             "param/grad bytes; the PS stores f32 and converts at the socket "
             "boundary, negotiated at connect so mismatched peers fail loudly).")
    add("--ps_prefetch", type=parse_bool, nargs="?", const=True, default=True,
        help="Async cross-process workers: double-buffer param pulls on a dedicated "
             "background connection so the next step's pull overlaps the current "
             "step's gradient compute (sync mode never prefetches).")
    add("--membership_leases", type=parse_bool, nargs="?", const=True, default=True,
        help="Elastic membership: cross-process workers heartbeat a lease on the "
             "coordinator PS shard, so the chief learns the LIVE member set from the "
             "registry.  Off = no lease traffic.")
    add("--lease_ttl_s", type=float, default=10.0,
        help="Membership lease TTL in seconds: a member whose heartbeats stop for "
             "this long is treated as departed.  Heartbeats renew at ttl/3.")
    add("--serve_hosts", default="",
        help="Comma-separated host:port list where --job_name=serve replicas "
             "listen (entry --task_index is this task's bind address).")
    add("--data_service_hosts", default="",
        help="host:port list where --job_name=data_service tasks listen; workers "
             "read them with --data_dir=dsvc://host:port.")
    add("--serve_max_batch", type=int, default=32,
        help="Serving replicas: max rows coalesced into one apply.")
    add("--serve_max_wait_ms", type=float, default=5.0,
        help="Serving replicas: how long a non-full micro-batch waits for more "
             "requests after its first one arrived.")
    add("--serve_queue_depth", type=int, default=128,
        help="Serving replicas: max in-system predict requests before the replica "
             "answers an explicit OVERLOAD status.")
    add("--serve_queue_deadline_ms", type=float, default=0.0,
        help="Serving replicas: a predict that waited in the dispatch queue past "
             "this budget is shed with RETRY_LATER.  0 = no server-side policy.")
    add("--serve_refresh_ms", type=float, default=50.0,
        help="Serving replicas: parameter-store poll cadence (one O(header) round "
             "trip per shard while the published step is unchanged).")
    add("--registry_dir", default="",
        help="Model registry root: training publishes there; a --job_name=serve "
             "replica given --serve_model_version pins one version from it.")
    add("--serve_model_version", type=int, default=0,
        help="Serving replicas: pin this registry version (>= 1) instead of "
             "hot-tracking the PS; 0 = hot-track the live run.")
    add("--ps_shards", type=int, default=-1,
        help="Sharded parameter store: partition the flat vector over this many PS "
             "servers (-1 = one shard per --ps_hosts entry, or per replica pair).")
    add("--ps_replicas", type=int, default=1,
        help="Servers holding EACH shard: 2 gives every shard a primary/backup "
             "pair; --ps_hosts then lists shards*2 entries, replica-major (task i "
             "serves shard i%%shards, replica i//shards).")
    add("--ps_layout_version", type=int, default=0,
        help="PS shard-layout EPOCH carried in every HELLO: a client of another "
             "epoch fails its dial loudly naming both.  0 = unversioned.")
    add("--ps_reshard_to", default="",
        help="Live resharding: makes a --job_name=ps task a JOINER of the layout "
             "epoch 'V:host:port,host:port,...' (V > --ps_layout_version; this task "
             "serves entry --task_index), assembling its slice from the old "
             "topology (--ps_hosts/--ps_shards/--ps_layout_version).")
    add("--tenant", default="default",
        help="The tenant this task belongs to: its PS objects, leases and served "
             "model live in the tenant's namespace ('default' = untagged).")
    add("--tenant_quotas", default="",
        help="Server tasks (ps/serve): per-tenant weighted-fair weights and caps, "
             "'tenant=weight[:max_inflight[:max_dispatch]],...'.")


def is_cross_process_ps(args) -> bool:
    """True when the CLI requests the reference's one-process-per-task PS
    launch (SURVEY.md sections 3.1/3.2): a PS-emulation mode is selected,
    a PS service address is given, and this process was assigned a task
    role.  The ``serve`` job is a model replica that needs both a bind
    address (``--serve_hosts``) and the PS topology it pulls params from;
    the ``data_service`` job needs only ``--data_service_hosts``."""
    job = getattr(args, "job_name", "")
    if job == "data_service":
        return bool(getattr(args, "data_service_hosts", ""))
    if job == "serve":
        return bool(getattr(args, "serve_hosts", "")) and bool(getattr(args, "ps_hosts", ""))
    return (
        job in ("chief", "worker", "ps")
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


def parse_reshard_to(spec: str) -> tuple[int, list[tuple[str, int]]]:
    """Validate a ``--ps_reshard_to`` spec, ``V:host:port,host:port,...``,
    into ``(new_version, new_addrs)``.  A malformed spec fails the launch
    loudly: a typo'd target topology must never half-join a transition."""
    version_s, sep, hosts = spec.partition(":")
    if not sep or not version_s.isdigit() or int(version_s) <= 0:
        raise ValueError(
            f"--ps_reshard_to {spec!r} must be 'V:host:port,...' with a "
            "positive integer epoch V"
        )
    return int(version_s), parse_hostports(hosts, "--ps_reshard_to")


def resolve_legacy_cluster(args) -> dict:
    """The legacy cluster flags of ``args``, logged and mapped; returns the
    reference's info dict: ``ps_hosts`` and ``worker_hosts`` (the lists,
    when given; under PS emulation the validated topology, with
    ``ps_shards`` and ``ps_replicas``) and ``is_legacy_ps_process`` (a
    ``--job_name=ps`` task that is not a cross-process PS task: the CLI
    prints and exits 0)."""
    cross = is_cross_process_ps(args)
    info = {}
    emulation = cross or getattr(args, "ps_emulation", False) or not getattr(
        args, "sync_replicas", True)
    if getattr(args, "ps_hosts", ""):
        if emulation:
            addrs, n_shards, n_replicas = ps_shard_topology(args)
            info["ps_hosts"] = [f"{h}:{p}" for h, p in addrs]
            info["ps_shards"] = n_shards
            info["ps_replicas"] = n_replicas
            log.info(
                "--ps_hosts given with PS emulation: %d host(s), %d shard(s) x %d "
                "replica(s): %s.", len(addrs), n_shards, n_replicas,
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
            "cross-process PS emulation — one worker process per entry" if cross
            else "PS emulation — one worker thread per entry" if emulation
            else "the equivalent data-parallel degree is the world: launch one "
            "process per rank with TF_CONFIG (see parallel.dist, utils.multiprocess).",
        )
    info["is_legacy_ps_process"] = getattr(args, "job_name", "") == "ps" and not cross
    return info


def add_job_name_flag(parser: argparse.ArgumentParser) -> None:
    """``--job_name`` of a CLI that trains: '' or 'worker' trains, 'ps'
    exits 0, and a cross-process PS task role goes to its PS branch (or
    trains, where the CLI has none)."""
    parser.add_argument("--job_name", default="",
                        help="'' or 'worker' trains; 'ps' exits 0 (no PS needed); "
                             "ps/chief/worker with --ps_hosts under PS emulation run "
                             "that task of the PS cluster.")


def exits_as_ps_task(args) -> bool:
    """Resolve the legacy cluster flags; for a ``--job_name=ps`` task that
    hosts no PS service print the notice and return True (the CLI then
    exits 0, as the JAX CLIs do)."""
    if resolve_legacy_cluster(args)["is_legacy_ps_process"]:
        print("job_name=ps: parameter servers are not needed by the port's sync "
              "training; exiting 0.")
        return True
    return False


def train_main(parser: argparse.ArgumentParser, run_training: Callable, argv=None) -> int:
    """The main of a CLI that trains: parse ``argv``, exit 0 on a PS task
    that hosts nothing, refuse a ``--job_name`` other than '' or 'worker'
    outside a cross-process PS launch (whose roles the CLI's PS branch
    runs, or which trains where the CLI has none, as in JAX), else
    ``run_training(args)``."""
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if exits_as_ps_task(args):
        return 0
    if args.job_name not in ("", "worker") and not is_cross_process_ps(args):
        raise SystemExit(f"--job_name={args.job_name}: '' or 'worker' trains; 'ps' exits 0")
    run_training(args)
    return 0
