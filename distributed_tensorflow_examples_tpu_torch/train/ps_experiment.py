"""CLI-level runner for the PS-emulation modes (SURVEY.md D5, section 3.1/3.2):
the port of the thread path of ``distributed_tensorflow_examples_tpu/train/
ps_experiment.py``.

One shared path so every example honors ``--sync_replicas`` uniformly:

- ``--sync_replicas=false``           -> async mode (W2: each worker's
  gradient applies immediately, in arrival order).
- ``--ps_emulation --sync_replicas``  -> token-gated sync_replicas mode (W1:
  accumulate ``--replicas_to_aggregate`` grads, drop stale, chief applies,
  workers proceed on tokens).

Both run on ``parallel.async_ps.AsyncPSTrainer`` (the port's native C++
accumulator / token-queue / gradient-queue services, worker threads
computing gradients on the device) with checkpoint/resume under
``--log_dir/ps_ckpt`` and print the JAX package's FINAL line, field for
field.  ``--deterministic`` selects the fixed round-robin interleave and
turns on ``utils.determinism``.

The reference's one-process-per-task launch (``--job_name=ps|chief|worker``
with ``--ps_hosts``) runs :func:`run_ps_cluster_task` instead: PS tasks
hosting the socket service (host-only, each under a supervisor with
``--ps_restarts``; ``--ps_shards`` shards of ``--ps_replicas`` replicas,
``--ps_hosts`` replica-major), a chief and N workers on the card, or the
chief hosting every server itself (``--ps_tasks=0``); the chief prints
``CHIEF_PLATFORM=`` and the JAX cluster FINAL line
(``mode=sync_replicas_cluster`` or ``async_cluster``).  A ``--ps_reshard_to``
PS task joins a live reshard, and ``--job_name=serve`` hosts a replica
that hot-tracks the PS the run trains (or pins a registry version), and
``--job_name=data_service`` serves ``--data_dir``'s shards to workers
reading ``--data_dir=dsvc://host:port``.

Note on model_state: the emulation keeps non-parameter state at its initial
value — the reference's async-PS scripts hosted only *variables* on PS
tasks.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import sys
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..bridge import params_from_numpy
from ..data.pipeline import to_device
from ..models import layers
from ..utils import device as device_lib

log = logging.getLogger("dtx.ps_experiment")


def worker_count(FLAGS) -> int:
    """Emulated worker count from the legacy cluster flags (the ONE place
    this is computed — CLIs that shard data per worker must use it too)."""
    return max(2, len(FLAGS.worker_hosts.split(",")) if FLAGS.worker_hosts else 2)


def run_ps_emulation(
    *,
    init_fn: Callable,
    loss_fn: Callable,
    optimizer,
    batches_for_worker: Callable[[int, int, int], Iterator[dict]],
    FLAGS,
    mode: str,
    eval_fn: Callable[[Any], dict[str, float]] | None = None,
    model_state: Any = None,
    predict_fn: Callable | None = None,
):
    """Run W1/W2 PS-emulation training on ``FLAGS.device`` (the card unless
    ``cpu``); returns the trainer, with the final params as
    ``trainer.params`` and ``eval_fn``'s metrics as ``trainer.metrics``.
    A cross-process task role runs :func:`run_ps_cluster_task` instead
    (the chief's trainer is returned; None from a PS or worker task).

    ``init_fn(seed) -> params | (params, model_state)``;
    ``batches_for_worker(worker_id, local_batch_size, n_workers)`` yields
    that worker's local numpy batches (its data shard; the count is passed
    so data sharding can never diverge from the thread count);
    ``eval_fn(params)`` computes final metrics for the FINAL line;
    ``predict_fn(params, inputs)`` is the row-wise inference apply a
    ``--job_name=serve`` replica serves (only that role needs it).
    """
    from ..parallel.async_ps import AsyncPSTrainer
    from ..utils import determinism
    from ..utils.flags import is_cross_process_ps

    if is_cross_process_ps(FLAGS):
        return run_ps_cluster_task(
            init_fn=init_fn, loss_fn=loss_fn, optimizer=optimizer,
            batches_for_worker=batches_for_worker, FLAGS=FLAGS, mode=mode,
            eval_fn=eval_fn, model_state=model_state, predict_fn=predict_fn,
        )
    n_workers = worker_count(FLAGS)
    r2a = getattr(FLAGS, "replicas_to_aggregate", 0) or n_workers
    if getattr(FLAGS, "grad_accum", 1) > 1:
        log.warning(
            "--grad_accum=%d is ignored in PS-emulation mode (per-worker "
            "gradients apply individually; accumulation is a mesh-trainer "
            "feature)", FLAGS.grad_accum,
        )
    log.info(
        "PS emulation mode=%s: %d workers%s (native accumulator/token "
        "services; semantics notes in parallel.async_ps)",
        mode,
        n_workers,
        f", replicas_to_aggregate={r2a}" if mode == "sync_replicas" else "",
    )
    if getattr(FLAGS, "deterministic", False):
        determinism.enable()
    acfg = _ps_cfg(FLAGS, mode, n_workers)
    params = init_fn(FLAGS.seed)
    if isinstance(params, tuple):  # init_fn returning (params, model_state)
        params, model_state = params
    trainer = AsyncPSTrainer(
        acfg, loss_fn, optimizer, params, model_state=model_state,
        seed=FLAGS.seed, device=getattr(FLAGS, "device", None),
    )
    local_bs = max(1, FLAGS.batch_size // n_workers)
    t0 = time.perf_counter()
    final_params = trainer.run(
        [iter(batches_for_worker(w, local_bs, n_workers)) for w in range(n_workers)]
    )
    dt = time.perf_counter() - t0  # training window only (eval excluded)

    trainer.metrics = eval_fn(final_params) if eval_fn is not None else {}
    sps = trainer.global_step / dt if dt > 0 else 0.0
    losses = [l for (_, _, l) in trainer.history] or [float("nan")]
    _print_final(
        step=trainer.global_step, dt=dt, mode=mode, metrics=trainer.metrics,
        # Sync mode consumes replicas_to_aggregate worker batches per
        # applied step — count them all, over the run's one device.
        eps_per_chip=sps * local_bs * (r2a if mode == "sync_replicas" else 1),
        extra={
            "stale_dropped": trainer.total_dropped,
            "first_loss": f"{losses[0]:.4f}",
            "last_loss": f"{losses[-1]:.4f}",
        },
    )
    return trainer


def _print_final(
    *, step: int, dt: float, mode: str, metrics: dict, extra: dict, eps_per_chip: float,
):
    """The scrapable FINAL line of the PS paths — the JAX package's fields,
    in its order."""
    sps = step / dt if dt > 0 else 0.0
    parts = [
        f"FINAL step={step}",
        f"steps_per_sec={sps:.1f}",
        f"examples_per_sec_per_chip={eps_per_chip:.0f}",
        f"mode={mode}",
    ]
    for k, v in extra.items():
        parts.append(f"{k}={v}")
    for k, v in metrics.items():
        parts.append(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
    print(" ".join(parts), flush=True)


def _ps_cfg(FLAGS, mode: str, n_workers: int):
    from ..parallel.async_ps import AsyncPSConfig

    r2a = getattr(FLAGS, "replicas_to_aggregate", 0) or n_workers
    return AsyncPSConfig(
        num_workers=n_workers,
        mode=mode,
        replicas_to_aggregate=r2a if mode == "sync_replicas" else None,
        max_staleness=getattr(FLAGS, "max_staleness", None) or None,
        # --deterministic: async applies keep their stale-params semantics
        # but run on the fixed round-robin schedule (reproducible runs).
        fixed_interleave=bool(getattr(FLAGS, "deterministic", False)),
        train_steps=FLAGS.train_steps,
        ckpt_dir=os.path.join(FLAGS.log_dir, "ps_ckpt") if FLAGS.log_dir else None,
        checkpoint_every=FLAGS.checkpoint_every_steps,
        # The cross-process transport's knobs (getattr: embedded callers'
        # namespaces predate them).
        ps_wire_dtype=getattr(FLAGS, "ps_wire_dtype", "f32") or "f32",
        ps_prefetch=bool(getattr(FLAGS, "ps_prefetch", True)),
        membership_leases=bool(getattr(FLAGS, "membership_leases", True)),
        lease_ttl_s=float(getattr(FLAGS, "lease_ttl_s", 10.0) or 10.0),
        tenant=getattr(FLAGS, "tenant", "default") or "default",
    )


def _tenant_quotas(FLAGS):
    """``--tenant_quotas`` parsed into the server core's quota table, or
    None.  A malformed spec fails the server's launch loudly, never serves
    with fairness off."""
    from ..parallel import tenancy

    spec = getattr(FLAGS, "tenant_quotas", "") or ""
    return tenancy.parse_quotas(spec) if spec else None


def _resolve_listen_all(FLAGS, host: str, flag: str = "--ps_hosts") -> bool:
    """Network exposure is an explicit operator decision (--ps_listen_all),
    never inferred from how the hostname is spelled: a non-loopback entry
    without the flag is a launch error, not a silent network-wide bind of
    an unauthenticated service."""
    listen_all = bool(getattr(FLAGS, "ps_listen_all", False))
    if not listen_all and host not in ("127.0.0.1", "localhost"):
        raise ValueError(
            f"{flag} entry {host!r} is not a literal loopback "
            "address; serving other hosts needs the unauthenticated "
            "state service bound on all interfaces — opt in explicitly "
            "with --ps_listen_all (trusted networks only)"
        )
    if listen_all:
        log.warning(
            "--ps_listen_all: PS state service binding ALL interfaces "
            "(UNAUTHENTICATED — trusted networks only)"
        )
    return listen_all


def _probe_ps(host: str, port: int, deadline_s: float) -> bool:
    """True when a PS service answers PING at host:port within the window."""
    from ..parallel import ps_service

    t_end = time.time() + deadline_s
    while time.time() < t_end:
        try:
            c = ps_service.PSClient(host, port, timeout_s=2.0)
            c.ping()
            c.close()
            return True
        except (OSError, ps_service.PSError):
            # A PS that accepts the connection but drops it mid-ping (e.g.
            # mid-restart under the supervisor): keep polling.
            time.sleep(0.2)
    return False


def _relaunch_argv() -> list[str] | None:
    """The command line that launches this process again, ``python -m
    <module>`` for a port CLI (a module of the package; it runs as no
    script); None for any other caller (a test, an embedding program),
    whose argv does not reproduce its configuration."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    package = __name__.rsplit(".", 2)[0]
    if spec is not None and spec.name.startswith(f"{package}.examples."):
        return [sys.executable, "-m", spec.name, *sys.argv[1:]]
    return None


#: Set by a task's supervisor to the restart count of the incarnation it
#: starts (absent in the first).
RESTART_ENV = "DTX_TASK_RESTART"


def _listening(addr: tuple[str, int]) -> bool:
    """Whether a process listens on ``addr``: the kernel completes the dial
    of a listening socket even when its process is starved; a refused dial
    means nobody does."""
    try:
        socket.create_connection(addr, timeout=5.0).close()
    except OSError:
        return False
    return True


def _supervised_reexec(FLAGS, *, child_env_flag: str) -> int | None:
    """Re-exec this launch under ``utils.supervisor.supervise()`` — the PS
    task's crash-heal path.  Returns the supervisor's exit code when THIS
    process acted as the supervisor (the caller exits with it), or None
    when the caller should host the service itself: supervision disabled,
    a launch that cannot be re-executed, or this process IS the supervised
    child (``child_env_flag`` set).  A fault-INJECTED death is healed by
    stripping the fired ``die`` spec from the restarted child's plan, and
    a restarted child learns its restart count (``RESTART_ENV``)."""
    from ..utils import faults

    restarts = int(getattr(FLAGS, "ps_restarts", 0) or 0)
    if restarts <= 0 or os.environ.get(child_env_flag) == "1":
        return None
    argv = _relaunch_argv()
    if argv is None:
        log.warning(
            "--ps_restarts=%d: launcher %r is not a re-executable CLI; hosting "
            "the service unsupervised (a crash falls back to whole-job restart)",
            restarts, sys.argv[:1],
        )
        return None
    from ..utils import supervisor

    env = dict(os.environ)
    env[child_env_flag] = "1"

    def heal_fault_plan(env: dict, attempt: int, returncode: int) -> dict:
        env[RESTART_ENV] = str(attempt)
        # A fault-INJECTED death must not re-fire in the healing
        # incarnation (the plan is inherited through the env).
        if returncode == faults.FAULT_EXIT_CODE and env.get("DTX_FAULT_PLAN"):
            env["DTX_FAULT_PLAN"] = faults.plan_without(
                env["DTX_FAULT_PLAN"], "die", faults.current_role()
            )
            faults.log_event("supervisor_healed_plan", role=faults.current_role(),
                             attempt=attempt)
        return env

    return supervisor.supervise(argv, max_restarts=restarts, env=env,
                                mutate_env=heal_fault_plan)


def _data_service_task(FLAGS, local_bs: int) -> None:
    """The ``data_service`` role: serve ready batches of ``--data_dir``'s
    ``shard-*.npz`` files to training workers that resolve
    ``--data_dir=dsvc://host:port`` (``data/data_service.py``), at the
    workers' local batch.  Host-only, and supervised like the PS task
    (``DTX_DSVC_SUPERVISED``): a killed data server comes back on the same
    port and the clients re-claim their in-flight splits mid-epoch.  With
    ``--ps_hosts`` it watches the coordinator shard's lease registry, so a
    departed worker's splits reassign on the membership signal.  Prints
    ``DSVC_DONE port=``."""
    from ..data import data_service as dsvc_lib
    from ..parallel.membership import coordinator_addrs
    from ..utils.flags import parse_hostports, ps_shard_topology

    ds_hosts = getattr(FLAGS, "data_service_hosts", "") or ""
    if not ds_hosts:
        raise ValueError("--job_name=data_service needs --data_service_hosts "
                         "(host:port this task binds)")
    ds_entries = parse_hostports(ds_hosts, "--data_service_hosts")
    my_host, my_port = ds_entries[min(FLAGS.task_index, len(ds_entries) - 1)]
    listen_all = _resolve_listen_all(FLAGS, my_host, "--data_service_hosts")
    rc = _supervised_reexec(FLAGS, child_env_flag="DTX_DSVC_SUPERVISED")
    if rc is not None:
        if rc != 0:
            raise SystemExit(rc)
        return None
    lease_addrs = None
    if getattr(FLAGS, "ps_hosts", "") and bool(getattr(FLAGS, "membership_leases", True)):
        entries, n_shards, n_replicas = ps_shard_topology(FLAGS)
        lease_addrs = coordinator_addrs(entries, n_shards, n_replicas)
    bound = dsvc_lib.host_data_service_task(
        FLAGS.data_dir, int(my_port), batch_size=local_bs, seed=FLAGS.seed,
        loopback_only=not listen_all, ps_addrs=lease_addrs,
        ps_layout_version=int(getattr(FLAGS, "ps_layout_version", 0) or 0),
        tenant_quotas=_tenant_quotas(FLAGS),
    )
    print(f"DSVC_DONE port={bound}", flush=True)
    return None


def run_ps_cluster_task(
    *, init_fn, loss_fn, optimizer, batches_for_worker, FLAGS, mode, eval_fn=None,
    model_state=None, predict_fn=None,
):
    """One task of the reference's multi-process PS cluster (one process
    per ``--job_name``/``--task_index``, SURVEY.md sections 3.1/3.2), over
    the port's socket service:

    - ``ps``:     hosts the C++ state service at ``--ps_hosts[task_index]``
                  until the chief signals shutdown (``server.join()``
                  role); host-only, it never touches the card.  Task i
                  serves shard ``i % shards``, replica ``i // shards``; with
                  ``--ps_replicas=2`` its peer is the other replica of the
                  shard, which a restarted task catches up from.  Runs
                  under ``utils.supervisor`` with ``--ps_restarts``.  With
                  ``--ps_reshard_to`` the task JOINS a live reshard as
                  entry ``task_index`` of the target topology.  Prints
                  ``PS_DONE port=``.
    - ``chief``:  the aggregation/apply/publish loop (``RemotePSChief``) on
                  ``--device``.  With ``--ps_tasks=0`` the chief hosts every
                  shard server in-process; otherwise it waits (120 s) for
                  each PS task.  Prints ``CHIEF_PLATFORM=`` (``gpu`` on the
                  card, ``cpu`` when asked for) and the JAX cluster FINAL
                  line; returns the trainer.
    - ``worker``: gradient computation against the published snapshots
                  on ``--device`` (``remote_worker_loop``), data-sharded by
                  ``task_index``.  Prints ``WORKER_DONE task= contributed=``.
    - ``serve``:  a replica at ``--serve_hosts[task_index]`` that hot-tracks
                  the parameter store these shard servers host and serves
                  micro-batched predicts of ``predict_fn`` on ``--device``
                  (or pins ``--serve_model_version`` of ``--registry_dir``);
                  supervised like the PS task (``DTX_SERVE_SUPERVISED``).
                  Prints ``SERVE_DONE port=``.
    - ``data_service``: serves ``--data_dir``'s ``.npz`` shards as ready
                  batches of ``batch_size // workers`` rows at
                  ``--data_service_hosts[task_index]``, supervised
                  (``DTX_DSVC_SUPERVISED``); host-only.  Prints
                  ``DSVC_DONE port=`` (:func:`_data_service_task`).

    The topology: shard i's primary is ``--ps_hosts`` entry i, replica r of
    shard i entry ``r * shards + i``; shard 0 is the coordinator (tokens,
    leases, the reshard record).  Each task gets a fault role (``ps0``,
    ``chief0``, ``worker<i>``, ``serve<i>``, ``data_service<i>``) for
    ``DTX_FAULT_PLAN`` matching.
    """
    from ..parallel import async_ps
    from ..parallel.membership import coordinator_addrs
    from ..parallel.ps_shard import replica_major
    from ..utils import faults, telemetry
    from ..utils.flags import parse_hostports, parse_reshard_to, ps_shard_topology

    job = FLAGS.job_name
    n_workers = worker_count(FLAGS)
    local_bs = max(1, FLAGS.batch_size // n_workers)
    if not faults.current_role():
        faults.set_role(f"{job}{FLAGS.task_index}")
    # Every role of the cluster dumps its flight recorder to one place.
    obs_dir = getattr(FLAGS, "obs_events_dir", "") or ""
    if obs_dir and not os.environ.get(telemetry.EVENTS_DIR_ENV):
        os.environ[telemetry.EVENTS_DIR_ENV] = obs_dir

    if job == "data_service":
        return _data_service_task(FLAGS, local_bs)
    entries, n_shards, n_replicas = ps_shard_topology(FLAGS)
    shard_addrs = entries[: n_shards * n_replicas]
    primary_addrs = entries[:n_shards]
    layout_version = int(getattr(FLAGS, "ps_layout_version", 0) or 0)
    host, port = shard_addrs[0]

    if job == "serve":
        from ..serve import host_serve_task

        if predict_fn is None:
            raise ValueError(
                "--job_name=serve needs a predict_fn (the row-wise inference apply) "
                "passed through run_ps_emulation / run_ps_cluster_task")
        sv_hosts = getattr(FLAGS, "serve_hosts", "") or ""
        if not sv_hosts:
            raise ValueError("--job_name=serve needs --serve_hosts (host:port this "
                             "replica binds)")
        sv_entries = parse_hostports(sv_hosts, "--serve_hosts")
        my_host, my_port = sv_entries[min(FLAGS.task_index, len(sv_entries) - 1)]
        listen_all = _resolve_listen_all(FLAGS, my_host, "--serve_hosts")
        rc = _supervised_reexec(FLAGS, child_env_flag="DTX_SERVE_SUPERVISED")
        if rc is not None:
            if rc != 0:
                raise SystemExit(rc)
            return None
        for sh, sp in primary_addrs:
            if not _probe_ps(sh, sp, 120.0):
                raise ConnectionError(f"no PS service at {sh}:{sp} after 120 s (the serve "
                                      "replica pulls its params from there)")
        template = init_fn(FLAGS.seed)
        if isinstance(template, tuple):
            template = template[0]
        bound = host_serve_task(
            param_shapes=template, predict_fn=predict_fn,
            # The full replica-major list: the replica's PS legs fail over
            # like the trainers', and its refresher follows committed
            # layout epochs of the same topology.
            ps_addrs=shard_addrs, ps_replicas=n_replicas, layout_version=layout_version,
            port=int(my_port), device=getattr(FLAGS, "device", None),
            loopback_only=not listen_all,
            max_batch=int(getattr(FLAGS, "serve_max_batch", 32)),
            max_wait_ms=float(getattr(FLAGS, "serve_max_wait_ms", 5.0)),
            queue_depth=int(getattr(FLAGS, "serve_queue_depth", 128)),
            queue_deadline_ms=float(getattr(FLAGS, "serve_queue_deadline_ms", 0.0)),
            refresh_ms=float(getattr(FLAGS, "serve_refresh_ms", 50.0)),
            membership=bool(getattr(FLAGS, "membership_leases", True)),
            lease_ttl_s=float(getattr(FLAGS, "lease_ttl_s", 10.0) or 10.0),
            advertise_addr=f"{my_host}:{my_port}",
            metrics_dir=(os.path.join(FLAGS.log_dir, f"serve{FLAGS.task_index}")
                         if getattr(FLAGS, "log_dir", None) else None),
            registry_dir=getattr(FLAGS, "registry_dir", "") or None,
            model_version=int(getattr(FLAGS, "serve_model_version", 0) or 0) or None,
            tenant=getattr(FLAGS, "tenant", "default") or "default",
            tenant_quotas=_tenant_quotas(FLAGS),
        )
        print(f"SERVE_DONE port={bound}", flush=True)
        return None

    acfg = _ps_cfg(FLAGS, mode, n_workers)
    if acfg.fixed_interleave:
        # Real processes free-run: no scheduler fixes their interleaving.
        log.warning(
            "--deterministic: the fixed async interleave applies only to the "
            "single-process emulation; cross-process cluster ordering remains "
            "arrival-order nondeterministic.")
        acfg = dataclasses.replace(acfg, fixed_interleave=False)
    chief_hosts_service = FLAGS.ps_tasks == 0

    if job == "ps":
        if chief_hosts_service:
            raise ValueError(
                "--job_name=ps contradicts --ps_tasks=0 (chief hosts the service); "
                "launch without the PS task or drop --ps_tasks=0")
        reshard_spec = getattr(FLAGS, "ps_reshard_to", "") or ""
        lease_ttl_s = float(getattr(FLAGS, "lease_ttl_s", 10.0) or 10.0)
        tid = FLAGS.task_index
        if reshard_spec:
            # A live-reshard JOINER: serves shard --task_index of the target
            # topology, assembling its slice from the old one (--ps_hosts,
            # --ps_shards, --ps_layout_version) before it carries data.
            new_version, new_entries = parse_reshard_to(reshard_spec)
            if new_version <= layout_version:
                raise ValueError(
                    f"--ps_reshard_to epoch {new_version} must exceed the old "
                    f"--ps_layout_version {layout_version}")
            if tid >= len(new_entries):
                raise ValueError(f"--task_index={tid} exceeds the {len(new_entries)}-entry "
                                 "--ps_reshard_to topology")
            my_host, my_port = new_entries[tid]
            listen_all = _resolve_listen_all(FLAGS, my_host, "--ps_reshard_to")
            task_kw = dict(
                shard_id=tid, shard_count=len(new_entries), layout_version=new_version,
                coordinator_addrs=[new_entries[0]], lease_ttl_s=lease_ttl_s,
                reshard_from={"addrs": shard_addrs, "shards": n_shards,
                              "replicas": n_replicas, "version": layout_version,
                              "new_addrs": new_entries})
        else:
            tid = min(tid, len(entries) - 1)
            my_host, my_port = entries[tid]
            listen_all = _resolve_listen_all(FLAGS, my_host)
            if tid >= n_shards * n_replicas:
                # Extra PS tasks beyond the shard/replica grid own no slice:
                # an unsharded-identity service nothing dials.
                log.warning("PS task %d exceeds --ps_shards=%d x --ps_replicas=%d: no "
                            "shard assigned (idle)", tid, n_shards, n_replicas)
                task_kw = {}
            else:
                # Task i serves shard i % shards, replica i // shards.  Its
                # PEER is the other replica of the shard, which a start
                # catches up from before serving.  At a cold start the
                # primary waits briefly (its peer may be waiting on it) and
                # the backup generously (its primary is booting too).  A
                # RESTARTED incarnation whose peer still listens catches up
                # from the survivor that holds the state, so it waits as
                # long as a backup does: a primary that gave up after 2 s
                # on a loaded host served an empty shard beside its peer's
                # state (fault C9).  A peer that refuses the dial is gone
                # (the run ended): the short wait, then a cold start.
                s_id, r_id = tid % n_shards, tid // n_shards
                task_kw = dict(shard_id=s_id, shard_count=n_shards,
                               layout_version=layout_version,
                               coordinator_addrs=coordinator_addrs(entries, n_shards,
                                                                   n_replicas))
                if n_replicas == 2:
                    pair = replica_major(list(range(n_shards * n_replicas)), n_shards,
                                         n_replicas)[s_id]
                    peer_tid = pair[(r_id + 1) % 2]
                    long_wait = r_id != 0 or (
                        int(os.environ.get(RESTART_ENV, "0")) > 0
                        and _listening(entries[peer_tid]))
                    task_kw.update(peer=entries[peer_tid], peer_role=f"ps{peer_tid}",
                                   sync_wait_s=45.0 if long_wait else 2.0)
        rc = _supervised_reexec(FLAGS, child_env_flag="DTX_PS_SUPERVISED")
        if rc is not None:
            if rc != 0:
                raise SystemExit(rc)
            return None
        bound = async_ps.host_ps_task(int(my_port), loopback_only=not listen_all, **task_kw)
        # A host-only task: it must never have touched the card.
        log.info("PS task: CUDA initialized=%s", torch.cuda.is_initialized())
        print(f"PS_DONE port={bound}", flush=True)
        return None

    if job == "chief":
        faults.arm_process_faults()
        dev = device_lib.resolve(getattr(FLAGS, "device", None))
        params = init_fn(FLAGS.seed)
        if isinstance(params, tuple):
            params, model_state = params
        if not chief_hosts_service:
            for sh, sp in shard_addrs:
                if not _probe_ps(sh, sp, 120.0):
                    raise ConnectionError(
                        f"no PS task answered at {sh}:{sp} after 120 s (launch every "
                        "--job_name=ps shard process first, or pass --ps_tasks=0 to host "
                        "the service in the chief)")
        log.info("PS cluster chief: mode=%s %d workers, %d shard(s) x %d replica(s) at %s "
                 "(%s)", mode, n_workers, n_shards, n_replicas,
                 ",".join(f"{h}:{p}" for h, p in shard_addrs),
                 "hosted in-process" if chief_hosts_service else "PS tasks")
        # The platform under JAX's names: the chief really runs on the card.
        print(f"CHIEF_PLATFORM={'gpu' if dev.type == 'cuda' else dev.type}", flush=True)
        trainer = async_ps.RemotePSChief(
            acfg, loss_fn, optimizer, params, model_state=model_state, seed=FLAGS.seed,
            device=dev, ps_replicas=n_replicas, layout_version=layout_version,
            **({"ports": [p for _, p in shard_addrs],
                "listen_all": any(_resolve_listen_all(FLAGS, h) for h, _ in shard_addrs)}
               if chief_hosts_service else {"ps_addrs": shard_addrs}),
        )
        try:
            t0 = time.perf_counter()
            trainer.run_chief()
            dt = time.perf_counter() - t0
            trainer.metrics = eval_fn(trainer.params) if eval_fn is not None else {}
        finally:
            trainer.close()
        sps = trainer.global_step / dt if dt > 0 else 0.0
        r2a = (acfg.replicas_to_aggregate or n_workers) if mode == "sync_replicas" else 1
        _print_final(
            step=trainer.global_step, dt=dt, mode=f"{mode}_cluster", metrics=trainer.metrics,
            # Every worker batch of an applied step, over the chief's one
            # device (a JAX chief divides by its host's chips).
            eps_per_chip=sps * local_bs * r2a,
            extra={"workers": n_workers, "stale_dropped": trainer.total_dropped},
        )
        return trainer

    # job == "worker"
    faults.arm_process_faults()
    wid = FLAGS.task_index
    for sh, sp in shard_addrs:
        if not _probe_ps(sh, sp, 120.0):
            raise ConnectionError(f"no PS service at {sh}:{sp} after 120 s")
    n = async_ps.remote_worker_loop(
        host, port, wid, cfg=acfg, loss_fn=loss_fn, init_fn=init_fn,
        batches=iter(batches_for_worker(wid, local_bs, n_workers)),
        model_state=model_state, seed=FLAGS.seed, device=getattr(FLAGS, "device", None),
        addrs=shard_addrs, ps_replicas=n_replicas, layout_version=layout_version,
        metrics_dir=os.path.join(FLAGS.log_dir, f"worker{wid}") if FLAGS.log_dir else None,
        metrics_every=max(1, getattr(FLAGS, "log_every_steps", 20) or 20),
    )
    print(f"WORKER_DONE task={wid} contributed={n}", flush=True)
    return None


def array_eval_fn(apply_logits: Callable, test: dict[str, np.ndarray], batch_size: int,
                  device=None):
    """Standard accuracy eval over array test splits for the FINAL line: the
    mean over the complete batches of ``min(batch_size, n)`` rows, on
    ``device`` (the card unless ``cpu``)."""

    def eval_fn(params):
        dev = device_lib.resolve(device)
        p = params_from_numpy(params, dev)
        n = len(test["label"])
        ebs = min(batch_size, n)
        with torch.no_grad():
            accs = [
                float(layers.accuracy(apply_logits(p, b), b["label"]))
                for b in (to_device({k: v[i : i + ebs] for k, v in test.items()}, dev)
                          for i in range(0, (n // ebs) * ebs, ebs))
            ]
        return {"test_accuracy": float(np.mean(accs))}

    return eval_fn

