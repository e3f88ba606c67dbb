"""loadsim of the port: the root ``tools/loadsim.py``'s closed-loop load
simulator and SLO gate over a real multi-process train-and-serve cluster
of the port::

    python -m distributed_tensorflow_examples_tpu_torch.tools.loadsim \\
        [--scenario=chaos|reshard|overload|multitenant|canary] [--qps=100] \\
        [--duration_s=30] [--device=cpu] [--out=verdict.json]

Boots the port's MNIST MLP CLI (``examples/mnist_mlp.py``) as processes,
``python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp
--job_name=...``: supervised PS task(s), the chief and async workers
(``--sync_replicas=false``) and supervised serve replicas.  A closed-loop
generator (:class:`LoadGenerator`) holds ``--qps`` of predicts on a
``serve.ServePool`` whose replicas it discovers from the lease registry,
while the orchestrator drives one scenario's timeline (fractions of the
load window) and scrapes the cluster once a second with the port's
``tools/dtxtop.py`` (``snapshot``: every role's STATS, the lease registry,
the committed reshard epoch, the per-tenant rollup):

- ``chaos`` (the default; ``PHASES``): kills of the PS task, a serve
  replica and a worker, a worker that joins mid-run and one that leaves,
  from one ``DTX_FAULT_PLAN`` (``build_plan``); once the joiner is up,
  ``python -m ...tools.dtxtop --json`` must exit 0 and show its lease.
- ``reshard`` (``RESHARD_PHASES``): the PS tier resized live N -> N+1 -> N
  shards by joiner tasks (``--ps_reshard_to``), a worker killed between
  the transitions; dtxtop's CLI must read the final epoch.
- ``overload`` (``OVERLOAD_PHASES``): replicas of bounded capacity (a wide
  MLP, a small batcher queue, a queue deadline), a baseline, then an
  unpaced burst of ``--burst_threads`` clients in ``--burst_procs``
  processes (``--scenario=burst_child``), then recovery.
- ``multitenant`` (``MULTITENANT_PHASES``): two tenants' training stacks on
  one PS tier and one serve pool with per-tenant quotas; tenant ``runb``
  paced, tenant ``runa`` an unpaced noise fleet mid-run.
- ``canary`` (``CANARY_PHASES``): a stable -> canary -> promoted registry
  version flip with a stable replica killed mid-flip (its own scrape,
  below).

Each scenario's verdict is a function of its records (``chaos_verdict``,
``reshard_verdict``, ``overload_verdict``, ``multitenant_verdict``,
``canary_verdict``) with the root's gates; the verdict is the last stdout
line (and ``--out``), and the tool exits 0 iff every gate holds.  The
tasks run on the card unless ``--device=cpu``.  The orchestrator, its
scrapes and the dtxtop probes import no torch to start; the replicas'
answers are bf16 logits, which the wire hands out as torch tensors, so a
process that predicts imports torch before its load starts (the
orchestrator while the tasks boot, ``warm_torch``; each burst client
before its go line, ``spawn_clients``/``go``).

Where the twin's runs differ from the root's (``ROADMAP.md``, deliberate
differences): the burst and noise clients start with the cluster and
wait for their go line, where the root starts them at the burst's mark
(a client's start would take most of the burst window on a host where
``import torch`` takes ~8 s); ``overload`` and ``multitenant`` start
every task at once (each waits for the PS itself), where the root starts
the chief, workers and replicas once the PS answers, and ``overload``
runs its PS task and replicas unsupervised (nothing kills them, and a
supervisor's start adds an interpreter's imports to each boot).  The
canary's start is the same; its window stretches, by at most 90 s, until
the retired v1 tasks have exited and one scrape has followed; the canary
and its v2 replacements run unsupervised.  The canary's scrape reads the
lease registry and each leased replica's served step and version
(``scrape``), and its per-version rollup is the pool's
(``ServePool.version_stats``: which versions answered since the last
scrape).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..utils.multiprocess import free_ports

#: Verdict schema version (the root's).
VERDICT_SCHEMA_VERSION = 1

#: The chaos timeline: kills first (healed under load), the join while the
#: killed worker's lease expires, the leave last, so the run ends on the
#: joined worker training alone.
PHASES = {
    "kill_ps": 0.20,
    "kill_serve": 0.35,
    "join_worker": 0.45,
    "kill_worker": 0.60,
    "leave_worker": 0.75,
}

#: The reshard timeline: N -> N+1 shards, a worker kill, back to N.
RESHARD_PHASES = {
    "reshard_up": 0.20,
    "kill_worker": 0.45,
    "reshard_down": 0.55,
}

#: The overload timeline: baseline, the unpaced burst, recovery.
OVERLOAD_PHASES = {
    "burst_start": 0.35,
    "burst_end": 0.65,
}

#: The multitenant timeline: runb's baseline, runa's noise, the tail.
MULTITENANT_PHASES = {
    "noise_start": 0.35,
    "noise_end": 0.65,
}

#: The canary timeline: v2 published, the canary up and routed, a stable
#: replica killed, the promote's replacements spawned, the v1 tier retired.
CANARY_PHASES = {
    "publish_v2": 0.18,
    "canary_up": 0.22,
    "kill_serve": 0.40,
    "promote_start": 0.55,
    "retire_old": 0.72,
}

SCENARIOS = ("chaos", "reshard", "overload", "canary", "multitenant", "burst_child")

EXAMPLE = "distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp"
DTXTOP = "distributed_tensorflow_examples_tpu_torch.tools.dtxtop"
MODULE = "distributed_tensorflow_examples_tpu_torch.tools.loadsim"
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_plan(ready_s: float, duration_s: float, join_worker_id: int) -> str:
    """The cluster-wide ``DTX_FAULT_PLAN`` of one kill/join/leave cycle.
    ``after_s`` triggers arm at each process's start, so the offsets add
    the boot window ``ready_s``; the ``join`` spec is the orchestrator's
    own schedule (``faults.join_specs``: it spawns the worker)."""
    t = {k: ready_s + f * duration_s for k, f in PHASES.items()}
    return ";".join([
        f"die:role=ps0,after_s={t['kill_ps']:.1f}",
        f"die:role=serve0,after_s={t['kill_serve']:.1f}",
        f"join:role=worker{join_worker_id},after_s={t['join_worker']:.1f}",
        f"die:role=worker1,after_s={t['kill_worker']:.1f}",
        f"leave:role=worker0,after_s={t['leave_worker']:.1f}",
        # Background client-level chaos: transient drops and delays on the
        # workers' PS legs, healed by reconnect and replay under load.
        "drop_conn:role=worker0,op=25,count=2",
        "delay:role=worker1,op=30,ms=40,count=3",
    ])


class LoadGenerator:
    """Closed-loop predict load at ``qps`` over a ``ServePool``, its
    replicas discovered from the lease registry at ``ps_addrs`` (the
    elastic pool; none given: the static pool).  Every failed predict is
    counted, with the first 20 errors kept.

    ``qps=None`` runs unpaced: each thread re-issues the moment its last
    predict resolves (the burst and noise clients).  ``pool_per_thread``
    gives each thread a ``ServePool`` of its own: a ``ServeClient``
    serialises its ops, so threads sharing one pool hold one request in
    flight a replica, and a burst past the replicas' admission bounds needs
    connections of its own.  ``tenant`` tags every predict.
    :meth:`snap_window` drains the counts since the last snap (a phase's
    goodput and p99) and leaves the totals of :meth:`stop` alone."""

    def __init__(self, ps_addrs, serve_addrs, *, qps: float | None, threads: int = 16,
                 deadline_s: float = 60.0, role: str = "loadsim_sv",
                 op_timeout_s: float | None = 10.0, rows: int = 4,
                 pool_per_thread: bool = False, tenant: str = "default"):
        from ..serve import LeaseServeDiscovery, ServePool

        self.qps = None if qps is None else float(qps)
        self.rows = int(rows)
        self._serve_addrs = list(serve_addrs)
        self._deadline_s = deadline_s
        self._op_timeout_s = op_timeout_s
        self._pool_per_thread = bool(pool_per_thread)
        self.tenant = tenant
        self.role = role
        self.ok = 0
        self.failed = 0
        self.errors: list[str] = []
        self.latencies_ms: list[float] = []
        self._win_ok = 0
        self._win_failed = 0
        self._win_lat: list[float] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.pool = ServePool(list(serve_addrs), role=role, deadline_s=deadline_s,
                              op_timeout_s=op_timeout_s, tenant=tenant)
        self.discovery = (LeaseServeDiscovery(list(ps_addrs), self.pool, poll_s=1.0)
                          if ps_addrs else None)
        n = max(1, threads)
        self._threads = [threading.Thread(target=self._loop, args=(i, n), daemon=True,
                                          name=f"loadsim-gen{i}") for i in range(n)]

    def _loop(self, tid: int, n_threads: int) -> None:
        import numpy as np

        pool = self.pool
        if self._pool_per_thread:
            from ..serve import ServePool

            pool = ServePool(list(self._serve_addrs), role=f"{self.role}{tid}",
                             deadline_s=self._deadline_s, op_timeout_s=self._op_timeout_s,
                             tenant=self.tenant)
        x = np.zeros((self.rows, 784), np.float32)
        period = None if self.qps is None else n_threads / self.qps
        next_t = time.monotonic() + tid * period / n_threads if period is not None else 0.0
        while not self._stop.is_set():
            if period is not None:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(min(next_t - now, 0.05))
                    continue
                next_t += period
            t0 = time.perf_counter()
            try:
                pool.predict({"image": x})
            except Exception as e:  # noqa: BLE001 — every failure is counted
                with self._lock:
                    self.failed += 1
                    self._win_failed += 1
                    if len(self.errors) < 20:
                        self.errors.append(f"{type(e).__name__}: {e}")
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.ok += 1
                self._win_ok += 1
                self.latencies_ms.append(dt_ms)
                self._win_lat.append(dt_ms)
        if pool is not self.pool:
            pool.close()

    def snap_window(self) -> dict:
        """The counts and latencies since the last snap, drained."""
        with self._lock:
            lat = sorted(self._win_lat)
            ok, failed = self._win_ok, self._win_failed
            self._win_lat, self._win_ok, self._win_failed = [], 0, 0
        return {"ok": ok, "failed": failed, "p50_ms": _pct(lat, 0.50), "p99_ms": _pct(lat, 0.99)}

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        if self.discovery is not None:
            self.discovery.close()
        self.pool.close()
        with self._lock:
            lat = sorted(self.latencies_ms)
        return {"predict_ok": self.ok, "predict_failed": self.failed, "errors": self.errors,
                "p50_ms": _pct(lat, 0.50), "p90_ms": _pct(lat, 0.90), "p99_ms": _pct(lat, 0.99)}


def _pct(lat: list[float], p: float) -> float:
    return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3) if lat else 0.0


#: The generator's totals when it never ran (a boot failure).
NEVER_RAN = {"predict_ok": 0, "predict_failed": -1, "errors": ["never ran"],
             "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0}


def launch_task(module, common, job, index, logdir, env, log_name=None):
    """One task of the cluster: ``python -m <module> --job_name=<job>
    --task_index=<index>``, its output appended to ``<logdir>/<name>.log``."""
    log_path = os.path.join(logdir, f"{log_name or f'{job}{index}'}.log")
    f = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *common, f"--job_name={job}", f"--task_index={index}"],
        stdout=f, stderr=subprocess.STDOUT, env=env,
    )
    proc._dtx_log = log_path  # type: ignore[attr-defined]
    proc._dtx_logf = f  # type: ignore[attr-defined]
    return proc


def task_env(plan: str) -> dict:
    """The tasks' environment: the fault plan, no inherited fault role
    (each task derives its own from ``--job_name``/``--task_index``), and
    the checkout on ``PYTHONPATH``.  ~10 task processes share the host:
    one intra-op thread each unless set, so torch's pools (a thread a core
    each) do not oversubscribe it.  A choice of the harness, not a repair:
    with torch's default threads on an 8-core host, predicts failed on an
    exhausted retry budget (ROADMAP.md, section C, Watch)."""
    env = dict(os.environ)
    env.pop("DTX_FAULT_ROLE", None)
    env["DTX_FAULT_PLAN"] = plan
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def warm_torch() -> threading.Thread:
    """Import torch in a thread of its own, to be joined before the load
    starts.  The MLP's replicas answer bf16 logits, which the wire hands
    out as torch tensors, so a process that predicts imports torch at its
    first answer (~8 s on the H100 host): this moves that import into the
    cluster's boot instead of the first predicts' latency."""
    import importlib

    t = threading.Thread(target=importlib.import_module, args=("torch",), daemon=True,
                         name="loadsim-torch")
    t.start()
    return t


def task_argv(args, ps_ports, serve_ports, *, hidden: int, shards: int | None = None,
              replicas: int | None = None, workers: int | None = None,
              restarts: int = 3) -> list[str]:
    """The flags every task of a scenario's cluster shares (the root's):
    async training that outlives the window (loadsim tears the cluster
    down), the PS, worker and serve host lists, the leases' TTL, the
    supervisor's restarts, and ``--device``."""
    shards = args.ps_shards if shards is None else shards
    replicas = args.ps_replicas if replicas is None else replicas
    workers = args.workers if workers is None else workers
    return [
        "--sync_replicas=false",
        "--batch_size=64",
        "--train_steps=1000000",
        f"--hidden_units={hidden}",
        f"--ps_hosts={_hosts(ps_ports)}",
        f"--ps_shards={shards}",
        f"--ps_replicas={replicas}",
        f"--worker_hosts={_hosts(range(7000, 7000 + workers))}",
        f"--serve_hosts={_hosts(serve_ports)}",
        f"--ps_restarts={restarts}",
        f"--lease_ttl_s={args.lease_ttl_s}",
        "--log_every_steps=50",
        *([f"--device={args.device}"] if args.device else []),
    ]


def stop_tasks(procs: dict, term_all: bool = False) -> None:
    """Teardown: the chief and workers killed (the run is over), the
    supervised services sent SIGTERM (forwarded, ending supervision);
    ``term_all`` sends every task SIGTERM."""
    for name, p in procs.items():
        if p.poll() is None:
            term = term_all or name.startswith(("ps", "serve"))
            p.send_signal(signal.SIGTERM if term else signal.SIGKILL)
    deadline = time.monotonic() + 15.0
    for p in procs.values():
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p._dtx_logf.close()


def wait_ps_ready(addrs, deadline_s: float) -> bool:
    from ..parallel import ps_service

    t_end = time.monotonic() + deadline_s
    pending = list(addrs)
    while pending and time.monotonic() < t_end:
        h, p = pending[0]
        try:
            c = ps_service.PSClient(h, p, timeout_s=2.0)
            c.ping()
            c.close()
            pending.pop(0)
        except Exception:  # noqa: BLE001 — not up yet
            time.sleep(0.3)
    return not pending


def wait_serve_ready(addrs, deadline_s: float) -> bool:
    """Every replica at ``addrs`` answers STATS with a loaded model."""
    from ..serve import ServeClient

    t_end = time.monotonic() + deadline_s
    pending = list(addrs)
    while pending and time.monotonic() < t_end:
        h, p = pending[0]
        try:
            c = ServeClient(h, p, op_timeout_s=2.0, reconnect_deadline_s=0.0)
            st = c.stats()
            c.close()
            if int(st.get("model_step", -1)) >= 0:
                pending.pop(0)
                continue
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.3)
    return not pending


def analyze_steps(step_series: list[tuple[float, int]], markers: dict) -> dict:
    """The step verdict of a scrape series: monotone everywhere, strictly
    advancing first to last and past the last marker."""
    steps = [s for _, s in step_series if s >= 0]
    last_marker = max(markers.values()) if markers else 0.0
    after_last = [s for t, s in step_series if t >= last_marker and s >= 0]
    return {
        "step_first": steps[0] if steps else -1,
        "step_last": steps[-1] if steps else -1,
        "step_monotone": all(b >= a for a, b in zip(steps, steps[1:])),
        "step_advanced": len(steps) >= 2 and steps[-1] > steps[0],
        "step_advanced_post_chaos": len(after_last) >= 2 and after_last[-1] > after_last[0],
    }


def _step_of(summary: dict) -> int:
    """The served step of a dtxtop summary: the largest replica's, or -1."""
    steps = summary["serve"]["model_steps"]
    return max(steps) if steps else -1


def _hosts(ports) -> str:
    return ",".join(f"127.0.0.1:{p}" for p in ports)


def _fired_in(p, needle: str) -> bool:
    path = getattr(p, "_dtx_log", "") if p is not None else ""
    try:
        with open(path, "rb") as f:
            return needle.encode() in f.read()
    except OSError:
        return False


def _finish(verdict: dict, args) -> int:
    """Write and print the verdict; 0 iff every gate holds."""
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["slo_pass"] else 1


def _qps(load: dict, window_s: float) -> float:
    return round(load["predict_ok"] / window_s, 2) if window_s > 0 else 0.0


def _dtxtop_cli(ps_hosts: str, shards: int, replicas: int, env: dict) -> tuple[int, dict | None]:
    """``python -m ...tools.dtxtop --json`` against the cluster: its exit
    code and its snapshot (None where its last line is not one)."""
    cli = subprocess.run(
        [sys.executable, "-m", DTXTOP, "--json", f"--ps_hosts={ps_hosts}",
         f"--ps_shards={shards}", f"--ps_replicas={replicas}"],
        capture_output=True, text=True, env=env, timeout=120)
    try:
        return cli.returncode, json.loads(cli.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return cli.returncode, None


# ---------------------------------------------------------------- chaos


def chaos_verdict(rec: dict, load: dict, args) -> dict:
    """The chaos verdict from the run's records: ``step_series`` (time,
    served step) and ``markers`` (the timeline's times), ``window_s``, and
    with chaos the mid-run CLI's ``dtxtop_exit`` and ``join_lease_seen``,
    ``kills_fired`` (task -> fired) and ``leave_fired``."""
    v = {"qps_achieved": _qps(load, rec.get("window_s") or args.duration_s),
         **analyze_steps(rec["step_series"], rec["markers"])}
    gates = {
        "zero_failed_predicts": load["predict_failed"] == 0,
        "p99_under_bound": 0.0 < load["p99_ms"] <= args.p99_bound_ms,
        "qps_at_target": v["qps_achieved"] >= 0.6 * args.qps,
        "step_monotone": v["step_monotone"],
        "step_advanced": v["step_advanced"],
    }
    if not args.no_chaos:
        v["kills_fired"] = rec["kills_fired"]
        v["leave_fired"] = rec["leave_fired"]
        gates["step_advanced_post_chaos"] = v["step_advanced_post_chaos"]
        gates["dtxtop_midrun_exit0"] = rec.get("dtxtop_exit") == 0
        gates["join_lease_seen"] = bool(rec.get("join_lease_seen"))
        gates["kills_fired"] = all(rec["kills_fired"].values())
        gates["leave_fired"] = rec["leave_fired"]
    v["gates"] = gates
    v["slo_pass"] = all(gates.values())
    return v


def run_chaos(args) -> int:
    """The membership-chaos scenario: kills of ps0, serve0 and worker1, a
    worker joined mid-run and worker0's leave under load, with the mid-run
    dtxtop CLI probe."""
    from ..parallel import membership
    from ..utils import faults
    from . import dtxtop

    faults.set_role("loadsim")
    logdir = args.logdir or tempfile.mkdtemp(prefix="dtx-loadsim-")
    os.makedirs(logdir, exist_ok=True)
    n_ps = args.ps_shards * args.ps_replicas
    join_wid = args.workers  # the joiner takes the next task index
    ports = free_ports(n_ps + args.serve_replicas)
    ps_ports, serve_ports = ports[:n_ps], ports[n_ps:]
    ps_addrs = [("127.0.0.1", p) for p in ps_ports]
    serve_addrs = [("127.0.0.1", p) for p in serve_ports]
    plan = "" if args.no_chaos else build_plan(args.boot_offset_s, args.duration_s, join_wid)
    # The joiner's slot rides at the end of the static worker list (the data
    # split needs a worker count; membership comes from the leases).
    common = task_argv(args, ps_ports, serve_ports, hidden=32, workers=args.workers + 1)
    env = task_env(plan)
    procs: dict[str, subprocess.Popen] = {}
    spawn_t: dict[str, float] = {}

    def spawn(job: str, index: int) -> None:
        name = f"{job}{index}"
        spawn_t[name] = time.monotonic()
        procs[name] = launch_task(args.example, common, job, index, logdir, env)

    verdict: dict = {
        "schema_version": VERDICT_SCHEMA_VERSION,
        "metric": "loadsim_slo",
        "qps_target": args.qps,
        "gen_threads": args.gen_threads,
        "duration_s": args.duration_s,
        "p99_bound_ms": args.p99_bound_ms,
        "logdir": logdir,
        "chaos": not args.no_chaos,
        "device": args.device or "cuda",
    }
    gen = None
    rec: dict = {"step_series": [], "markers": {}}
    scrape_fail = 0
    torch_import = warm_torch()
    try:
        for i in range(n_ps):
            spawn("ps", i)
        if not wait_ps_ready(ps_addrs, args.ready_wait_s):
            raise RuntimeError(f"PS tasks never came up (logs: {logdir})")
        spawn("chief", 0)
        for i in range(args.workers):
            spawn("worker", i)
        for i in range(args.serve_replicas):
            spawn("serve", i)
        if not wait_serve_ready(serve_addrs, args.ready_wait_s):
            raise RuntimeError(f"serve replicas never pulled a model (logs: {logdir})")

        torch_import.join()
        gen = LoadGenerator(ps_addrs, serve_addrs, qps=args.qps, threads=args.gen_threads,
                            deadline_s=max(30.0, args.duration_s))
        gen.start()
        t0 = time.monotonic()
        t_end = t0 + args.duration_s
        if not args.no_chaos:
            # The after_s timers arm at each process's own start, not at the
            # load's: the window stretches over every scheduled event plus a
            # grace, so the cycle completes inside the measured run (the
            # fired-event gates prove it did).
            last_event = max(
                spawn_t.get("worker0", t0) + args.boot_offset_s
                + PHASES["leave_worker"] * args.duration_s,
                spawn_t.get("worker1", t0) + args.boot_offset_s
                + PHASES["kill_worker"] * args.duration_s,
            )
            t_end = max(t_end, last_event + 4.0)
        join_at = {s.role: t0 + PHASES["join_worker"] * args.duration_s
                   for s in faults.join_specs(plan)}
        markers = rec["markers"] = {name: t0 + frac * args.duration_s
                                    for name, frac in PHASES.items()}
        midrun_done = joined = False
        while time.monotonic() < t_end:
            for role, when in list(join_at.items()):
                if time.monotonic() >= when:
                    spawn("worker", membership.member_index(role))
                    joined = True
                    faults.log_event("loadsim_join_spawned", member=role)
                    del join_at[role]
            try:
                snap = dtxtop.snapshot(ps_addrs, ps_shards=args.ps_shards,
                                       ps_replicas=args.ps_replicas, timeout_s=3.0)
                rec["step_series"].append((time.monotonic(), _step_of(snap["summary"])))
                verdict["members_last"] = snap["summary"]["members"]
            except Exception:  # noqa: BLE001 — a scrape mid-failover may miss
                scrape_fail += 1
            # The acceptance probe: once the joiner is up, dtxtop's CLI must
            # exit 0 and show its lease.
            if joined and not midrun_done and not args.no_chaos and (
                    time.monotonic() >= markers["join_worker"] + max(3.0, 2 * args.lease_ttl_s)):
                midrun_done = True
                rc, cli_snap = _dtxtop_cli(_hosts(ps_ports), args.ps_shards, args.ps_replicas,
                                           env)
                rec["dtxtop_exit"] = verdict["dtxtop_exit"] = rc
                rec["join_lease_seen"] = verdict["join_lease_seen"] = (
                    cli_snap is not None
                    and f"worker{join_wid}" in cli_snap["summary"]["members"]["workers"])
            time.sleep(1.0)
        rec["window_s"] = verdict["window_s"] = round(time.monotonic() - t0, 1)
    finally:
        load = gen.stop() if gen is not None else dict(NEVER_RAN)
        stop_tasks(procs)

    if not args.no_chaos:
        # The events must have fired inside the run: the task logs show it.
        rec["kills_fired"] = {n: _fired_in(procs.get(n), "event=inject_die")
                              for n in ("ps0", "serve0", "worker1")}
        rec["leave_fired"] = _fired_in(procs.get("worker0"), "event=inject_leave")
    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(chaos_verdict(rec, load, args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    return _finish(verdict, args)



# -------------------------------------------------------------- reshard


def reshard_verdict(rec: dict, load: dict, args) -> dict:
    """The reshard verdict from the run's records: ``step_series``,
    ``spawned_at`` and ``committed_at`` (epoch -> time), ``epochs_seen``,
    the final CLI probe ``dtxtop_probe`` (``exit``, ``committed``), the
    retired PS tasks' exit codes ``old_ps_exit``, and the chief's and the
    killed worker's log findings ``chief_reseeds_seen``,
    ``reshard_commits_seen`` and ``kill_fired``."""
    committed_at, spawned_at = rec["committed_at"], rec["spawned_at"]
    probe = rec["dtxtop_probe"]
    v = {
        "qps_achieved": _qps(load, rec.get("window_s") or args.duration_s),
        "epochs_seen": sorted(rec["epochs_seen"]),
        "transition_s": {str(e): round(committed_at[e] - spawned_at[e], 1)
                         for e in committed_at if e in spawned_at},
        "dtxtop_probe": probe,
        "old_ps_exit": rec["old_ps_exit"],
        **analyze_steps(rec["step_series"],
                        {f"reshard_v{e}": t for e, t in committed_at.items()}),
        "chief_reseeds_seen": rec["chief_reseeds_seen"],
        "reshard_commits_seen": rec["reshard_commits_seen"],
        "kill_fired": rec["kill_fired"],
    }
    gates = {
        "zero_failed_predicts": load["predict_failed"] == 0,
        "p99_under_bound": 0.0 < load["p99_ms"] <= args.p99_bound_ms,
        "qps_at_target": v["qps_achieved"] >= 0.6 * args.qps,
        "step_monotone": v["step_monotone"],
        "step_advanced": v["step_advanced"],
        "step_advanced_post_chaos": v["step_advanced_post_chaos"],
        "zero_reseeds": not v["chief_reseeds_seen"],
        "both_transitions_committed": len(committed_at) == 2,
        "transitions_bounded": bool(v["transition_s"]) and all(
            t <= args.reshard_bound_s for t in v["transition_s"].values()),
        "epochs_all_seen": {1, 2, 3} <= set(rec["epochs_seen"]),
        "dtxtop_probe_exit0": probe.get("exit") == 0,
        "dtxtop_probe_final_epoch": probe.get("committed") == 3,
        "old_ps_drained_exit0": bool(rec["old_ps_exit"]) and all(
            rc == 0 for rc in rec["old_ps_exit"].values()),
    }
    if not args.no_chaos:
        gates["kill_fired"] = v["kill_fired"]
    v["gates"] = gates
    v["slo_pass"] = all(gates.values())
    return v


def run_reshard(args) -> int:
    """The live-resharding scenario: N PS shards (layout epoch 1), N+1
    joiner tasks mid-run (epoch 2), a worker killed while the new layout
    serves, N joiners again (epoch 3), all under predict load."""
    from ..utils import faults
    from . import dtxtop

    faults.set_role("loadsim")
    logdir = args.logdir or tempfile.mkdtemp(prefix="dtx-loadsim-rs-")
    os.makedirs(logdir, exist_ok=True)
    n1 = max(1, args.ps_shards)
    n2 = n1 + 1
    topo_shards = {1: n1, 2: n2, 3: n1}
    ports = free_ports(n1 + n2 + n1 + args.serve_replicas)
    topo_ports = {1: ports[:n1], 2: ports[n1:n1 + n2], 3: ports[n1 + n2:n1 + n2 + n1]}
    serve_ports = ports[n1 + n2 + n1:]
    topo_addrs = {v: [("127.0.0.1", p) for p in topo_ports[v]] for v in (1, 2, 3)}
    serve_addrs = [("127.0.0.1", p) for p in serve_ports]

    def common_for(old_epoch: int) -> list[str]:
        return [*task_argv(args, topo_ports[old_epoch], serve_ports, hidden=32,
                           shards=topo_shards[old_epoch], replicas=1),
                f"--ps_layout_version={old_epoch}"]

    t_kill = args.boot_offset_s + RESHARD_PHASES["kill_worker"] * args.duration_s
    env = task_env("" if args.no_chaos else f"die:role=worker1,after_s={t_kill:.1f}")
    procs: dict[str, subprocess.Popen] = {}

    def spawn(name: str, job: str, index: int, extra=(), old_epoch: int = 1) -> None:
        procs[name] = launch_task(args.example, common_for(old_epoch) + list(extra), job,
                                  index, logdir, env, log_name=name)

    verdict: dict = {
        "schema_version": VERDICT_SCHEMA_VERSION,
        "metric": "loadsim_reshard_slo",
        "qps_target": args.qps,
        "duration_s": args.duration_s,
        "p99_bound_ms": args.p99_bound_ms,
        "reshard_bound_s": args.reshard_bound_s,
        "logdir": logdir,
        "chaos": not args.no_chaos,
        "shards": [n1, n2, n1],
        "device": args.device or "cuda",
    }
    gen = None
    rec: dict = {"step_series": [], "epochs_seen": set(), "committed_at": {},
                 "spawned_at": {}, "dtxtop_probe": {}}
    committed_at, spawned_at = rec["committed_at"], rec["spawned_at"]
    scrape_fail = 0
    torch_import = warm_torch()
    try:
        for i in range(n1):
            spawn(f"ps_v1_{i}", "ps", i)
        if not wait_ps_ready(topo_addrs[1], args.ready_wait_s):
            raise RuntimeError(f"PS tasks never came up (logs: {logdir})")
        spawn("chief0", "chief", 0)
        for i in range(args.workers):
            spawn(f"worker{i}", "worker", i)
        for i in range(args.serve_replicas):
            spawn(f"serve{i}", "serve", i)
        if not wait_serve_ready(serve_addrs, args.ready_wait_s):
            raise RuntimeError(f"serve replicas never pulled a model (logs: {logdir})")

        torch_import.join()
        gen = LoadGenerator(topo_addrs[1], serve_addrs, qps=args.qps, threads=args.gen_threads,
                            deadline_s=max(30.0, args.duration_s))
        gen.start()
        t0 = time.monotonic()
        t_end = t0 + args.duration_s
        markers = {name: t0 + frac * args.duration_s for name, frac in RESHARD_PHASES.items()}
        while time.monotonic() < t_end or (
                len(committed_at) < 2 and time.monotonic() < t_end + 45.0):
            now = time.monotonic()
            if 2 not in spawned_at and now >= markers["reshard_up"]:
                spawned_at[2] = now
                for j in range(n2):
                    spawn(f"ps_v2_{j}", "ps", j, old_epoch=1,
                          extra=[f"--ps_reshard_to=2:{_hosts(topo_ports[2])}"])
                faults.log_event("loadsim_reshard_spawned", version=2)
            if 3 not in spawned_at and now >= markers["reshard_down"] and 2 in committed_at:
                spawned_at[3] = now
                for j in range(n1):
                    spawn(f"ps_v3_{j}", "ps", j, old_epoch=2,
                          extra=[f"--ps_reshard_to=3:{_hosts(topo_ports[3])}"])
                faults.log_event("loadsim_reshard_spawned", version=3)
            # Scrape the newest live tier: a retired tier drains and exits
            # once every client swapped, so the scrape must not stay pinned
            # to a gone coordinator (dtxtop's record-chasing covers the
            # drain window, not a long-gone tier).
            snap = None
            for e in sorted({1, *spawned_at}, reverse=True):
                try:
                    s = dtxtop.snapshot(topo_addrs[e], ps_shards=topo_shards[e], ps_replicas=1,
                                        timeout_s=3.0)
                except Exception:  # noqa: BLE001 — try the next tier
                    continue
                if s["summary"]["roles_ok"] > 0:
                    snap = s
                    break
            if snap is None:
                scrape_fail += 1
            else:
                rec["step_series"].append((time.monotonic(), _step_of(snap["summary"])))
                rec["epochs_seen"].update(snap["summary"]["ps"].get("epochs", []))
                committed = snap["summary"]["ps"]["reshard"].get("committed", 0)
                for e in (2, 3):
                    if committed >= e and e not in committed_at:
                        committed_at[e] = time.monotonic()
                verdict["members_last"] = snap["summary"]["members"]
            # The acceptance probe: after the second commit, dtxtop's CLI
            # must exit 0 against the current tier and read the final epoch.
            if 3 in committed_at and not rec["dtxtop_probe"]:
                rc, s = _dtxtop_cli(_hosts(topo_ports[3]), topo_shards[3], 1, env)
                rec["dtxtop_probe"] = {"exit": rc}
                try:
                    rec["dtxtop_probe"]["committed"] = s["summary"]["ps"]["reshard"]["committed"]
                    rec["dtxtop_probe"]["epochs"] = s["summary"]["ps"]["epochs"]
                except (KeyError, TypeError):
                    rec["dtxtop_probe"]["committed"] = -1
            time.sleep(1.0)
        rec["window_s"] = verdict["window_s"] = round(time.monotonic() - t0, 1)
    finally:
        load = gen.stop() if gen is not None else dict(NEVER_RAN)
        # The retired tiers finish their drain-exit before the verdict
        # reads their exit codes.
        deadline = time.monotonic() + 10.0
        retired = [n for n in procs
                   if n.startswith(("ps_v1_", "ps_v2_")) and len(committed_at) >= 2]
        while time.monotonic() < deadline and any(procs[n].poll() is None for n in retired):
            time.sleep(0.5)
        rec["old_ps_exit"] = {n: procs[n].poll() for n in retired}
        stop_tasks(procs, term_all=True)

    rec["chief_reseeds_seen"] = _fired_in(procs.get("chief0"), "event=chief_reseed")
    rec["reshard_commits_seen"] = _fired_in(procs.get("chief0"), "event=reshard_committed")
    rec["kill_fired"] = _fired_in(procs.get("worker1"), "event=inject_die")
    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(reshard_verdict(rec, load, args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    return _finish(verdict, args)


# ------------------------------------------------------------- overload


def spawn_clients(serve_ports, n_procs: int, threads: int, args, env,
                  tenant: str = "default") -> list[subprocess.Popen]:
    """``n_procs`` burst-client processes (``--scenario=burst_child``),
    ``threads`` unpaced clients each against ``serve_ports``: processes of
    their own, so the orchestrator's interpreter lock does not cap the
    offered load (the real N-clients shape).  Started with the cluster,
    each imports what it needs and waits for :func:`go`, so the burst
    starts at its mark and not a process start later."""
    argv = [sys.executable, "-m", MODULE, "--scenario=burst_child",
            f"--burst_serve_hosts={_hosts(serve_ports)}", f"--gen_threads={threads}",
            f"--burst_rows={args.burst_rows}", f"--burst_tenant={tenant}"]
    return [subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True, env=env)
            for _ in range(n_procs)]


def go(children: list, duration_s: float) -> None:
    """Start the waiting client processes for ``duration_s`` seconds (one
    line on each one's stdin)."""
    for c in children:
        try:
            c.stdin.write(f"{duration_s:.1f}\n")
            c.stdin.flush()
        except OSError:  # a child that died is counted by await_clients
            pass


def await_clients(children: list, scrape, t_off: float) -> tuple[int, int]:
    """Scrape while the client processes run (killed 60 s past ``t_off``),
    then their summed ok and failed predicts (a killed child counts one
    failure)."""
    while any(c.poll() is None for c in children):
        scrape()
        time.sleep(1.0)
        if time.monotonic() > t_off + 60.0:
            for c in children:
                c.kill()
            break
    ok = failed = 0
    for c in children:
        try:
            out, _ = c.communicate(timeout=10.0)
            st = json.loads(out.strip().splitlines()[-1])
            ok += st["predict_ok"]
            failed += st["predict_failed"]
        except (subprocess.TimeoutExpired, IndexError, ValueError, KeyError):
            failed += 1
    return ok, failed


def overload_verdict(rec: dict, load: dict, args) -> dict:
    """The overload verdict from the run's records: the generator's
    windows ``baseline`` and ``burst_paced``, the burst clients'
    ``burst_ok``/``burst_failed``, ``burst_window_s`` (seconds from the
    burst's start to its clients' end), ``recovery_s`` (-1: not within the
    bound), the ``step_series``, dtxtop's ``last_summary`` and the leased
    members before the burst and after recovery."""
    last = rec["last_summary"]
    baseline = rec["baseline"]
    goodput = (rec["burst_paced"]["ok"] + rec["burst_ok"]) / max(0.1, rec["burst_window_s"])
    floor = args.goodput_floor_frac * args.qps
    v = {
        "baseline_p99_ms": baseline["p99_ms"],
        "baseline_ok": baseline["ok"],
        "baseline_failed": baseline["failed"],
        "burst_window_s": round(rec["burst_window_s"], 1),
        "burst_goodput_qps": round(goodput, 2),
        "burst_paced": rec["burst_paced"],
        "burst_ok": rec["burst_ok"],
        "burst_failed": rec["burst_failed"],
        "recovery_s": rec["recovery_s"],
        **analyze_steps(rec["step_series"], {"burst": 0.0}),
        # The admission telemetry of dtxtop's last scrape: sheds show it
        # engaged, and no lease may have expired.
        "shed_total": sum(last.get(k, {}).get("shed_total", 0) for k in ("serve", "ps", "dsvc")),
        "queue_deadline_drops": sum(last.get(k, {}).get("queue_deadline_drops", 0)
                                    for k in ("serve", "ps", "dsvc")),
        "batcher_overloads": last.get("serve", {}).get("overloads", 0),
        "leases_expired": last.get("ps", {}).get("leases_expired", -1),
        "retry": last.get("retry", {}),
        "members_before": sorted(rec["members_before"]),
        "members_after": sorted(rec["members_after"]),
        "goodput_floor_qps": round(floor, 2),
    }
    gates = {
        # The healthy phase is spotless (burst-time failures are the
        # discipline working; the goodput and recovery gates bound them).
        "zero_failed_baseline": v["baseline_failed"] == 0,
        "baseline_served": v["baseline_ok"] > 0,
        # Graceful degradation: admitted work completes at the floor.
        "goodput_floor": goodput >= floor,
        # Control ops are never shed: no heartbeat starved into an expiry,
        # and every member from before the burst is still leased.
        "zero_lease_expirations": v["leases_expired"] == 0,
        "members_retained": set(rec["members_before"]) <= set(rec["members_after"]),
        # No metastability: p99 back under the bounded multiple of the
        # baseline within the recovery bound.
        "p99_recovered_in_bound": v["recovery_s"] >= 0.0,
        "step_monotone": v["step_monotone"],
        "step_advanced": v["step_advanced"],
        # The burst really tripped admission control (a core shed or a
        # batcher refusal): a burst absorbed without it proves nothing.
        "overload_tripped": v["shed_total"] + v["batcher_overloads"] > 0,
    }
    v["gates"] = gates
    v["slo_pass"] = all(gates.values())
    return v


def run_overload(args) -> int:
    """The graceful-degradation scenario: replicas of bounded capacity,
    paced load, an unpaced burst of ``--burst_threads`` clients for the
    middle of the window, then the recovery clock."""
    from ..utils import faults
    from . import dtxtop

    faults.set_role("loadsim")
    logdir = args.logdir or tempfile.mkdtemp(prefix="dtx-loadsim-ov-")
    os.makedirs(logdir, exist_ok=True)
    n_ps = args.ps_shards * args.ps_replicas
    ports = free_ports(n_ps + args.serve_replicas)
    ps_ports, serve_ports = ports[:n_ps], ports[n_ps:]
    ps_addrs = [("127.0.0.1", p) for p in ps_ports]
    serve_addrs = [("127.0.0.1", p) for p in serve_ports]
    common = [
        # Unsupervised: the scenario kills no task, and a supervisor's own
        # start (a second interpreter and its imports) lengthens the boot.
        *task_argv(args, ps_ports, serve_ports, hidden=args.hidden_units, restarts=0),
        # Bounded serve capacity: a wide hidden layer makes an apply cost
        # time (one batch thread a replica), a small max_batch keeps
        # coalescing from buying it back, and the small queue and the queue
        # deadline exercise the shed paths (``overload_tripped`` shows it).
        f"--serve_queue_depth={args.serve_queue_depth}",
        "--serve_max_batch=2",
        "--serve_max_wait_ms=20",
        f"--serve_queue_deadline_ms={args.serve_queue_deadline_ms}",
    ]
    env = task_env("")  # the overload is the fault; no injected chaos
    procs: dict[str, subprocess.Popen] = {}

    def spawn(job: str, index: int) -> None:
        procs[f"{job}{index}"] = launch_task(args.example, common, job, index, logdir, env)

    verdict: dict = {
        "schema_version": VERDICT_SCHEMA_VERSION,
        "metric": "loadsim_overload_slo",
        "qps_target": args.qps,
        "gen_threads": args.gen_threads,
        "burst_threads": args.burst_threads,
        "burst_procs": args.burst_procs,
        "duration_s": args.duration_s,
        "goodput_floor_frac": args.goodput_floor_frac,
        "recovery_bound_s": args.recovery_bound_s,
        "recovery_factor": args.recovery_factor,
        "logdir": logdir,
        "device": args.device or "cuda",
    }
    gen = None
    children: list[subprocess.Popen] = []
    rec: dict = {"step_series": [], "members_before": set(), "members_after": set(),
                 "last_summary": {}}
    scrape_fail = 0
    t_start = time.monotonic()
    timeline = verdict["timeline_s"] = {}

    def mark(name: str) -> None:
        timeline[name] = round(time.monotonic() - t_start, 1)

    def scrape(members: set | None = None) -> None:
        nonlocal scrape_fail
        try:
            snap = dtxtop.snapshot(ps_addrs, ps_shards=args.ps_shards,
                                   ps_replicas=args.ps_replicas, timeout_s=3.0)
        except Exception:  # noqa: BLE001 — a saturated scrape may miss
            scrape_fail += 1
            return
        rec["step_series"].append((time.monotonic(), _step_of(snap["summary"])))
        rec["last_summary"] = snap["summary"]
        if members is not None:
            members.update(snap["summary"]["members"]["workers"],
                           snap["summary"]["members"]["serve"])

    torch_import = warm_torch()
    try:
        # Every task starts at once: each waits for the PS itself, so the
        # tasks' start-up overlaps the PS tasks'.
        for i in range(n_ps):
            spawn("ps", i)
        spawn("chief", 0)
        for i in range(args.workers):
            spawn("worker", i)
        for i in range(args.serve_replicas):
            spawn("serve", i)
        per_proc = max(1, args.burst_threads // args.burst_procs)
        children = spawn_clients(serve_ports, args.burst_procs, per_proc, args, env)
        if not wait_ps_ready(ps_addrs, args.ready_wait_s):
            raise RuntimeError(f"PS tasks never came up (logs: {logdir})")
        mark("ps_ready")
        if not wait_serve_ready(serve_addrs, args.ready_wait_s):
            raise RuntimeError(f"serve replicas never pulled a model (logs: {logdir})")
        mark("serve_ready")

        torch_import.join()
        gen = LoadGenerator(ps_addrs, serve_addrs, qps=args.qps, threads=args.gen_threads,
                            deadline_s=max(30.0, args.duration_s))
        gen.start()
        t0 = time.monotonic()
        t_burst_on = t0 + OVERLOAD_PHASES["burst_start"] * args.duration_s
        t_burst_off = t0 + OVERLOAD_PHASES["burst_end"] * args.duration_s

        # Baseline: the healthy p99 the recovery is held to, and the
        # members whose leases must survive.
        while time.monotonic() < t_burst_on:
            scrape(rec["members_before"])
            time.sleep(1.0)
        rec["baseline"] = gen.snap_window()

        # Burst: unpaced clients in processes of their own, each pool on a
        # short deadline (a burst predict fails fast through its retry
        # budget under saturation: burst failures are expected, not gated).
        mark("burst_on")
        go(children, t_burst_off - time.monotonic())
        faults.log_event("loadsim_burst_on", procs=args.burst_procs, threads=per_proc)
        rec["burst_ok"], rec["burst_failed"] = await_clients(children, scrape, t_burst_off)
        rec["burst_paced"] = gen.snap_window()
        t_recover0 = time.monotonic()
        rec["burst_window_s"] = t_recover0 - t_burst_on
        mark("burst_off")
        faults.log_event("loadsim_burst_off")

        # Recovery: 2 s windows of the paced traffic until one is healthy
        # again (traffic flowing, no failure, p99 under the target), or the
        # bound runs out.
        target_ms = max(args.recovery_factor * rec["baseline"]["p99_ms"],
                        args.recovery_floor_ms)
        verdict["recovery_target_ms"] = round(target_ms, 3)
        recovery_s = None
        windows = verdict["recovery_windows"] = []
        while time.monotonic() < t_recover0 + args.recovery_bound_s:
            t_win = time.monotonic()
            while time.monotonic() < t_win + 2.0:
                scrape()
                time.sleep(1.0)
            w = gen.snap_window()
            windows.append(w)
            if w["ok"] > 0 and w["failed"] == 0 and w["p99_ms"] <= target_ms:
                recovery_s = time.monotonic() - t_recover0
                break
        rec["recovery_s"] = round(recovery_s, 1) if recovery_s is not None else -1.0
        mark("recovered")
        # A short settled tail: the step and lease gates see the recovered
        # cluster, and the members compare with the baseline's.
        t_tail = time.monotonic() + 3.0
        while time.monotonic() < t_tail:
            scrape(rec["members_after"])
            time.sleep(1.0)
        verdict["window_s"] = round(time.monotonic() - t0, 1)
        mark("window_end")
    finally:
        for c in children:
            if c.poll() is None:  # an exception mid-burst: no orphans
                c.kill()
                c.communicate()
        load = gen.stop() if gen is not None else dict(NEVER_RAN)
        stop_tasks(procs)
        mark("torn_down")

    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(overload_verdict(rec, load, args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    return _finish(verdict, args)


# ---------------------------------------------------------- multitenant


def multitenant_verdict(rec: dict, load: dict, args) -> dict:
    """The multitenant verdict from the run's records: the paced runb
    generator's windows ``baseline``, ``noisy`` and ``tail``, the noise
    clients' ``noise_ok``/``noise_failed``, the ``step_series`` and
    dtxtop's ``last_summary`` (its per-tenant rollup)."""
    last = rec["last_summary"]
    tenants = last.get("tenants", {})
    runa, runb = tenants.get("runa", {}), tenants.get("runb", {})
    baseline = rec.get("baseline", {"ok": 0, "failed": -1, "p99_ms": 0.0})
    noisy = rec.get("noisy", {"ok": 0, "failed": -1, "p99_ms": 1e9})
    p99_target = max(args.mt_p99_factor * baseline["p99_ms"], args.mt_p99_floor_ms)
    v = {
        **{k: rec[k] for k in ("baseline", "noisy", "tail", "noise_ok", "noise_failed")
           if k in rec},
        **analyze_steps(rec["step_series"], {"noise": 0.0}),
        "tenants": tenants,
        "leases_expired": last.get("ps", {}).get("leases_expired", -1),
        "noisy_p99_target_ms": round(p99_target, 3),
    }
    gates = {
        # The SLO tenant is spotless end to end.
        "b_zero_failed": load["predict_failed"] == 0,
        "b_baseline_served": baseline["ok"] > 0 and baseline["failed"] == 0,
        # Bounded interference: runb's noisy-window p99 within the factor
        # of its own baseline (an absolute floor for fast hosts).
        "b_p99_bounded": noisy["ok"] > 0 and noisy["p99_ms"] <= p99_target,
        # The noise fleet really offered load.
        "noise_offered": rec.get("noise_ok", 0) + rec.get("noise_failed", 0) > 0,
        # The quota shed the noisy tenant only.
        "a_quota_tripped": runa.get("shed_quota", 0) > 0,
        "b_not_shed": runb.get("shed_total", -1) == 0,
        # Namespace isolation on the shared tier: each tenant's own PS
        # objects and leased members.
        "namespace_isolated": (runa.get("ps_objects", 0) >= 1 and runb.get("ps_objects", 0) >= 1
                               and runa.get("members", 0) >= 1 and runb.get("members", 0) >= 1),
        "zero_lease_expirations": v["leases_expired"] == 0,
        "step_monotone": v["step_monotone"],
        "step_advanced": v["step_advanced"],
    }
    v["gates"] = gates
    v["slo_pass"] = all(gates.values())
    return v


def run_multitenant(args) -> int:
    """The noisy-neighbour scenario: one shared PS tier and serve pool,
    tenant runa's and runb's training stacks over it, runb's paced load,
    and runa's 4x unpaced noise for the middle of the window; the replicas
    carry ``--tenant_quotas``."""
    from ..utils import faults
    from . import dtxtop

    faults.set_role("loadsim")
    logdir = args.logdir or tempfile.mkdtemp(prefix="dtx-loadsim-mt-")
    os.makedirs(logdir, exist_ok=True)
    n_ps = args.ps_shards * args.ps_replicas
    ports = free_ports(n_ps + args.serve_replicas)
    ps_ports, serve_ports = ports[:n_ps], ports[n_ps:]
    ps_addrs = [("127.0.0.1", p) for p in ps_ports]
    serve_addrs = [("127.0.0.1", p) for p in serve_ports]
    base = task_argv(args, ps_ports, serve_ports, hidden=64)
    env = task_env("")  # the noisy neighbour is the fault
    procs: dict[str, subprocess.Popen] = {}

    def spawn(name: str, job: str, index: int, extra=()) -> None:
        procs[name] = launch_task(args.example, base + list(extra), job, index, logdir, env,
                                  log_name=name)

    verdict: dict = {
        "schema_version": VERDICT_SCHEMA_VERSION,
        "metric": "loadsim_multitenant_slo",
        "qps_target": args.qps,
        "gen_threads": args.gen_threads,
        "duration_s": args.duration_s,
        "tenant_quotas": args.mt_quotas,
        "noise_threads": args.mt_noise_threads,
        "noise_procs": args.mt_noise_procs,
        "mt_p99_factor": args.mt_p99_factor,
        "logdir": logdir,
        "device": args.device or "cuda",
    }
    gen = None
    children: list[subprocess.Popen] = []
    rec: dict = {"step_series": [], "last_summary": {}}
    scrape_fail = 0

    def scrape() -> None:
        nonlocal scrape_fail
        try:
            snap = dtxtop.snapshot(ps_addrs, ps_shards=args.ps_shards,
                                   ps_replicas=args.ps_replicas, timeout_s=3.0)
        except Exception:  # noqa: BLE001 — a saturated scrape may miss
            scrape_fail += 1
            return
        rec["step_series"].append((time.monotonic(), _step_of(snap["summary"])))
        rec["last_summary"] = snap["summary"]

    torch_import = warm_torch()
    try:
        # One shared, untenanted PS tier, a training stack a tenant over
        # it, and the shared pool: runb's replicas (they track runb's
        # params) with the per-tenant quotas.  Every task starts at once:
        # each waits for the PS itself.
        for i in range(n_ps):
            spawn(f"ps{i}", "ps", i)
        for t in ("runa", "runb"):
            spawn(f"{t}_chief0", "chief", 0, extra=[f"--tenant={t}"])
            for i in range(args.workers):
                spawn(f"{t}_worker{i}", "worker", i, extra=[f"--tenant={t}"])
        for i in range(args.serve_replicas):
            spawn(f"serve{i}", "serve", i,
                  extra=["--tenant=runb", f"--tenant_quotas={args.mt_quotas}"])
        per_proc = max(1, args.mt_noise_threads // args.mt_noise_procs)
        children = spawn_clients(serve_ports, args.mt_noise_procs, per_proc, args, env,
                                 tenant="runa")
        if not wait_ps_ready(ps_addrs, args.ready_wait_s):
            raise RuntimeError(f"PS tasks never came up (logs: {logdir})")
        if not wait_serve_ready(serve_addrs, args.ready_wait_s):
            raise RuntimeError(f"serve replicas never pulled a model (logs: {logdir})")

        # The SLO tenant's paced generator: every predict tagged runb.
        torch_import.join()
        gen = LoadGenerator(ps_addrs, serve_addrs, qps=args.qps, threads=args.gen_threads,
                            deadline_s=max(30.0, args.duration_s), tenant="runb")
        gen.start()
        t0 = time.monotonic()
        t_noise_on = t0 + MULTITENANT_PHASES["noise_start"] * args.duration_s
        t_noise_off = t0 + MULTITENANT_PHASES["noise_end"] * args.duration_s
        t_end = t0 + args.duration_s

        while time.monotonic() < t_noise_on:
            scrape()
            time.sleep(1.0)
        rec["baseline"] = gen.snap_window()

        # Noise: unpaced tenant-runa clients in processes of their own, on
        # short deadlines (runa's shed predicts are the quota working).
        go(children, t_noise_off - time.monotonic())
        faults.log_event("loadsim_mt_noise_on", procs=args.mt_noise_procs, threads=per_proc)
        rec["noise_ok"], rec["noise_failed"] = await_clients(children, scrape, t_noise_off)
        rec["noisy"] = gen.snap_window()
        faults.log_event("loadsim_mt_noise_off")

        # Tail: runb keeps flowing; the last scrapes carry the rollup.
        while time.monotonic() < t_end:
            scrape()
            time.sleep(1.0)
        rec["tail"] = gen.snap_window()
        verdict["window_s"] = round(time.monotonic() - t0, 1)
    finally:
        for c in children:
            if c.poll() is None:  # an exception mid-noise: no orphans
                c.kill()
                c.communicate()
        load = gen.stop() if gen is not None else dict(NEVER_RAN)
        stop_tasks(procs)

    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(multitenant_verdict(rec, load, args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    return _finish(verdict, args)


def run_burst_child(args) -> int:
    """One burst-client process (``--scenario=burst_child``): it imports
    torch (the replies' bf16 logits decode to torch tensors), waits for a
    line on stdin with the seconds to run (none: the orchestrator went
    away), then runs ``--gen_threads`` unpaced clients, each on a pool of
    its own, against ``--burst_serve_hosts``; its totals are the last
    stdout line."""
    import torch  # noqa: F401 — before the load, not at its first answer

    from ..utils import faults

    faults.set_role("loadsim_burst")
    serve_addrs = [(h, int(p)) for h, _, p in
                   (a.rpartition(":") for a in args.burst_serve_hosts.split(",") if a)]
    line = sys.stdin.readline()
    if not line.strip():
        return 0
    gen = LoadGenerator([], serve_addrs, qps=None, threads=args.gen_threads, deadline_s=3.0,
                        role="loadsim_burst_sv", op_timeout_s=3.0, rows=args.burst_rows,
                        pool_per_thread=True, tenant=args.burst_tenant)
    gen.start()
    time.sleep(float(line))
    print(json.dumps(gen.stop()), flush=True)
    return 0


# --------------------------------------------------------------- canary


def scrape(coord, timeout_s: float = 3.0) -> dict:
    """One canary scrape: the lease registry's members over the
    coordinator client ``coord``, and each leased serve replica's served
    step and version (replicas that do not answer are left out)."""
    from ..parallel import membership
    from ..serve import ServeClient

    members = membership.live_members(coord)
    steps, versions = [], []
    for m in members:
        addr = membership.unpack_addr(m["addr"]) if m["kind"] == "serve" else None
        if addr is None:
            continue
        try:
            c = ServeClient(*addr, op_timeout_s=timeout_s, reconnect_deadline_s=0.0)
            try:
                st = c.stats()
            finally:
                c.close()
        except Exception:  # noqa: BLE001 — a replica mid-restart or retiring
            continue
        steps.append(int(st.get("model_step", -1)))
        versions.append(int(st.get("model_version", 0)))
    return {
        "t": time.monotonic(), "model_steps": steps, "model_versions": versions,
        "members": {"total": len(members),
                    "workers": sorted(m["member"] for m in members if m["kind"] == "worker"),
                    "serve": sorted(m["member"] for m in members if m["kind"] == "serve")},
    }


def versions_answering(now: dict, before: dict) -> list[int]:
    """The versions with more ok predicts in ``ServePool.version_stats()``
    snapshot ``now`` than in ``before``."""
    return sorted(v for v, row in now.items()
                  if v > 0 and row.get("ok", 0) > before.get(v, {}).get("ok", 0))


def canary_verdict(records: list[dict], load: dict, *, canary_frac: float, kill_fired: bool,
                   window_s: float, args) -> dict:
    """The verdict from the scrape ``records`` (``scrape`` rows, each with
    ``by_version``: the versions that answered since the one before) and
    the generator's ``load`` totals."""
    step_series = [(r["t"], max(r["model_steps"]) if r["model_steps"] else -1) for r in records]
    versions = [max(v for v in r["model_versions"] if v > 0) for r in records
                if any(v > 0 for v in r["model_versions"])]
    final = [v for v in records[-1]["model_versions"] if v > 0] if records else []
    both = any({1, 2} <= set(r.get("by_version", ())) for r in records)
    v: dict = {
        "qps_achieved": _qps(load, window_s),
        **analyze_steps(step_series, {"flip": 0.0}),
        "version_first": versions[0] if versions else -1,
        "version_last": versions[-1] if versions else -1,
        "version_monotone": all(b >= a for a, b in zip(versions, versions[1:])),
        "final_versions": final,
        "both_versions_observed": both,
        "kill_fired": kill_fired,
        "canary_frac": canary_frac,
    }
    gates = {
        "zero_failed_predicts": load["predict_failed"] == 0,
        "p99_under_bound": 0.0 < load["p99_ms"] <= args.p99_bound_ms,
        "qps_at_target": v["qps_achieved"] >= 0.6 * args.qps,
        "canary_weight_honored": (canary_frac >= 0.0
                                  and abs(canary_frac - args.canary_weight) <= args.canary_tol),
        "version_monotone": v["version_monotone"],
        "flip_completed": bool(final) and all(x == 2 for x in final),
        "both_versions_observed": both,
        "step_monotone": v["step_monotone"],
        "step_advanced": v["step_advanced"],
    }
    if not args.no_chaos:
        gates["kill_fired"] = kill_fired
    v["gates"] = gates
    v["slo_pass"] = all(gates.values())
    return v


def run_canary(args) -> int:
    """The rolling-deploy scenario; prints the verdict as the last line
    and returns 0 iff every gate holds."""
    from ..parallel import ps_service, ps_shard
    from ..serve.registry import ModelRegistry
    from ..utils import faults

    faults.set_role("loadsim")
    logdir = args.logdir or tempfile.mkdtemp(prefix="dtx-loadsim-cn-")
    os.makedirs(logdir, exist_ok=True)
    # A fresh registry a run: versions are immutable.
    registry_dir = tempfile.mkdtemp(prefix="registry-", dir=logdir)
    n_replicas = max(3, args.serve_replicas)  # the acceptance flips a 3-pool
    n_ps = args.ps_shards * args.ps_replicas
    # Serve ports: [0..R) stable v1, [R] the canary, [R+1..2R] the v2
    # replacements; one --serve_hosts list, the task index selects.
    ports = free_ports(n_ps + 2 * n_replicas + 1)
    ps_ports, serve_ports = ports[:n_ps], ports[n_ps:]
    stable_ports = serve_ports[:n_replicas]
    canary_port = serve_ports[n_replicas]
    replacement_ports = serve_ports[n_replicas + 1 : 2 * n_replicas + 1]
    ps_addrs = [("127.0.0.1", p) for p in ps_ports]
    t_kill = args.boot_offset_s + CANARY_PHASES["kill_serve"] * args.duration_s
    env = task_env("" if args.no_chaos else f"die:role=serve1,after_s={t_kill:.1f}")
    procs: dict[str, subprocess.Popen] = {}

    def common(version: int, restarts: int) -> list[str]:
        return [*task_argv(args, ps_ports, serve_ports, hidden=32, restarts=restarts),
                f"--registry_dir={registry_dir}", f"--serve_model_version={version}"]

    def spawn(name: str, job: str, index: int, version: int = 0, restarts: int = 3) -> None:
        procs[name] = launch_task(args.example, common(version, restarts), job, index, logdir,
                                  env, log_name=name)

    verdict: dict = {
        "schema_version": VERDICT_SCHEMA_VERSION,
        "metric": "loadsim_canary_slo",
        "qps_target": args.qps,
        "duration_s": args.duration_s,
        "p99_bound_ms": args.p99_bound_ms,
        "canary_weight": args.canary_weight,
        "canary_tol": args.canary_tol,
        "replicas": n_replicas,
        "logdir": logdir,
        "chaos": not args.no_chaos,
        "device": args.device or "cuda",
    }
    gen = group = coord = None
    records: list[dict] = []
    scrape_fail = 0
    canary_frac = -1.0
    registry = ModelRegistry(registry_dir)
    t_start = time.monotonic()
    timeline = verdict["timeline_s"] = {}

    def mark(name: str) -> None:
        timeline[name] = round(time.monotonic() - t_start, 1)

    def publish_current(version: int) -> int:
        step, flat = pstore.get()
        if step < 0:
            raise RuntimeError("chief has not published params yet")
        return registry.publish("default", flat, step=int(step), version=version,
                                source="loadsim canary")

    try:
        # The chief and the workers start with the PS tasks: each waits for
        # the PS itself, so their start-up (seconds of imports and the
        # card's context) overlaps the PS tasks'.
        for i in range(n_ps):
            spawn(f"ps{i}", "ps", i)
        spawn("chief0", "chief", 0)
        for i in range(args.workers):
            spawn(f"worker{i}", "worker", i)
        # The orchestrator pulls the live run's params itself to publish the
        # registry versions from (the chief's flat vector, ps_shard's
        # layout); the spec's torch import overlaps the tasks' start.
        from .. import bridge
        from ..models import mlp

        total, _ = bridge.flat_param_spec(mlp.init_numpy(mlp.Config(hidden=(32,)), 0,
                                                         device="cpu"))
        if not wait_ps_ready(ps_addrs, args.ready_wait_s):
            raise RuntimeError(f"PS tasks never came up (logs: {logdir})")
        mark("ps_ready")
        group = ps_shard.ShardedPSClients(ps_addrs[: args.ps_shards], role="loadsim_pub",
                                          op_timeout_s=10.0, replicas=1)
        pstore = ps_shard.ShardedParamStore(group, "params", group.layout_for(total))
        coord = ps_service.PSClient(*ps_addrs[0], timeout_s=3.0)
        t_pub = time.monotonic() + args.ready_wait_s
        while True:
            try:
                if pstore.get()[0] >= 0:
                    break
            except Exception:  # noqa: BLE001 — the chief is still booting
                pass
            if time.monotonic() > t_pub:
                raise RuntimeError("chief never published params to the PS")
            time.sleep(0.5)
        mark("chief_published")
        publish_current(1)
        for i in range(n_replicas):
            spawn(f"serve{i}", "serve", i, version=1)
        stable_addrs = [("127.0.0.1", p) for p in stable_ports]
        if not wait_serve_ready(stable_addrs, args.ready_wait_s):
            raise RuntimeError(f"serve replicas never pinned v1 (logs: {logdir})")
        mark("v1_ready")

        gen = LoadGenerator(ps_addrs, stable_addrs, qps=args.qps, threads=args.gen_threads,
                            deadline_s=max(30.0, args.duration_s))
        gen.start()
        t0 = time.monotonic()
        t_end = t0 + args.duration_s
        markers = {name: t0 + frac * args.duration_s for name, frac in CANARY_PHASES.items()}
        published_v2 = canary_spawned = promoted = retired = False
        canary_base: dict | None = None
        canary_routed_t: float | None = None
        vs_before: dict = {}
        settled = False
        # The window stretches (bounded) until the flip completes, the
        # retired v1 tasks gone and scraped once after: a verdict over half
        # a flip proves nothing.
        while time.monotonic() < t_end or (not settled and time.monotonic() < t_end + 90.0):
            now = time.monotonic()
            if retired and not settled and all(procs[f"serve{i}"].poll() is not None
                                               for i in range(n_replicas)):
                settled = True
                mark("v1_exited")
            if not published_v2 and now >= markers["publish_v2"]:
                published_v2 = True
                publish_current(2)  # the flip's artifact: the current params
                mark("v2_published")
                faults.log_event("loadsim_canary_published", version=2)
            if not canary_spawned and now >= markers["canary_up"]:
                canary_spawned = True
                # The canary and the v2 replacements run unsupervised: the
                # scenario kills neither, and a supervisor's own start
                # (a second interpreter and its imports) would lengthen
                # each of these boot stages.
                spawn("serve_canary", "serve", n_replicas, version=2, restarts=0)
                if wait_serve_ready([("127.0.0.1", canary_port)], args.ready_wait_s):
                    mark("canary_ready")
                    # The weighted split counts from the moment the pool
                    # routes the canary (discovery plus its HELLO version
                    # word), not from the spawn.
                    t_disc = time.monotonic() + 20.0
                    while (time.monotonic() < t_disc
                           and 2 not in gen.pool.known_versions().values()):
                        time.sleep(0.3)
                    gen.pool.set_canary(2, args.canary_weight)
                    canary_base = gen.pool.version_stats()
                    canary_routed_t = time.monotonic()
                    mark("canary_routed")
                    faults.log_event("loadsim_canary_routed")
            if not promoted and now >= markers["promote_start"] and (
                    canary_routed_t is None or now >= canary_routed_t + args.canary_window_s):
                promoted = True
                mark("promote")
                # The canary window closes here: the honoured split before
                # the promote changes the lanes.
                if canary_base is not None:
                    vs = gen.pool.version_stats()
                    d_can = vs.get(2, {}).get("ok", 0) - canary_base.get(2, {}).get("ok", 0)
                    d_tot = (sum(r.get("ok", 0) for r in vs.values())
                             - sum(r.get("ok", 0) for r in canary_base.values()))
                    verdict["canary_ok"] = d_can
                    verdict["canary_window_ok"] = d_tot
                    canary_frac = round(d_can / d_tot, 4) if d_tot else -1.0
                gen.pool.clear_canary()
                for i in range(n_replicas):
                    spawn(f"serve_v2_{i}", "serve", n_replicas + 1 + i, version=2, restarts=0)
                faults.log_event("loadsim_promote_spawned", replicas=n_replicas)
            if promoted and not retired and now >= markers["retire_old"]:
                # Surge: the v1 tier retires only once every v2 replacement
                # answers with its model loaded.
                if wait_serve_ready([("127.0.0.1", p) for p in replacement_ports],
                                    args.ready_wait_s):
                    retired = True
                    for i in range(n_replicas):
                        p = procs.get(f"serve{i}")
                        if p is not None and p.poll() is None:
                            p.send_signal(signal.SIGTERM)
                    mark("v1_retired")
                    faults.log_event("loadsim_old_retired", replicas=n_replicas)
            try:
                rec = scrape(coord)
                vs = gen.pool.version_stats()
                rec["by_version"] = versions_answering(vs, vs_before)
                vs_before = vs
                records.append(rec)
                verdict["members_last"] = rec["members"]
            except Exception:  # noqa: BLE001 — a scrape mid-flip may miss
                scrape_fail += 1
            if not (settled and time.monotonic() >= t_end):
                time.sleep(1.0)
        verdict["window_s"] = round(time.monotonic() - t0, 1)
        mark("window_end")
    finally:
        load = gen.stop() if gen is not None else dict(NEVER_RAN)
        for c in (coord, group):
            if c is not None:
                c.close()
        stop_tasks(procs)

    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(canary_verdict(
        records, load, canary_frac=canary_frac,
        kill_fired=_fired_in(procs.get("serve1"), "event=inject_die"),
        window_s=verdict.get("window_s") or args.duration_s, args=args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    mark("torn_down")
    return _finish(verdict, args)


def parse_args(argv=None) -> argparse.Namespace:
    """The root tool's flags and defaults, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qps", type=float, default=100.0)
    ap.add_argument("--duration_s", type=float, default=30.0)
    ap.add_argument("--gen_threads", type=int, default=16,
                    help="closed-loop generator clients")
    ap.add_argument("--p99_bound_ms", type=float, default=250.0)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--serve_replicas", type=int, default=2)
    ap.add_argument("--ps_shards", type=int, default=1)
    ap.add_argument("--ps_replicas", type=int, default=1)
    ap.add_argument("--lease_ttl_s", type=float, default=3.0)
    ap.add_argument("--ready_wait_s", type=float, default=90.0)
    ap.add_argument("--boot_offset_s", type=float, default=15.0,
                    help="expected boot window baked into the chaos after_s offsets")
    ap.add_argument("--scenario", choices=SCENARIOS, default="chaos",
                    help="chaos = the kill/join/leave cycle; reshard = the live N->N+1->N PS "
                    "resize (one worker kill); overload = the unpaced burst past bounded "
                    "capacity (admission control, deadlines, retry budgets); canary = the "
                    "rolling registry-version flip with a kill mid-flip; multitenant = two "
                    "tenants on one PS tier and serve pool, the noisy one shed by its quota; "
                    "burst_child is internal (one burst or noise client process)")
    ap.add_argument("--canary_weight", type=float, default=0.4,
                    help="fraction of the paced traffic routed to the canary while both lanes "
                    "are live (not the plain round-robin share, so an ignored weight fails)")
    ap.add_argument("--canary_tol", type=float, default=0.12,
                    help="allowed |achieved - weight| of the canary's traffic share")
    ap.add_argument("--canary_window_s", type=float, default=10.0,
                    help="least seconds of weighted routing before the promote may start")
    ap.add_argument("--reshard_bound_s", type=float, default=30.0,
                    help="reshard: the most seconds an epoch transition may take (joiners "
                    "spawned -> commit seen)")
    ap.add_argument("--burst_threads", type=int, default=64,
                    help="overload: unpaced burst clients mid-run (4x the paced 16)")
    ap.add_argument("--burst_procs", type=int, default=4,
                    help="overload: the processes the burst clients are spread over")
    ap.add_argument("--burst_serve_hosts", default="",
                    help="internal (burst_child): the serve hosts to load")
    ap.add_argument("--burst_tenant", default="default",
                    help="internal (burst_child): the tenant the clients tag predicts with")
    ap.add_argument("--mt_quotas", default="runa=1:8:4,runb=3",
                    help="multitenant: the replicas' --tenant_quotas (runa weight 1 with 8 "
                    "in flight / 4 queued a replica, runb weight 3 uncapped)")
    ap.add_argument("--mt_noise_threads", type=int, default=64,
                    help="multitenant: unpaced tenant-runa noise clients mid-run")
    ap.add_argument("--mt_noise_procs", type=int, default=4,
                    help="multitenant: the processes the noise clients are spread over")
    ap.add_argument("--mt_p99_factor", type=float, default=3.0,
                    help="multitenant: runb's noisy-window p99 bound, a multiple of its baseline")
    ap.add_argument("--mt_p99_floor_ms", type=float, default=150.0,
                    help="multitenant: the absolute floor of that bound")
    ap.add_argument("--burst_rows", type=int, default=64,
                    help="overload: rows a burst predict (the paced traffic sends 4)")
    ap.add_argument("--goodput_floor_frac", type=float, default=0.5,
                    help="overload: ok predicts/s during the burst, at least this fraction of "
                    "--qps")
    ap.add_argument("--recovery_bound_s", type=float, default=20.0,
                    help="overload: p99 back under the recovery target within this many "
                    "seconds of the burst's end")
    ap.add_argument("--recovery_factor", type=float, default=1.5,
                    help="overload: the recovery target, a multiple of the baseline p99")
    ap.add_argument("--recovery_floor_ms", type=float, default=50.0,
                    help="overload: the absolute floor of the recovery target")
    ap.add_argument("--serve_queue_depth", type=int, default=8,
                    help="overload: the replicas' bounded predict queue")
    ap.add_argument("--serve_queue_deadline_ms", type=float, default=500.0,
                    help="overload: the replicas' queue deadline (older requests are shed)")
    ap.add_argument("--hidden_units", type=int, default=4096,
                    help="overload: the MLP's width (an apply costs time, bounding a replica)")
    ap.add_argument("--no_chaos", action="store_true")
    ap.add_argument("--out", default="", help="write the verdict JSON here")
    ap.add_argument("--logdir", default="", help="task log directory (default: tmp)")
    ap.add_argument("--example", default=EXAMPLE, help="the CLI module each task runs")
    ap.add_argument("--device", default=None,
                    help="the tasks' torch device; default cuda (no silent CPU)")
    return ap.parse_args(argv)


RUNS = {"chaos": run_chaos, "reshard": run_reshard, "overload": run_overload,
        "canary": run_canary, "multitenant": run_multitenant, "burst_child": run_burst_child}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.scenario == "reshard" and args.ps_shards < 2:
        args.ps_shards = 2  # the acceptance resizes 2 -> 3 -> 2
    return RUNS[args.scenario](args)


if __name__ == "__main__":
    sys.exit(main())
