"""loadsim of the port: the root ``tools/loadsim.py``'s canary scenario
over a real multi-process train-and-serve cluster of the port::

    python -m distributed_tensorflow_examples_tpu_torch.tools.loadsim --scenario=canary \\
        [--qps=100] [--duration_s=30] [--canary_weight=0.4] [--canary_tol=0.12] [--device=cpu]

Boots the port's MNIST MLP CLI (``examples/mnist_mlp.py``) as processes,
``python -m distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp
--job_name=...``: supervised PS task(s), the chief and async workers
(``--sync_replicas=false``), and serve replicas pinned to registry
versions (``--registry_dir``, ``--serve_model_version``).  A closed-loop
generator (:class:`LoadGenerator`) holds ``--qps`` of predicts on a
``serve.ServePool`` whose replicas it discovers from the lease registry,
while the orchestrator drives a whole stable -> canary -> promoted
version flip (``CANARY_PHASES``, fractions of the load window):

- the training run's params publish to the registry as v1, and three
  replicas pin it;
- mid-run the current params publish as v2, one canary replica pins it,
  and ``--canary_weight`` of the traffic routes to it
  (``ServePool.set_canary``; a replica's version rides its HELLO word);
- a stable replica is killed during the flip (``DTX_FAULT_PLAN``); its
  supervisor restarts it, pinned to v1 again;
- the promote spawns v2 replacements, then retires every v1 task once
  they all answer (surge).  The canary and the replacements run without
  a supervisor (the root supervises every replica; nothing kills these,
  and a supervisor's start adds seconds to each boot).  The window stretches, by at most 90 s, until
  the retired tasks have exited and one scrape has followed (the root
  tool stops at the retire when the window has passed, and a replica
  that has not yet exited still answers as v1).

The cluster is scraped once a second: the lease registry's members
(``parallel/membership.py``) and each leased replica's stats (its served
step and version), and the pool's per-version rollup
(``ServePool.version_stats``: which versions answered since the last
scrape).  The verdict (last stdout line, and ``--out``) holds the root's
gates: zero failed predicts, p99 under ``--p99_bound_ms``, at least 60%
of ``--qps`` achieved, the canary's share of the traffic within
``--canary_tol`` of ``--canary_weight``, the served version monotone and
all v2 at the end, both versions answering mid-flip, the served step
monotone and advancing, and (unless ``--no_chaos``) the kill fired.  The
tool exits 0 iff every gate holds.  The tasks run on the card unless
``--device=cpu``.  The root's other scenarios (chaos, reshard, overload,
multitenant) are not ported: ``--scenario`` with one of them exits
non-zero.
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

#: The canary scenario's timeline, as fractions of the load window: v2
#: published, the canary up and routed, a stable replica killed, the
#: promote's replacements spawned, the v1 tier retired.
CANARY_PHASES = {
    "publish_v2": 0.18,
    "canary_up": 0.22,
    "kill_serve": 0.40,
    "promote_start": 0.55,
    "retire_old": 0.72,
}

#: The root tool's scenarios; only ``canary`` has a port.
SCENARIOS = ("chaos", "reshard", "overload", "canary", "multitenant", "burst_child")
PORTED = ("canary",)

EXAMPLE = "distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp"
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class LoadGenerator:
    """Closed-loop predict load at ``qps`` over a ``ServePool``, its
    replicas discovered from the lease registry at ``ps_addrs`` (the
    elastic pool).  Every failed predict is counted, with the first 20
    errors kept."""

    def __init__(self, ps_addrs, serve_addrs, *, qps: float, threads: int = 16,
                 deadline_s: float = 60.0, role: str = "loadsim_sv",
                 op_timeout_s: float | None = 10.0, rows: int = 4):
        from ..serve import LeaseServeDiscovery, ServePool

        self.qps = float(qps)
        self.rows = int(rows)
        self.ok = 0
        self.failed = 0
        self.errors: list[str] = []
        self.latencies_ms: list[float] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.pool = ServePool(list(serve_addrs), role=role, deadline_s=deadline_s,
                              op_timeout_s=op_timeout_s)
        self.discovery = (LeaseServeDiscovery(list(ps_addrs), self.pool, poll_s=1.0)
                          if ps_addrs else None)
        n = max(1, threads)
        self._threads = [threading.Thread(target=self._loop, args=(i, n), daemon=True,
                                          name=f"loadsim-gen{i}") for i in range(n)]

    def _loop(self, tid: int, n_threads: int) -> None:
        import numpy as np

        x = np.zeros((self.rows, 784), np.float32)
        period = n_threads / self.qps
        next_t = time.monotonic() + tid * period / n_threads
        while not self._stop.is_set():
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(next_t - now, 0.05))
                continue
            next_t += period
            t0 = time.perf_counter()
            try:
                self.pool.predict({"image": x})
            except Exception as e:  # noqa: BLE001 — every failure is counted
                with self._lock:
                    self.failed += 1
                    if len(self.errors) < 20:
                        self.errors.append(f"{type(e).__name__}: {e}")
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.ok += 1
                self.latencies_ms.append(dt_ms)

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


def scrape(coord, timeout_s: float = 3.0) -> dict:
    """One scrape: the lease registry's members over the coordinator
    client ``coord``, and each leased serve replica's served step and
    version (replicas that do not answer are left out)."""
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
        "qps_achieved": round(load["predict_ok"] / window_s, 2) if window_s > 0 else 0.0,
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


def _fired_in(p, needle: str) -> bool:
    path = getattr(p, "_dtx_log", "") if p is not None else ""
    try:
        with open(path, "rb") as f:
            return needle.encode() in f.read()
    except OSError:
        return False


def run_canary(args) -> int:
    """The rolling-deploy scenario; prints the verdict as the last line
    and returns 0 iff every gate holds."""
    from .. import bridge
    from ..models import mlp
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
    env = dict(os.environ)
    env.pop("DTX_FAULT_ROLE", None)
    env["DTX_FAULT_PLAN"] = "" if args.no_chaos else f"die:role=serve1,after_s={t_kill:.1f}"
    # ~10 task processes share the host: one intra-op thread each unless
    # set, so torch's pools (a thread a core each) do not oversubscribe it.
    # A choice of the harness, not a repair: with torch's default threads
    # on an 8-core host, predicts failed on an exhausted retry budget
    # (ROADMAP.md, section C, Watch).
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
    procs: dict[str, subprocess.Popen] = {}

    def common(version: int, restarts: int) -> list[str]:
        argv = [
            "--sync_replicas=false",
            "--batch_size=64",
            "--train_steps=1000000",  # outlives the window; loadsim tears down
            "--hidden_units=32",
            f"--ps_hosts={','.join(f'127.0.0.1:{p}' for p in ps_ports)}",
            f"--ps_shards={args.ps_shards}",
            f"--ps_replicas={args.ps_replicas}",
            f"--worker_hosts={','.join(f'127.0.0.1:{7000 + i}' for i in range(args.workers))}",
            f"--serve_hosts={','.join(f'127.0.0.1:{p}' for p in serve_ports)}",
            f"--ps_restarts={restarts}",
            f"--lease_ttl_s={args.lease_ttl_s}",
            "--log_every_steps=50",
            f"--registry_dir={registry_dir}",
            f"--serve_model_version={version}",
        ]
        return argv + ([f"--device={args.device}"] if args.device else [])

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
    # The orchestrator pulls the live run's params itself to publish the
    # registry versions from (the chief's flat vector, ps_shard's layout).
    total, _ = bridge.flat_param_spec(mlp.init_numpy(mlp.Config(hidden=(32,)), 0, device="cpu"))
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
        load = gen.stop() if gen is not None else {
            "predict_ok": 0, "predict_failed": -1, "errors": ["never ran"],
            "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0,
        }
        for c in (coord, group):
            if c is not None:
                c.close()
        for name, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM if name.startswith(("ps", "serve"))
                              else signal.SIGKILL)
        deadline = time.monotonic() + 15.0
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p._dtx_logf.close()

    verdict.update(load)
    verdict["scrape_failures"] = scrape_fail
    verdict.update(canary_verdict(
        records, load, canary_frac=canary_frac,
        kill_fired=_fired_in(procs.get("serve1"), "event=inject_die"),
        window_s=verdict.get("window_s") or args.duration_s, args=args))
    verdict["loadsim_p99_ms"] = load["p99_ms"]
    mark("torn_down")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["slo_pass"] else 1


def parse_args(argv=None) -> argparse.Namespace:
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
                    help="expected boot window baked into the kill's after_s offset")
    ap.add_argument("--scenario", choices=SCENARIOS, default="chaos",
                    help="canary = the rolling registry-version flip (stable -> canary -> "
                    "promoted with a kill mid-flip); the root's other scenarios are not ported")
    ap.add_argument("--canary_weight", type=float, default=0.4,
                    help="fraction of the paced traffic routed to the canary while both lanes "
                    "are live (not the plain round-robin share, so an ignored weight fails)")
    ap.add_argument("--canary_tol", type=float, default=0.12,
                    help="allowed |achieved - weight| of the canary's traffic share")
    ap.add_argument("--canary_window_s", type=float, default=10.0,
                    help="least seconds of weighted routing before the promote may start")
    ap.add_argument("--no_chaos", action="store_true")
    ap.add_argument("--out", default="", help="write the verdict JSON here")
    ap.add_argument("--logdir", default="", help="task log directory (default: tmp)")
    ap.add_argument("--example", default=EXAMPLE, help="the CLI module each task runs")
    ap.add_argument("--device", default=None,
                    help="the tasks' torch device; default cuda (no silent CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.scenario not in PORTED:
        print(f"loadsim: --scenario={args.scenario} is not ported to "
              f"distributed_tensorflow_examples_tpu_torch (ported: {', '.join(PORTED)})",
              file=sys.stderr)
        return 2
    return run_canary(args)


if __name__ == "__main__":
    sys.exit(main())
