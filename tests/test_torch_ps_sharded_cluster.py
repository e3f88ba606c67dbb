"""The port's sharded, replicated PS across real processes on the CPU: W2
(async SGD, ``cifar10_cnn.py --sync_replicas=false``) through the port's
CLI at 2 shards x 2 replicas, the twin of the JAX package's
``tests/test_faults.py::test_replicated_ps_kill_heals_via_backup_with_zero_reseeds``.

The cluster, started together: 4 supervised PS tasks (``--ps_restarts`` at
its default; task i serves shard i % 2, replica i // 2, so ps0 and ps2 are
shard 0's primary and backup), the chief and 2 port workers.
``DTX_FAULT_PLAN`` kills ps0 once it has served a number of requests; its
supervisor restarts it, and the new incarnation catches up from ps2
(REPL_SYNC) before it serves.  Meanwhile the clients fail over to ps2 with
the same state token, so the chief reseeds nothing.

Gates, on states and counters only (no sleep decides anything): every
process exits 0; the chief's ``PS_CHIEF_STATS`` says ``reseeds`` 0 at 2
shards x 2 replicas; FINAL ``mode=async_cluster workers=2`` at the full
step count; both workers contributed; ps0 ran a second incarnation, whose
state token is its peer's, and ps2 counts the catch-up it served
(``repl_syncs_served``, read over STATS).

The stall case (fault C9) runs the same cluster and the same kill, then
starves the survivor: it stops ps2's server process (SIGSTOP) for
``STALL_S`` while ps0's new incarnation starts, as a host too busy to
schedule ps2 would.  The restarted replica must catch up from its peer
once the peer runs again, rather than serve an empty shard beside the
peer's state, and ps2's shutdown watch must outlive the stall rather
than restart ps2 too: the same gates hold.
"""

from __future__ import annotations

import json
import os
import re
import signal
import sys
import threading
import time

import pytest

from distributed_tensorflow_examples_tpu_torch.parallel import ps_service
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import (
    ProcessCluster,
    free_ports,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn"
LIMIT_S = 240
STEPS = 1200
#: ps0 dies once its server has answered this many requests (about a
#: sixth of the run's traffic to it, ~6.6 requests an applied step), so its
#: restarted incarnation (a few seconds: a new process importing torch)
#: rejoins while the run still trains.
KILL_AFTER_REQS = 1200
#: The survivor's stall: longer than the shutdown watch's 10 s socket
#: timeout on its own server and than the 2 s sync budget a cold primary
#: takes, so that both give out while ps2 is stopped.
STALL_S = 20.0


def _stats(port: int) -> dict | None:
    try:
        c = ps_service.PSClient("127.0.0.1", port, timeout_s=1.0, op_timeout_s=1.0)
    except (OSError, ps_service.PSError):
        return None
    try:
        return c.stats()
    except (OSError, ps_service.PSError):
        return None
    finally:
        c.close()


def _watch(ports: list[int], seen: dict, stop: threading.Event) -> None:
    """Record ps0's incarnations and state tokens, and the most catch-ups
    ps2 reports having served, for as long as the run lasts."""
    while not stop.is_set():
        s0, s2 = _stats(ports[0]), _stats(ports[2])

        if s0 is not None:
            seen.setdefault("ps0_incarnations", []).append(s0["incarnation"])
            if s2 is not None:
                seen.setdefault("tokens", []).append((s0["incarnation"], s0["state_token"],
                                                      s2["state_token"]))
        if s2 is not None:
            seen["ps2_repl_syncs_served"] = max(seen.get("ps2_repl_syncs_served", 0),
                                                s2["repl_syncs_served"])
        stop.wait(0.1)


def _children(pid: int) -> list[int]:
    """The pids whose parent is ``pid`` (read from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:  # the process ended meanwhile
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def _stall_ps2(cluster: ProcessCluster) -> None:
    """Once ps0 died, stop ps2's server process (the supervisor's child)
    for ``STALL_S``, or until ps0's new incarnation serves."""
    cluster.wait_until(lambda: "child exited 43" in cluster.output("ps0"))
    server = _children(cluster.procs["ps2"].pid)
    assert server, "ps2's supervisor has no server process"
    for pid in server:
        os.kill(pid, signal.SIGSTOP)
    end = time.monotonic() + STALL_S
    try:
        cluster.wait_until(lambda: time.monotonic() >= end
                           or cluster.output("ps0").count("serving on port") >= 2)
    finally:
        for pid in server:
            os.kill(pid, signal.SIGCONT)


def _run_cluster(during=None) -> tuple[dict, dict]:
    """Run the cluster to its end (``during(cluster)`` once every process
    is up); the processes' outputs and what the watcher saw."""
    ports = free_ports(4)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               DTX_FAULT_PLAN=f"die:role=ps0,after_reqs={KILL_AFTER_REQS}")
    common = [sys.executable, "-m", CLI, "--device=cpu", "--sync_replicas=false",
              "--max_staleness=4", "--batch_size=16", f"--train_steps={STEPS}",
              "--ps_shards=2", "--ps_replicas=2", "--worker_hosts=a:1,b:1",
              "--ps_hosts=" + ",".join(f"127.0.0.1:{p}" for p in ports)]
    seen: dict = {}
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(ports, seen, stop), daemon=True)
    watcher.start()
    try:
        with ProcessCluster(LIMIT_S) as cluster:
            for i in range(4):
                cluster.spawn(f"ps{i}", [*common, "--job_name=ps", f"--task_index={i}"],
                              env=env, cwd=ROOT)
            cluster.spawn("chief", [*common, "--job_name=chief"], env=env, cwd=ROOT)
            for w in range(2):
                cluster.spawn(f"worker{w}", [*common, "--job_name=worker",
                                             f"--task_index={w}"], env=env, cwd=ROOT)
            if during is not None:
                during(cluster)
            outs = cluster.finish()
    finally:
        stop.set()
        watcher.join(10)
    return outs, seen


def test_replicated_ps_kill_heals_via_backup_with_zero_reseeds():
    _check_healed(*_run_cluster())


def test_replicated_ps_kill_heals_while_the_survivor_stalls():
    """Fault C9: the kill, and the survivor stopped while the killed
    replica restarts; the same gates."""
    _check_healed(*_run_cluster(_stall_ps2))


def _check_healed(outs: dict, seen: dict) -> None:
    finals = [l for l in outs["chief"].splitlines() if l.startswith("FINAL ")]
    assert len(finals) == 1, outs["chief"][-3000:]
    assert re.match(rf"^FINAL step={STEPS} .* mode=async_cluster workers=2 ", finals[0]), finals
    (line,) = [l for l in outs["chief"].splitlines() if "PS_CHIEF_STATS " in l]
    stats = json.loads(line.split("PS_CHIEF_STATS ", 1)[1])
    assert stats["reseeds"] == 0, stats
    assert (stats["shards"], stats["replicas"], stats["applied"]) == (2, 2, STEPS), stats
    for w in range(2):
        m = re.search(r"^WORKER_DONE task=\d+ contributed=(\d+)$", outs[f"worker{w}"], re.M)
        assert m and int(m.group(1)) > 0, outs[f"worker{w}"][-2000:]
    for i in range(4):
        assert "PS_DONE port=" in outs[f"ps{i}"], outs[f"ps{i}"][-2000:]
    assert "supervisor_healed_plan" in outs["ps0"], outs["ps0"][-3000:]
    # ps0's second incarnation: seen over STATS, holding its peer's state token.
    incarnations = list(dict.fromkeys(seen.get("ps0_incarnations", [])))
    assert len(incarnations) >= 2, seen
    assert any(inc == incarnations[-1] and t0 == t2 for inc, t0, t2 in seen["tokens"]), seen
    assert seen.get("ps2_repl_syncs_served", 0) >= 1, seen


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
