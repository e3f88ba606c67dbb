"""The port's deploy and autoscale layers (``serve/deploy.py``,
``serve/autoscale.py``) over port replicas on the CPU, in the scenarios
of the JAX package's ``tests/test_registry.py`` and
``tests/test_membership.py``.

- ``canary_verdict`` gives JAX's verdict on the same ``version_stats``
  rows.
- ``RollingDeploy`` flips a 3-replica pinned pool v1 -> canary v2 ->
  promoted v2 under closed-loop load, then canaries v3 and rolls it back,
  with zero failed predicts; every answer carries version 1, 2 or 3 and
  equals that version's apply; the flip is monotone through the promote;
  a rollback never empties the pool; every pin is released at the end.
- ``ServeAutoscaler`` grows on queue depth and drains back to its floor,
  the replicas' membership leases on a port PS following; and
  ``LeaseServeDiscovery`` reconciles a ``ServePool`` onto the live set.

Every gate waits for a state (answers counted, per-version counters,
batcher depth, leases, poll decisions), never for a wall-clock margin:
the JAX twin of the flip, which sleeps for its canary evidence, fails
about one run in eight.  Deadlines appear only as hang guards.  The
canary verdict that gates the promote leaves out the latency factor
(``p99_factor=inf``), a wall-clock comparison; the default policy is
compared with JAX's on the same rows instead.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu import serve as jax_serve
from distributed_tensorflow_examples_tpu_torch import serve
from distributed_tensorflow_examples_tpu_torch.parallel import membership, ps_service, ps_shard
from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry

torch.set_num_threads(1)

D = 8
HANG_S = 60.0


def _predict(params, batch):
    return batch["x"] * params["w"][None, :]


def _publish(reg, value, step):
    return reg.publish("default", np.full(D, value, np.float32), step=step)


def _wait(pred, what: str, timeout_s: float = HANG_S) -> None:
    end = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < end, f"hung waiting for {what}"
        time.sleep(0.01)


# ----------------------------------------------------------------------------
# canary_verdict
# ----------------------------------------------------------------------------

STABLE = {"ok": 100, "err": 0, "latency_p99_ms": 10.0}
VERDICT_CASES = {
    "no-canary": (STABLE, None, "hold"),
    "too-little-evidence": (STABLE, {"ok": 3, "err": 0}, "hold"),
    "healthy": (STABLE, {"ok": 100, "err": 0, "latency_p99_ms": 12.0}, "promote"),
    "errors": (STABLE, {"ok": 90, "err": 10, "latency_p99_ms": 12.0}, "rollback"),
    "slow": (STABLE, {"ok": 100, "err": 0, "latency_p99_ms": 100.0}, "rollback"),
    "no-stable-evidence": (None, {"ok": 100, "err": 0, "latency_p99_ms": 100.0}, "promote"),
    "at-the-error-ratio": (STABLE, {"ok": 98, "err": 2, "latency_p99_ms": 10.0}, "promote"),
    "at-the-floor": (STABLE, {"ok": 19, "err": 1}, "rollback"),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_canary_verdict_is_the_jax_policy(case):
    stable, canary, want = VERDICT_CASES[case]
    assert serve.canary_verdict(stable, canary) == want
    assert jax_serve.canary_verdict(stable, canary) == want
    for kw in ({"min_requests": 5}, {"max_err_ratio": 0.2}, {"p99_factor": 20.0}):
        assert serve.canary_verdict(stable, canary, **kw) == \
            jax_serve.canary_verdict(stable, canary, **kw)


# ----------------------------------------------------------------------------
# RollingDeploy
# ----------------------------------------------------------------------------


def _factory(tmp_path, **kw):
    return serve.make_pinned_factory(
        {"w": np.zeros(D, np.float32)}, _predict, [], registry_dir=str(tmp_path),
        device="cpu", membership=False, max_wait_ms=1.0, **kw)


class _Load:
    """One client thread predicting through ``pool`` until stopped: every
    answer's (version, step, output) is kept, every failure counted."""

    def __init__(self, pool, x):
        self.pool, self.x = pool, x
        self.answers: list[tuple[int, int, np.ndarray]] = []
        self.failures: list[str] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                step, out = self.pool.predict({"x": self.x})
            except Exception as e:  # noqa: BLE001 — every failure counted
                self.failures.append(repr(e))
                return
            self.answers.append((self.pool.last_version, step, next(iter(out.values()))))

    def more(self, n: int) -> None:
        """Wait until ``n`` more answers arrived (or the load failed)."""
        target = len(self.answers) + n
        _wait(lambda: len(self.answers) >= target or self.failures, f"{n} more answers")

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=HANG_S)
        assert not self._thread.is_alive()


def test_rolling_deploy_flip_zero_failures_and_rollback(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    value = {_publish(reg, 1.0, step=10): 1.0, _publish(reg, 2.0, step=20): 2.0}
    v1, v2 = sorted(value)
    step_of = {v1: 10, v2: 20}
    pool = serve.ServePool([("127.0.0.1", 1)], role="rd_sv", op_timeout_s=5.0, deadline_s=30.0)
    dep = serve.RollingDeploy(_factory(tmp_path), replicas=3, version=v1,
                              on_change=pool.set_addrs)
    x = np.arange(1, D + 1, dtype=np.float32)[None, :]
    load = _Load(pool, x)
    try:
        load.more(20)
        # Canary: one v2 replica with a quarter of the traffic, until the
        # pool's own per-version accounting holds the verdict's evidence.
        dep.canary(v2)
        assert sorted(dep.versions().values()) == [v1, v1, v1, v2]
        pool.set_canary(v2, 0.25)
        _wait(lambda: pool.version_stats().get(v2, {}).get("ok", 0) >= 20 or load.failures,
              "canary evidence")
        vs = pool.version_stats()
        assert vs[v1]["err"] == vs[v2]["err"] == 0, vs
        assert serve.canary_verdict(vs[v1], vs[v2], p99_factor=float("inf")) == "promote"
        assert serve.canary_verdict(vs[v1], vs[v2]) == jax_serve.canary_verdict(vs[v1], vs[v2])
        pool.clear_canary()
        assert dep.promote(v2) == 3
        # The three v1 replicas replaced; the canary stays, at v2 already.
        assert sorted(dep.versions().values()) == [v2] * 4 and dep.flips == 1
        promoted_at = len(load.answers)
        load.more(20)
        # Rollback leg: canary v3 at half the traffic, then roll it back.
        v3 = _publish(reg, 3.0, step=30)
        value[v3], step_of[v3] = 3.0, 30
        dep.canary(v3)
        pool.set_canary(v3, 0.5)
        _wait(lambda: pool.version_stats().get(v3, {}).get("ok", 0) >= 5 or load.failures,
              "v3 answers")
        pool.clear_canary()
        assert dep.rollback(v3) == 1 and dep.rollbacks == 1
        load.more(20)
    finally:
        load.stop()
    assert not load.failures, load.failures
    assert sorted(dep.versions().values()) == [v2] * 4 and len(dep.addrs()) == 4
    versions = [v for v, _s, _o in load.answers]
    # Every answer carries a published version and is that version's apply.
    for v, step, out in load.answers:
        assert v in value and step == step_of[v]
        np.testing.assert_array_equal(out, value[v] * x)
    # Monotone through the promote: after it returned, no v1 answer.
    assert v1 in versions[:promoted_at] and v2 in versions[:promoted_at]
    assert v1 not in versions[promoted_at:] and versions[-1] == v2
    assert v3 in versions
    dep.close()
    pool.close()
    # Every pin released: retention reclaims everything but the latest.
    assert reg.gc("default", keep_last_n=1) == [v1, v2]


def test_rolling_deploy_rollback_never_empties_pool(tmp_path):
    reg = ModelRegistry(str(tmp_path))
    v1 = _publish(reg, 1.0, step=1)
    dep = serve.RollingDeploy(_factory(tmp_path), replicas=1, version=v1)
    try:
        assert dep.rollback(v1) == 0
        assert len(dep.addrs()) == 1 and dep.rollbacks == 0
    finally:
        dep.close()
    with pytest.raises(ValueError, match="need >= 1 replica"):
        serve.RollingDeploy(_factory(tmp_path), replicas=0, version=v1)


# ----------------------------------------------------------------------------
# ServeAutoscaler and LeaseServeDiscovery against a port PS
# ----------------------------------------------------------------------------


@pytest.fixture
def ps_port():
    port = ps_service.start_server(0)
    yield port
    ps_service.stop_server()


def _publish_params(addrs, step=1):
    group = ps_shard.ShardedPSClients(addrs, role="pub", op_timeout_s=10.0)
    store = ps_shard.ShardedParamStore(group, "params", group.layout_for(D))
    store.set(step, np.arange(D, dtype=np.float32))
    return group


def _client(port):
    return ps_service.PSClient("127.0.0.1", port, timeout_s=10.0)


class _Gate:
    """A predict that holds in the apply while ``closed``: requests stay in
    the batcher, so its depth is a state the test sets, not a race."""

    def __init__(self):
        self.open = threading.Event()
        self.open.set()

    def __call__(self, params, batch):
        assert self.open.wait(HANG_S)
        return _predict(params, batch)


def test_autoscaler_scales_on_load_signals_and_drains(ps_port):
    addrs = [("127.0.0.1", ps_port)]
    group = _publish_params(addrs)
    gate = _Gate()
    make = serve.make_replica_factory({"w": np.zeros(D, np.float32)}, gate, addrs,
                                      device="cpu", refresh_ms=20.0, lease_ttl_s=1.0)
    asc = serve.ServeAutoscaler(make, min_replicas=1, max_replicas=2, queue_high=0.5,
                                queue_low=0.25, settle_polls=2)
    c = _client(ps_port)
    threads, pools = [], []
    try:
        assert asc.num_replicas == 1
        assert len(membership.live_members(c, "serve")) == 1  # leased at boot
        srv = asc._servers[0]
        assert srv.wait_for_model(30)
        assert asc.poll_once() == "hold"
        gate.open.clear()
        for _ in range(4):
            pool = serve.ServePool([("127.0.0.1", srv.port)], deadline_s=HANG_S)
            pools.append(pool)
            threads.append(threading.Thread(
                target=pool.predict, args=({"x": np.ones((4, D), np.float32)},), daemon=True))
            threads[-1].start()
        _wait(lambda: srv._batcher.stats()["inflight"] == 4, "4 held requests")
        assert [asc.poll_once() for _ in range(2)] == ["hold", "up"]  # damped, then up
        assert asc.num_replicas == 2 and asc.scale_ups == 1
        _wait(lambda: len(membership.live_members(c, "serve")) == 2, "the new lease")
        assert asc.poll_once() == "hold"  # at max_replicas
        gate.open.set()
        for t in threads:
            t.join(timeout=HANG_S)
        assert not any(t.is_alive() for t in threads)
        # Idle now: the pool drains back to min, releasing the lease first.
        assert [asc.poll_once() for _ in range(2)] == ["hold", "down"]
        assert asc.num_replicas == 1 and asc.scale_downs == 1
        assert len(membership.live_members(c, "serve")) == 1
        assert [asc.poll_once() for _ in range(3)] == ["hold"] * 3  # at min_replicas
    finally:
        gate.open.set()
        for pool in pools:
            pool.close()
        asc.close()
        c.close()
        group.close()


def test_lease_discovery_follows_elastic_replica_set(ps_port):
    addrs = [("127.0.0.1", ps_port)]
    group = _publish_params(addrs)
    make = serve.make_replica_factory({"w": np.zeros(D, np.float32)}, _predict, addrs,
                                      device="cpu", refresh_ms=20.0, lease_ttl_s=5.0)
    asc = serve.ServeAutoscaler(make, min_replicas=1, max_replicas=3)
    pool = serve.ServePool(asc.addrs(), deadline_s=20.0)
    disc = serve.LeaseServeDiscovery(addrs, pool, poll_s=30.0)
    try:
        disc.poll_once()
        assert len(pool.addrs) == 1
        new_addr = asc.scale_up(depth=9.0)
        disc.poll_once()
        assert set(pool.addrs) == set(asc.addrs()) and new_addr in pool.addrs
        asc.scale_down(depth=0.0)
        disc.poll_once()
        assert pool.addrs == asc.addrs()
        assert disc.updates >= 2
        x = np.ones((2, D), np.float32)
        step, out = pool.predict({"x": x})
        assert step == 1
        np.testing.assert_array_equal(next(iter(out.values())),
                                      x * np.arange(D, dtype=np.float32)[None, :])
    finally:
        disc.close()
        pool.close()
        asc.close()
        group.close()
