"""The port's ``tools/loadsim.py`` (the root tool's canary scenario): its
surface and timeline, its verdict on synthetic scrape records, and its
generator and scrape against in-process replicas.  No test spawns a
cluster: the canary's end-to-end run is ``chip_smoke.py``'s phase 17, on
the card (the root's chaos end-to-end is a ``slow`` test for the same
reason)."""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu_torch.parallel import ps_service
from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry, ModelReplicaServer
from distributed_tensorflow_examples_tpu_torch.tools import loadsim

torch.set_num_threads(1)


def test_canary_scenario_surface_and_phases():
    """The weight deliberately differs from the plain round-robin share
    (3 stable + 1 canary: 0.25), so an ignored weight fails the honoured
    gate instead of passing by coincidence; the phases run publish ->
    canary -> kill -> promote -> retire."""
    ns = loadsim.parse_args(["--scenario=canary"])
    assert ns.canary_weight == 0.4 and ns.canary_tol == 0.12 and ns.duration_s == 30.0
    assert ns.example == "distributed_tensorflow_examples_tpu_torch.examples.mnist_mlp"
    rr_share = 1.0 / (max(3, ns.serve_replicas) + 1)
    assert abs(rr_share - ns.canary_weight) > ns.canary_tol
    p = loadsim.CANARY_PHASES
    assert (p["publish_v2"] < p["canary_up"] < p["kill_serve"] < p["promote_start"]
            < p["retire_old"] < 1.0)


@pytest.mark.parametrize("scenario", ["chaos", "reshard", "overload", "multitenant"])
def test_unported_scenarios_exit_nonzero(scenario, capsys):
    assert loadsim.main([f"--scenario={scenario}"]) != 0
    assert "not ported" in capsys.readouterr().err


def _records(versions_by_scrape, steps=None, both_at=(2,)):
    out = []
    for i, vs in enumerate(versions_by_scrape):
        out.append({"t": float(i), "model_versions": list(vs),
                    "model_steps": [steps[i] if steps else 10 * (i + 1)] * len(vs),
                    "by_version": [1, 2] if i in both_at else [max(vs)]})
    return out


FLIP = [[1, 1, 1], [1, 1, 1, 2], [1, 1, 1, 2], [1, 1, 1, 2, 2, 2, 2], [2, 2, 2]]
LOAD = {"predict_ok": 2400, "predict_failed": 0, "p99_ms": 40.0}


def _verdict(records=None, load=LOAD, frac=0.41, kill=True, **args):
    ns = loadsim.parse_args(["--scenario=canary", *[f"--{k}={v}" for k, v in args.items()]])
    return loadsim.canary_verdict(records or _records(FLIP), load, canary_frac=frac,
                                  kill_fired=kill, window_s=30.0, args=ns)


def test_canary_verdict_passes_a_clean_flip():
    v = _verdict()
    assert v["slo_pass"] and all(v["gates"].values()), v["gates"]
    assert v["version_first"] == 1 and v["version_last"] == 2 and v["final_versions"] == [2, 2, 2]
    assert v["qps_achieved"] == 80.0 and v["step_first"] == 10 and v["step_last"] == 50


@pytest.mark.parametrize("broken,gate", [
    (dict(load=dict(LOAD, predict_failed=1)), "zero_failed_predicts"),
    (dict(load=dict(LOAD, p99_ms=400.0)), "p99_under_bound"),
    (dict(load=dict(LOAD, predict_ok=1000)), "qps_at_target"),
    (dict(frac=0.25), "canary_weight_honored"),  # round-robin: the weight ignored
    (dict(frac=-1.0), "canary_weight_honored"),  # never routed
    (dict(records=_records(FLIP[:-1] + [[2, 2, 1]])), "flip_completed"),
    (dict(records=_records(FLIP[:3] + [[1, 1, 1]] + FLIP[4:])), "version_monotone"),
    (dict(records=_records(FLIP, both_at=())), "both_versions_observed"),
    (dict(records=_records(FLIP, steps=[10, 20, 15, 30, 40])), "step_monotone"),
    (dict(records=_records(FLIP, steps=[10] * 5)), "step_advanced"),
    (dict(kill=False), "kill_fired"),
])
def test_canary_verdict_fails_a_broken_flip(broken, gate):
    v = _verdict(**broken)
    assert not v["slo_pass"] and not v["gates"][gate]
    assert [g for g, ok in v["gates"].items() if not ok] == [gate]


def test_canary_verdict_without_chaos_has_no_kill_gate():
    ns = loadsim.parse_args(["--scenario=canary", "--no_chaos"])
    v = loadsim.canary_verdict(_records(FLIP), LOAD, canary_frac=0.4, kill_fired=False,
                               window_s=30.0, args=ns)
    assert "kill_fired" not in v["gates"] and v["slo_pass"]


def test_versions_answering_counts_new_ok_predicts():
    before = {1: {"ok": 5}, 2: {"ok": 0}}
    assert loadsim.versions_answering({1: {"ok": 9}, 2: {"ok": 3}, -1: {"ok": 1}}, before) == [1, 2]
    assert loadsim.versions_answering({1: {"ok": 5}, 2: {"ok": 3}}, before) == [2]


def _apply(params, batch):
    return batch["image"] @ params["w"]


def test_generator_and_scrape_follow_pinned_replicas(tmp_path):
    """Two registry-pinned replicas (v1, v2) leased on an in-process PS:
    the scrape finds both through the lease registry with their versions
    and steps, and the generator, discovering them there, drives a
    weighted canary with no failed predict."""
    reg = ModelRegistry(str(tmp_path))
    shapes = {"w": (784, 3)}
    for version, step in ((1, 7), (2, 9)):
        reg.publish("default", np.full(784 * 3, float(version), np.float32), step=step,
                    version=version)
    port = ps_service.start_server(0)
    ps_addrs = [("127.0.0.1", port)]
    servers, gen, coord = [], None, None
    try:
        servers = [ModelReplicaServer(shapes, _apply, ps_addrs, device="cpu",
                                      registry_dir=str(tmp_path), model_version=v,
                                      role=f"serve{v}", lease_ttl_s=3.0, max_wait_ms=1.0)
                   for v in (1, 2)]
        coord = ps_service.PSClient("127.0.0.1", port, timeout_s=3.0)
        rec = loadsim.scrape(coord)
        assert sorted(rec["model_versions"]) == [1, 2] and sorted(rec["model_steps"]) == [7, 9]
        assert rec["members"]["serve"] == ["serve1", "serve2"]
        gen = loadsim.LoadGenerator(ps_addrs, [("127.0.0.1", servers[0].port)], qps=200.0,
                                    threads=4, deadline_s=10.0, rows=2)
        t_end = time.monotonic() + 10.0
        while len(gen.pool.addrs) < 2 and time.monotonic() < t_end:
            time.sleep(0.05)  # lease discovery adds the v2 replica
        assert len(gen.pool.addrs) == 2
        gen.pool.set_canary(2, 0.5)
        gen.start()
        t_end = time.monotonic() + 10.0
        while gen.ok < 60 and time.monotonic() < t_end:
            time.sleep(0.05)
        vs = gen.pool.version_stats()
        load = gen.stop()
        gen = None
        assert load["predict_failed"] == 0 and load["predict_ok"] >= 60, load["errors"]
        assert loadsim.versions_answering(vs, {}) == [1, 2]
        assert 0.0 < load["p50_ms"] <= load["p99_ms"]
    finally:
        if gen is not None:
            gen.stop()
        if coord is not None:
            coord.close()
        for s in servers:
            s.stop()
        ps_service.stop_server(port)
    assert not [t for t in threading.enumerate() if t.name.startswith("loadsim-gen")]


def test_replica_answers_stats_as_soon_as_its_core_listens(tmp_path, monkeypatch):
    """A STATS that reaches a replica the moment its server core starts
    listening, before the constructor has finished (the scrape and
    ``wait_serve_ready`` dial replicas as they boot), is answered, not
    failed: the core's start here dials the replica's own STATS at once."""
    from distributed_tensorflow_examples_tpu_torch.parallel import server_core
    from distributed_tensorflow_examples_tpu_torch.serve import ServeClient

    seen = []
    start = server_core.ServerCore.start

    def start_then_stats(core):
        out = start(core)
        if core.name == "msrv":
            c = ServeClient("127.0.0.1", core.port, op_timeout_s=5.0, reconnect_deadline_s=0.0)
            try:
                seen.append(c.stats())
            finally:
                c.close()
        return out

    monkeypatch.setattr(server_core.ServerCore, "start", start_then_stats)
    ModelRegistry(str(tmp_path)).publish("default", np.zeros(784 * 3, np.float32), step=1,
                                         version=1)
    server = ModelReplicaServer({"w": (784, 3)}, _apply, device="cpu",
                                registry_dir=str(tmp_path), model_version=1, role="serve0")
    server.stop()
    assert len(seen) == 1 and seen[0]["model_version"] == 1 and seen[0]["leased"] is False

