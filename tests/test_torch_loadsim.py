"""The port's ``tools/loadsim.py`` against the root ``tools/loadsim.py``:
the scenarios' timelines, the chaos plan, the flags and their defaults
(the root's, and the root's acceptance baselines'); each scenario's
verdict on synthetic records, passing and failing on each gate; the
generator (paced and unpaced, tenant-tagged, windowed), the burst-client
processes and the canary's scrape against in-process replicas; and the
client path importing no torch.  No test spawns a cluster: the scenarios
run whole on the CPU by hand and ``chip_smoke.py`` runs the canary and
the overload on the card (the root's chaos end-to-end is a ``slow`` test
for the same reason)."""

import json
import os
import subprocess
import sys
import threading
import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu_torch.parallel import ps_service
from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry, ModelReplicaServer
from distributed_tensorflow_examples_tpu_torch.tools import loadsim
from tools import loadsim as root_loadsim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _root_args(argv: list) -> dict:
    """The root tool's parsed flags, caught at its overload dispatch."""
    caught = {}

    def grab(args):
        caught.update(vars(args))
        return 0

    with mock.patch.object(root_loadsim, "run_overload", side_effect=grab):
        root_loadsim.main([*argv, "--scenario=overload"])
    return caught


#: The root's overload and multitenant acceptance runs ran at the
#: defaults: the twin's defaults are those runs' settings.
BASELINE_FLAGS = {
    "loadsim_overload_baseline.json": {
        "qps_target": "qps", "gen_threads": "gen_threads", "burst_threads": "burst_threads",
        "burst_procs": "burst_procs", "duration_s": "duration_s",
        "goodput_floor_frac": "goodput_floor_frac", "recovery_bound_s": "recovery_bound_s",
        "recovery_factor": "recovery_factor"},
    "loadsim_multitenant_baseline.json": {
        "qps_target": "qps", "gen_threads": "gen_threads", "duration_s": "duration_s",
        "tenant_quotas": "mt_quotas", "noise_threads": "mt_noise_threads",
        "noise_procs": "mt_noise_procs", "mt_p99_factor": "mt_p99_factor"},
}


def test_timelines_plan_flags_and_defaults_equal_the_roots():
    """Every scenario's timeline and the chaos plan string are the root's;
    so are every flag and its default (and ``--device``), the default
    scenario (chaos) and reshard's least 2 shards; and the defaults are
    the settings of the root's overload and multitenant acceptance runs."""
    for name in ("PHASES", "RESHARD_PHASES", "OVERLOAD_PHASES", "MULTITENANT_PHASES",
                 "CANARY_PHASES", "VERDICT_SCHEMA_VERSION"):
        assert getattr(loadsim, name) == getattr(root_loadsim, name), name
    for args in ((15.0, 30.0, 2), (10.0, 40.0, 3), (0.0, 7.5, 1)):
        assert loadsim.build_plan(*args) == root_loadsim.build_plan(*args)
    twin = vars(loadsim.parse_args(["--scenario=overload"]))
    root = _root_args([])
    assert set(twin) == set(root) | {"device"}
    assert {k: v for k, v in twin.items() if k not in ("example", "device")} == {
        k: v for k, v in root.items() if k != "example"}
    assert loadsim.parse_args([]).scenario == "chaos" and twin["device"] is None
    with mock.patch.dict(loadsim.RUNS, reshard=lambda a: a.ps_shards):
        assert loadsim.main(["--scenario=reshard"]) == 2
        assert loadsim.main(["--scenario=reshard", "--ps_shards=3"]) == 3
    ns = vars(loadsim.parse_args([]))
    for baseline, flags in BASELINE_FLAGS.items():
        with open(os.path.join(ROOT, "tools", baseline)) as f:
            base = json.load(f)
        assert {k: base[k] for k in flags} == {k: ns[v] for k, v in flags.items()}, baseline


def _gates_of(baseline: str) -> list:
    with open(os.path.join(ROOT, "tools", baseline)) as f:
        return list(json.load(f)["gates"])


def _ns(*argv):
    return loadsim.parse_args(list(argv))


def _false(v: dict) -> set:
    return {g for g, ok in v["gates"].items() if not ok}


def _series(steps, t0=0.0):
    return [(t0 + i, s) for i, s in enumerate(steps)]


ADVANCING = [100 * (i + 1) for i in range(10)]
NOT_MONOTONE = [100, 300, 200, 400, 500, 600, 700, 800, 900, 1000]
FLAT = [500] * 10
FLAT_AT_END = [100, 200, 300, 400, 500, 600, 700, 800, 800, 800]

CHAOS = {"step_series": _series(ADVANCING), "markers": {"kill_ps": 2.0, "leave_worker": 7.0},
         "window_s": 30.0, "dtxtop_exit": 0, "join_lease_seen": True,
         "kills_fired": {"ps0": True, "serve0": True, "worker1": True}, "leave_fired": True}
CHAOS_LOAD = {"predict_ok": 3000, "predict_failed": 0, "p99_ms": 20.0}


#: (records, load totals, the gates that must fail) a case.
CHAOS_BROKEN = [
    ({}, {"predict_failed": 1}, {"zero_failed_predicts"}),
    ({}, {"p99_ms": 300.0}, {"p99_under_bound"}),
    ({}, {"p99_ms": 0.0}, {"p99_under_bound"}),  # no predict answered
    ({}, {"predict_ok": 1000}, {"qps_at_target"}),
    ({"step_series": _series(NOT_MONOTONE)}, {}, {"step_monotone"}),
    # A flat series cannot advance past the last marker either.
    ({"step_series": _series(FLAT)}, {}, {"step_advanced", "step_advanced_post_chaos"}),
    ({"step_series": _series(FLAT_AT_END)}, {}, {"step_advanced_post_chaos"}),
    ({"dtxtop_exit": 1}, {}, {"dtxtop_midrun_exit0"}),
    ({"dtxtop_exit": None}, {}, {"dtxtop_midrun_exit0"}),  # the probe never ran
    ({"join_lease_seen": False}, {}, {"join_lease_seen"}),
    ({"kills_fired": {"ps0": True, "serve0": False, "worker1": True}}, {}, {"kills_fired"}),
    ({"leave_fired": False}, {}, {"leave_fired"}),
]


def test_chaos_verdict():
    """The chaos verdict passes on a clean run with the root's gate names,
    and on each broken record fails with exactly the gates named false."""
    v = loadsim.chaos_verdict(CHAOS, CHAOS_LOAD, _ns())
    assert v["slo_pass"] and list(v["gates"]) == _gates_of("loadsim_baseline.json")
    assert v["qps_achieved"] == 100.0 and v["kills_fired"] == CHAOS["kills_fired"]
    quiet = loadsim.chaos_verdict(dict(CHAOS, kills_fired={}, leave_fired=False), CHAOS_LOAD,
                                  _ns("--no_chaos"))
    assert quiet["slo_pass"] and list(quiet["gates"]) == [
        "zero_failed_predicts", "p99_under_bound", "qps_at_target", "step_monotone",
        "step_advanced"]
    for rec, load, want in CHAOS_BROKEN:
        v = loadsim.chaos_verdict(dict(CHAOS, **rec), dict(CHAOS_LOAD, **load), _ns())
        assert not v["slo_pass"] and _false(v) == want, (rec, load)


RESHARD = {"step_series": _series(ADVANCING), "spawned_at": {2: 1.0, 3: 5.0},
           "committed_at": {2: 3.0, 3: 7.0}, "epochs_seen": {1, 2, 3},
           "dtxtop_probe": {"exit": 0, "committed": 3, "epochs": [3]},
           "old_ps_exit": {"ps_v1_0": 0, "ps_v1_1": 0, "ps_v2_0": 0, "ps_v2_1": 0,
                           "ps_v2_2": 0},
           "chief_reseeds_seen": False, "reshard_commits_seen": True, "kill_fired": True,
           "window_s": 40.0}
RESHARD_LOAD = {"predict_ok": 600, "predict_failed": 0, "p99_ms": 20.0}
RESHARD_ARGS = ("--scenario=reshard", "--qps=15", "--p99_bound_ms=400")


#: (records, load totals, the gates that must fail) a case.
RESHARD_BROKEN = [
    ({}, {"predict_failed": 1}, {"zero_failed_predicts"}),
    ({}, {"p99_ms": 500.0}, {"p99_under_bound"}),
    ({}, {"predict_ok": 100}, {"qps_at_target"}),
    ({"step_series": _series(NOT_MONOTONE)}, {}, {"step_monotone"}),
    ({"step_series": _series(FLAT)}, {}, {"step_advanced", "step_advanced_post_chaos"}),
    ({"step_series": _series(FLAT_AT_END)}, {}, {"step_advanced_post_chaos"}),
    ({"chief_reseeds_seen": True}, {}, {"zero_reseeds"}),
    ({"committed_at": {2: 3.0}}, {}, {"both_transitions_committed"}),
    ({"spawned_at": {2: -28.5, 3: 5.0}}, {}, {"transitions_bounded"}),
    ({"epochs_seen": {1, 3}}, {}, {"epochs_all_seen"}),
    ({"dtxtop_probe": {"exit": 1, "committed": 3}}, {}, {"dtxtop_probe_exit0"}),
    ({"dtxtop_probe": {"exit": 0, "committed": 2}}, {}, {"dtxtop_probe_final_epoch"}),
    ({"old_ps_exit": {"ps_v1_0": 0, "ps_v2_0": None}}, {}, {"old_ps_drained_exit0"}),
    ({"old_ps_exit": {}}, {}, {"old_ps_drained_exit0"}),
    ({"kill_fired": False}, {}, {"kill_fired"}),
]


def test_reshard_verdict():
    """The reshard verdict passes on a clean run with the root's gate names,
    and on each broken record fails with exactly the gates named false."""
    v = loadsim.reshard_verdict(RESHARD, RESHARD_LOAD, _ns(*RESHARD_ARGS))
    assert v["slo_pass"] and list(v["gates"]) == _gates_of("loadsim_reshard_baseline.json")
    assert v["transition_s"] == {"2": 2.0, "3": 2.0} and v["epochs_seen"] == [1, 2, 3]
    assert v["qps_achieved"] == 15.0
    for rec, load, want in RESHARD_BROKEN:
        v = loadsim.reshard_verdict(dict(RESHARD, **rec), dict(RESHARD_LOAD, **load),
                                    _ns(*RESHARD_ARGS))
        assert not v["slo_pass"] and _false(v) == want, (rec, load)


MEMBERS = {"serve0", "serve1", "worker0", "worker1"}
OVERLOAD = {"baseline": {"ok": 1000, "failed": 0, "p50_ms": 5.0, "p99_ms": 40.0},
            "burst_paced": {"ok": 500, "failed": 30, "p50_ms": 30.0, "p99_ms": 900.0},
            "burst_ok": 2000, "burst_failed": 900, "burst_window_s": 10.04, "recovery_s": 2.0,
            "step_series": _series(ADVANCING), "members_before": MEMBERS,
            "members_after": MEMBERS | {"worker2"},
            "last_summary": {"serve": {"overloads": 1200, "shed_total": 0,
                                       "queue_deadline_drops": 0},
                             "ps": {"shed_total": 0, "leases_expired": 0}, "dsvc": {},
                             "retry": {"spent": 3}}}
OVERLOAD_LOAD = {"predict_ok": 3000, "predict_failed": 40, "p99_ms": 200.0}


def _summary(serve=None, ps=None):
    last = OVERLOAD["last_summary"]
    return {**last, "serve": {**last["serve"], **(serve or {})}, "ps": {**last["ps"], **(ps or {})}}


#: (records, the gates that must fail) a case.
OVERLOAD_BROKEN = [
    ({"baseline": {"ok": 1000, "failed": 1, "p50_ms": 5.0, "p99_ms": 40.0}},
     {"zero_failed_baseline"}),
    ({"baseline": {"ok": 0, "failed": 0, "p50_ms": 0.0, "p99_ms": 0.0}}, {"baseline_served"}),
    ({"burst_ok": 0, "burst_paced": {"ok": 400, "failed": 0, "p50_ms": 9.0, "p99_ms": 20.0}},
     {"goodput_floor"}),
    ({"last_summary": _summary(ps={"leases_expired": 1})}, {"zero_lease_expirations"}),
    ({"last_summary": _summary(ps={"leases_expired": -1})}, {"zero_lease_expirations"}),
    ({"members_after": MEMBERS - {"worker1"}}, {"members_retained"}),
    ({"recovery_s": -1.0}, {"p99_recovered_in_bound"}),
    ({"step_series": _series(NOT_MONOTONE)}, {"step_monotone"}),
    ({"step_series": _series(FLAT)}, {"step_advanced"}),
    ({"last_summary": _summary(serve={"overloads": 0})}, {"overload_tripped"}),
]


def test_overload_verdict():
    """The overload verdict passes on a clean run with the root's gate names,
    and on each broken record fails with exactly the gates named false."""
    v = loadsim.overload_verdict(OVERLOAD, OVERLOAD_LOAD, _ns("--scenario=overload"))
    assert v["slo_pass"] and list(v["gates"]) == _gates_of("loadsim_overload_baseline.json")
    assert v["burst_goodput_qps"] == round(2500 / 10.04, 2) and v["burst_window_s"] == 10.0
    assert v["batcher_overloads"] == 1200 and v["shed_total"] == 0 and v["retry"] == {"spent": 3}
    assert v["goodput_floor_qps"] == 50.0 and v["baseline_p99_ms"] == 40.0
    # Sheds alone trip it too (the core's RETRY_LATER answers).
    shed = dict(OVERLOAD, last_summary=_summary(serve={"overloads": 0, "shed_total": 5,
                                                       "queue_deadline_drops": 5}))
    v = loadsim.overload_verdict(shed, OVERLOAD_LOAD, _ns("--scenario=overload"))
    assert v["slo_pass"] and v["queue_deadline_drops"] == 5
    for rec, want in OVERLOAD_BROKEN:
        v = loadsim.overload_verdict(dict(OVERLOAD, **rec), OVERLOAD_LOAD,
                                     _ns("--scenario=overload"))
        assert not v["slo_pass"] and _false(v) == want, rec


TENANTS = {"runa": {"shed_quota": 2000, "shed_total": 2000, "ps_objects": 3, "members": 3},
           "runb": {"shed_quota": 0, "shed_total": 0, "ps_objects": 3, "members": 4}}
MT = {"baseline": {"ok": 1000, "failed": 0, "p50_ms": 8.0, "p99_ms": 30.0},
      "noisy": {"ok": 1000, "failed": 0, "p50_ms": 20.0, "p99_ms": 120.0},
      "tail": {"ok": 900, "failed": 0, "p50_ms": 8.0, "p99_ms": 15.0},
      "noise_ok": 5000, "noise_failed": 300, "step_series": _series(ADVANCING),
      "last_summary": {"ps": {"leases_expired": 0}, "tenants": TENANTS}}
MT_LOAD = {"predict_ok": 3000, "predict_failed": 0, "p99_ms": 100.0}


def _tenants(t: str, **row) -> dict:
    return dict(MT["last_summary"], tenants={**TENANTS, t: {**TENANTS[t], **row}})


#: (records, load totals, the gates that must fail) a case.
MT_BROKEN = [
    ({}, {"predict_failed": 1}, {"b_zero_failed"}),
    ({"baseline": {"ok": 1000, "failed": 1, "p50_ms": 8.0, "p99_ms": 30.0}}, {},
     {"b_baseline_served"}),
    ({"noisy": {"ok": 1000, "failed": 0, "p50_ms": 20.0, "p99_ms": 151.0}}, {},
     {"b_p99_bounded"}),
    ({"noise_ok": 0, "noise_failed": 0}, {}, {"noise_offered"}),
    ({"last_summary": _tenants("runa", shed_quota=0)}, {}, {"a_quota_tripped"}),
    ({"last_summary": _tenants("runb", shed_total=1)}, {}, {"b_not_shed"}),
    ({"last_summary": _tenants("runa", members=0)}, {}, {"namespace_isolated"}),
    ({"last_summary": _tenants("runb", ps_objects=0)}, {}, {"namespace_isolated"}),
    ({"last_summary": dict(MT["last_summary"], ps={"leases_expired": 2})}, {},
     {"zero_lease_expirations"}),
    ({"step_series": _series(NOT_MONOTONE)}, {}, {"step_monotone"}),
    ({"step_series": _series(FLAT)}, {}, {"step_advanced"}),
]


def test_multitenant_verdict():
    """The multitenant verdict passes on a clean run with the root's gate names,
    and on each broken record fails with exactly the gates named false."""
    v = loadsim.multitenant_verdict(MT, MT_LOAD, _ns("--scenario=multitenant"))
    assert v["slo_pass"] and list(v["gates"]) == _gates_of("loadsim_multitenant_baseline.json")
    # The target is the floor (150 ms) over 3 x the 30 ms baseline.
    assert v["noisy_p99_target_ms"] == 150.0 and v["tenants"] == TENANTS
    for rec, load, want in MT_BROKEN:
        v = loadsim.multitenant_verdict(dict(MT, **rec), dict(MT_LOAD, **load),
                                        _ns("--scenario=multitenant"))
        assert not v["slo_pass"] and _false(v) == want, (rec, load)


def test_client_path_imports_no_torch():
    """The clients, the pool and its discovery, the PS and wire modules,
    the data service, dtxtop and loadsim (the burst child's module) load
    without torch; the replica's names still resolve, lazily."""
    code = ("import sys\n"
            "from distributed_tensorflow_examples_tpu_torch.serve import (\n"
            "    LeaseServeDiscovery, ServeClient, ServePool, client)\n"
            "from distributed_tensorflow_examples_tpu_torch.parallel import (\n"
            "    membership, ps_service, reshard, retry, server_core, tenancy, wire)\n"
            "from distributed_tensorflow_examples_tpu_torch.data import data_service\n"
            "from distributed_tensorflow_examples_tpu_torch.tools import dtxtop, loadsim\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    from distributed_tensorflow_examples_tpu_torch import serve
    from distributed_tensorflow_examples_tpu_torch.serve import model_server

    assert serve.ModelReplicaServer is model_server.ModelReplicaServer
    assert serve.host_serve_task is model_server.host_serve_task
    assert serve.client.OVERLOAD == model_server.OVERLOAD
    assert serve.client.SRV_PREDICT == model_server.SRV_PREDICT
    with pytest.raises(AttributeError):
        serve.no_such_name  # noqa: B018


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


def test_unpaced_generator_windows_tenant_and_burst_clients(tmp_path):
    """An unpaced, tenant-tagged generator with a pool a thread against an
    in-process replica: its windows drain and add up to its totals, and the
    replica's core counts the tenant; then the burst-client processes:
    one released by ``go`` serves predicts, one whose stdin closes first
    exits without load."""
    ModelRegistry(str(tmp_path)).publish("default", np.zeros(784 * 3, np.float32), step=1,
                                         version=1)
    server = ModelReplicaServer({"w": (784, 3)}, _apply, device="cpu",
                                registry_dir=str(tmp_path), model_version=1, role="serve0",
                                max_wait_ms=1.0)
    addr = ("127.0.0.1", server.port)
    children, gen = [], None
    try:
        gen = loadsim.LoadGenerator([], [addr], qps=None, threads=2, deadline_s=10.0, rows=2,
                                    pool_per_thread=True, tenant="runa", role="t_burst_sv")
        gen.start()
        t_end = time.monotonic() + 10.0
        while gen.ok < 40 and time.monotonic() < t_end:
            time.sleep(0.02)
        first = gen.snap_window()
        second = gen.snap_window()
        load = gen.stop()
        gen = None
        assert first["ok"] >= 40 and first["failed"] == 0 and first["p99_ms"] > 0.0
        assert load["predict_ok"] >= first["ok"] + second["ok"] and load["predict_failed"] == 0
        assert server.stats()["core"]["tenants"]["runa"]["requests"] >= load["predict_ok"]

        ns = loadsim.parse_args(["--scenario=overload", "--burst_rows=2"])
        children = loadsim.spawn_clients([server.port], 2, 2, ns, loadsim.task_env(""))
        loadsim.go(children[:1], 1.0)
        out, _ = children[1].communicate(timeout=60)  # closes its stdin: no go line
        assert children[1].returncode == 0 and out == ""
        ok, failed = loadsim.await_clients(children[:1], lambda: None, time.monotonic() + 30.0)
        assert ok > 0 and failed == 0 and children[0].returncode == 0
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.communicate()
        if gen is not None:
            gen.stop()
        server.stop()
