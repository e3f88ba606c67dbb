"""The port's ``tools/dtxtop.py`` against the root ``tools/dtxtop.py``: one
in-process cluster of the port's servers (two PS tasks, the first
resharded away to the second by a committed record; leases and PS objects
under two tenants; two registry-pinned replicas on the CPU) scraped by
both tools, which must read the same rows and rollups; the twins of the
root's wrong-service, down-role and shard-resolution tests; and the
twin's ``--json`` CLI in a process of its own, which scrapes the cluster
without torch."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu_torch.data import data_service
from distributed_tensorflow_examples_tpu_torch.parallel import (
    membership, ps_service, reshard, tenancy)
from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry, ModelReplicaServer
from distributed_tensorflow_examples_tpu_torch.tools import dtxtop
from tools import dtxtop as root_dtxtop

torch.set_num_threads(1)


def _apply(params, batch):
    return batch["image"] @ params["w"]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """PS ``old`` (layout 1) whose committed record moved the layout to PS
    ``new`` (layout 2); on ``new``: a PS object and a worker lease of each
    tenant (runa's worker0, runb's worker1), and two replicas of tenant
    runb pinned to registry versions 1 and 2, leased there."""
    reg_dir = str(tmp_path_factory.mktemp("registry"))
    reg = ModelRegistry(reg_dir)
    for version, step in ((1, 7), (2, 9)):
        reg.publish(tenancy.qualify("runb", "default"), np.full(784 * 3, float(version), np.float32), step=step,
                    version=version)
    old = ps_service.start_server(0, layout_version=1)
    new = ps_service.start_server(0, layout_version=2)
    old_addrs, new_addrs = [("127.0.0.1", old)], [("127.0.0.1", new)]
    record = reshard.pack_record(2, new_addrs, 64, from_version=1, from_addrs=old_addrs)
    owned = []
    try:
        for port in (old, new):
            c = ps_service.PSClient("127.0.0.1", port, timeout_s=5.0)
            c.reshard_announce(2, record)
            c.reshard_commit(2)
            c.close()
        for i, tenant in enumerate(("runa", "runb")):
            c = ps_service.PSClient("127.0.0.1", new, timeout_s=5.0, tenant=tenant)
            owned.append(c)
            ps_service.RemoteParamStore(c, "params", 16).set(1, np.zeros(16, np.float32))
            owned.append(membership.LeaseHeartbeat(new_addrs, f"worker{i}", kind="worker",
                                                   ttl_s=30.0, tenant=tenant))
        servers = [ModelReplicaServer({"w": (784, 3)}, _apply, new_addrs, device="cpu",
                                      registry_dir=reg_dir, model_version=v, role=f"serve{v}",
                                      lease_ttl_s=30.0, max_wait_ms=1.0, tenant="runb")
                   for v in (1, 2)]
        owned += servers
        coord = ps_service.PSClient(*new_addrs[0], timeout_s=5.0)
        owned.append(coord)
        t_end = time.monotonic() + 10.0
        while len(membership.live_members(coord)) < 4 and time.monotonic() < t_end:
            time.sleep(0.05)
        yield {"old": old_addrs, "new": new_addrs, "servers": servers}
    finally:
        for o in reversed(owned):
            (o.stop if hasattr(o, "stop") else o.close)()
        for port in (old, new):
            ps_service.stop_server(port)


def _rows(snap: dict) -> list:
    """Each role's identity and the stats that no scrape moves."""
    keep = ("shard_id", "shard_count", "layout_version", "model_step", "model_version")
    return [(r["role"], r["kind"], r["addr"], r.get("shard"), r.get("replica"), r["ok"],
             {k: r["stats"][k] for k in keep if k in r.get("stats", {})})
            for r in snap["roles"]]


def _rollups(snap: dict) -> dict:
    """The summary without the counters that each scrape moves."""
    su = snap["summary"]
    return {
        "roles": (su["roles_total"], su["roles_ok"]),
        "reshard": su["ps"]["reshard"],
        "epochs": su["ps"]["epochs"],
        "leases_expired": su["ps"]["leases_expired"],
        "model_steps": sorted(su["serve"]["model_steps"]),
        "model_versions": sorted(su["serve"]["model_versions"]),
        "by_version": {v: d["replicas"] for v, d in su["serve"]["by_version"].items()},
        "tenants": {t: {k: d[k] for k in ("ps_objects", "ps_leases", "members", "shed_total",
                                         "shed_quota")}
                    for t, d in su["tenants"].items()},
        "members": su["members"],
    }


def test_root_and_twin_read_the_same_port_cluster(cluster):
    """The twin and the root tool, pointed at the retired PS, follow the
    committed record to the new layout (``follow_reshard`` agrees) and read
    the same roles, leases, per-version and per-tenant rollups."""
    twin = dtxtop.snapshot(cluster["old"], ps_shards=1, ps_replicas=1, timeout_s=5.0)
    root = root_dtxtop.snapshot(cluster["old"], ps_shards=1, ps_replicas=1, timeout_s=5.0)
    assert twin["schema_version"] == root["schema_version"] == 1
    assert _rows(twin) == _rows(root)
    assert _rollups(twin) == _rollups(root)
    assert sorted(twin["summary"]) == sorted(root["summary"])
    su = twin["summary"]
    assert su["roles_ok"] == su["roles_total"] == 3  # the new PS and the two leased replicas
    assert su["ps"]["reshard"]["committed"] == 2
    assert su["ps"]["reshard"]["followed_from"] == [f"127.0.0.1:{cluster['old'][0][1]}"]
    assert su["ps"]["epochs"] == [2]
    assert su["serve"]["model_versions"] == [1, 2] and sorted(su["serve"]["by_version"]) == ["1", "2"]
    tenants = su["tenants"]
    assert tenants["runa"]["members"] == 1 and tenants["runb"]["members"] == 3
    assert tenants["runa"]["ps_objects"] >= 1 and tenants["runb"]["ps_objects"] >= 1
    assert su["members"] == {"total": 4, "workers": ["worker0", "worker1"],
                             "serve": ["serve1", "serve2"]}
    table = dtxtop.render(twin, root)
    assert "serve versions: v1:" in table and "tenant runa" in table and "epoch v2" in table
    for tool in (dtxtop, root_dtxtop):
        addrs, shards, replicas, info = tool.follow_reshard(cluster["old"], 1, 1, 5.0)
        assert ([tuple(a) for a in addrs], shards, replicas) == (cluster["new"], 1, 1)
        assert info["committed"] == 2 and info["pending"] == 0


def test_twin_cli_scrapes_without_torch(cluster):
    """``python -m ...tools.dtxtop --json`` exits 0 against the cluster
    and prints the snapshot, in a process that never imports torch."""
    code = ("import sys\n"
            "from distributed_tensorflow_examples_tpu_torch.tools import dtxtop\n"
            f"rc = dtxtop.main(['--json', '--ps_hosts=127.0.0.1:{cluster['new'][0][1]}',"
            " '--ps_shards=1'])\n"
            "print('torch' in sys.modules)\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "False"
    snap = json.loads(lines[-2])
    assert snap["summary"]["roles_ok"] == snap["summary"]["roles_total"] == 3
    assert snap["summary"]["members"]["serve"] == ["serve1", "serve2"]


def test_wrong_service_down_roles_and_shard_resolution():
    """A PS entry pointing at a data service names the service reached,
    the data-service entry pointing at the PS likewise, and a dead port is
    a DOWN row, not an exception; ``--ps_replicas`` without
    ``--ps_shards`` resolves the shard count from the replica tier, as
    the root's does (the root's tests, on the port's servers)."""
    addrs = [("h", 1), ("h", 2), ("h", 3), ("h", 4)]
    for shards, replicas, want in ((-1, 2, 2), (-1, 1, 4), (3, 2, 3)):
        assert dtxtop.resolve_shards(addrs, shards, replicas) == want
        assert root_dtxtop.resolve_shards(addrs, shards, replicas) == want
        roles = dtxtop.cluster_roles(addrs, ps_shards=shards, ps_replicas=replicas)
        assert roles == root_dtxtop.cluster_roles(addrs, ps_shards=shards, ps_replicas=replicas)
        assert [(r["shard"], r["replica"]) for r in roles] == [(i % want, i // want)
                                                              for i in range(4)]
    dsvc = data_service.DataServiceServer([{"x": np.arange(4, dtype=np.float32)}],
                                          batch_size=2)
    pa = ps_service.start_server(0)
    try:
        snap = dtxtop.snapshot([("127.0.0.1", dsvc.port)], ps_shards=1,
                               dsvc_addrs=[("127.0.0.1", pa)])
        ps_row, dsvc_row = snap["roles"]
        assert not ps_row["ok"] and "wrong-service" in ps_row["error"]
        assert "data service" in ps_row["error"]
        assert not dsvc_row["ok"] and "native PS state service" in dsvc_row["error"]
        assert snap["summary"]["roles_ok"] == 0
        dead = dtxtop.snapshot([], dsvc_addrs=[("127.0.0.1", 1)])
        assert not dead["roles"][0]["ok"]
        assert dtxtop.main(["--json", "--serve_hosts=127.0.0.1:1", "--timeout_s=1"]) == 1
    finally:
        dsvc.stop()
        ps_service.stop_server(pa)
