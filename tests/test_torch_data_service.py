"""The port's data service (``data/data_service.py``) and ``--data_dir``
resolution (``data/streams.py``) on the CPU, against the JAX package's.

- The JAX data-service scenarios on the port's server and client: the
  batch codec, the wrong-service HELLO refusal, the split protocol (FCFS,
  replay-safe GET_SPLIT, WAIT, epoch roll), the claim statuses, the
  stale-epoch ack, a restart during a strict GET_SPLIT, batches
  deterministic in (seed, split) across restarts, two workers consuming
  one epoch with every split once, and a restart mid-epoch that still
  visits every split.
- Across packages: a port client reads a JAX server's batches, and a JAX
  client a port server's, byte for byte against the same package's pair.
- ``resolve_image_source`` and ``train_iter`` on all four branches
  (memory, ``.dtxr``, ``.npz``, ``dsvc://``) against JAX's ``streams`` on
  the same inputs, and rank r of 2 of a streamed source against JAX's
  ``train_iter(worker=r, n_workers=2)``.
- The supervised ``--job_name=data_service`` task of the CIFAR-10 CLI,
  killed by ``DTX_FAULT_PLAN`` mid-epoch and restarted by its supervisor,
  heals: two workers still visit every split, and the clients log
  ``dsvc_reincarnation`` (gated on splits and events, not on time).
- The W2 CLI trains 3 steps from ``.npz`` and ``.dtxr`` shards and from a
  data service with the JAX CLI's per-step losses (an ``Experiment``
  wired as the JAX CLI wires it, fed by JAX's ``streams``), both in
  float32: within ``LOSS_ATOL``.  The directory holds 2 files (1 train, 1
  held out), so the native loader runs one thread and its order is
  deterministic.

Batches are compared exactly (the same numpy code on the same bytes).
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data import data_service as jax_dsvc
from distributed_tensorflow_examples_tpu.data import datasets as jax_datasets
from distributed_tensorflow_examples_tpu.data import streams as jax_streams
from distributed_tensorflow_examples_tpu.models import cnn as jax_cnn
from distributed_tensorflow_examples_tpu.parallel import mesh as jax_mesh
from distributed_tensorflow_examples_tpu.train import hooks as jax_hooks
from distributed_tensorflow_examples_tpu_torch.data import data_service as dsvc
from distributed_tensorflow_examples_tpu_torch.data import datasets, filestream, native_loader, streams
from distributed_tensorflow_examples_tpu_torch.examples import cifar10_cnn
from distributed_tensorflow_examples_tpu_torch.models import cnn
from distributed_tensorflow_examples_tpu_torch.parallel import ps_service, wire
from distributed_tensorflow_examples_tpu_torch.train import hooks
from distributed_tensorflow_examples_tpu_torch.utils import faults
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_ports

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "distributed_tensorflow_examples_tpu_torch.examples.cifar10_cnn"
#: Per-step losses of the W2 CLI against the JAX CLI's wiring, float32 at
#: the CLI's widths: the two frameworks sum the convolutions in other
#: orders (seen 4.8e-7 over 3 steps, one float32 ulp at 2.3).
LOSS_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_fault_env(monkeypatch):
    monkeypatch.delenv("DTX_FAULT_PLAN", raising=False)
    monkeypatch.delenv("DTX_FAULT_ROLE", raising=False)
    monkeypatch.setattr(faults, "_role", None)


def _splits(n=6, rows=8):
    return [{"image": np.full((rows, 4), i, np.uint8), "label": np.arange(rows, dtype=np.int64)}
            for i in range(n)]


def _source(port, w, mod=dsvc, **kw):
    kw.setdefault("op_timeout_s", 10.0)
    kw.setdefault("reconnect_deadline_s", 30.0)
    kw.setdefault("role", f"dw{w}_ds")
    return mod.RemoteDatasetSource(f"dsvc://127.0.0.1:{port}", worker_id=w, **kw)


def _equal_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def _take(it, n):
    return [next(it) for _ in range(n)]


# ----------------------------------------------------------------------------
# Codec and HELLO
# ----------------------------------------------------------------------------


def test_batch_codec_zero_copy_roundtrip():
    a, b = socket.socketpair()
    try:
        batch = {
            "image": np.arange(48, dtype=np.uint8).reshape(2, 4, 6),
            "label": np.array([3, -1], np.int64),
            "w": np.array([[0.5]], np.float32),
            "scalar": np.float32(3.5),
        }
        bufs = dsvc.encode_batch(batch)
        assert b"".join(bytes(x) for x in bufs) == b"".join(
            bytes(x) for x in jax_dsvc.encode_batch(batch))
        wire.send_frames(a, bufs)
        out = dsvc.read_batch(b, dsvc.encoded_nbytes(bufs))
        assert set(out) == set(batch)
        for k in batch:
            np.testing.assert_array_equal(out[k], batch[k])
            assert out[k].dtype == batch[k].dtype
    finally:
        a.close()
        b.close()


def test_dialing_the_wrong_service_fails_loudly():
    port = ps_service.start_server(0)
    try:
        with pytest.raises(dsvc.DSVCError, match="not a data service"):
            dsvc.DataServiceClient("127.0.0.1", port, role="probe_ds", reconnect_deadline_s=0.0)
    finally:
        ps_service.stop_server()


def test_op_codes_and_statuses_are_the_jax_ones():
    names = ("DSVC_HELLO", "DSVC_REGISTER", "DSVC_GET_SPLIT", "DSVC_CLAIM_SPLIT",
             "DSVC_GET_BATCH", "DSVC_HEARTBEAT", "DSVC_STATS", "DSVC_GET_EVAL", "DSVC_SHUTDOWN",
             "OK", "END_OF_SPLIT", "CLAIM_DONE", "CLAIM_TAKEN", "WAIT", "EPOCH_ROLLED", "ERR",
             "SERVICE_TAG")
    assert {n: getattr(dsvc, n) for n in names} == {n: getattr(jax_dsvc, n) for n in names}


# ----------------------------------------------------------------------------
# Split protocol (the JAX scenarios on the port's server)
# ----------------------------------------------------------------------------


def test_split_protocol_fcfs_ack_wait_and_epoch_roll():
    srv = dsvc.DataServiceServer(_splits(3), batch_size=4, seed=0)
    try:
        c = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=0, role="p0_ds")
        c2 = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=1, role="p1_ds")
        s0, raw = c.call(dsvc.DSVC_GET_SPLIT, a=0, b=-1)
        info = json.loads(raw)
        assert s0 >= 0 and info["epoch"] == 0 and info["num_batches"] == 2
        assert c.call(dsvc.DSVC_GET_SPLIT, a=0, b=-1)[0] == s0  # replay-safe
        s1, _ = c2.call(dsvc.DSVC_GET_SPLIT, a=1, b=-1)
        assert s1 >= 0 and s1 != s0
        s2, _ = c.call(dsvc.DSVC_GET_SPLIT, a=0, b=s0)
        assert s2 >= 0 and s2 not in (s0, s1)
        assert c.call(dsvc.DSVC_GET_SPLIT, a=0, b=s2)[0] == dsvc.WAIT
        c2.call(dsvc.DSVC_GET_SPLIT, name="epoch=0", a=1, b=s1)
        se, raw = c.call(dsvc.DSVC_GET_SPLIT, name="epoch=0,strict", a=0, b=-1)
        assert se == dsvc.EPOCH_ROLLED and json.loads(raw)["epoch"] == 1
        st = c.stats()
        assert st["epochs_completed"] == 1 and st["last_epoch_min_visits"] >= 1
        assert st["reassigned"] == 0 and st["service"] == "dsvc"
        c.close()
        c2.close()
    finally:
        srv.stop()


def test_claim_split_statuses():
    srv = dsvc.DataServiceServer(_splits(2), batch_size=4, seed=0, shuffle=False)
    try:
        c0 = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=0, role="c0_ds")
        c1 = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=1, role="c1_ds")
        s, _ = c0.call(dsvc.DSVC_GET_SPLIT, a=0, b=-1)
        st, raw = c0.call(dsvc.DSVC_CLAIM_SPLIT, a=0, b=s)
        assert st == dsvc.OK and json.loads(raw)["num_batches"] == 2
        assert c1.call(dsvc.DSVC_CLAIM_SPLIT, a=1, b=s)[0] == dsvc.CLAIM_TAKEN
        c0.call(dsvc.DSVC_GET_SPLIT, a=0, b=s)
        assert c1.call(dsvc.DSVC_CLAIM_SPLIT, a=1, b=s)[0] == dsvc.CLAIM_DONE
        assert c1.call(dsvc.DSVC_CLAIM_SPLIT, a=1, b=99)[0] == dsvc.ERR
        c0.close()
        c1.close()
    finally:
        srv.stop()


def test_stale_epoch_ack_does_not_poison_the_new_epoch():
    """A worker that stalls past reassignment and acks after the epoch
    rolled must not complete the new epoch's copy of its split."""
    srv = dsvc.DataServiceServer(_splits(2), batch_size=4, seed=0, shuffle=False,
                                 reassign_after_s=0.2)
    try:
        cA = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=0, role="sa_ds")
        cB = dsvc.DataServiceClient("127.0.0.1", srv.port, worker_id=1, role="sb_ds")
        sA, _ = cA.call(dsvc.DSVC_GET_SPLIT, name="epoch=0", a=0, b=-1)
        sB, _ = cB.call(dsvc.DSVC_GET_SPLIT, name="epoch=0", a=1, b=-1)
        deadline = time.time() + 30
        got, ack = -1, sB
        while time.time() < deadline:
            got, _ = cB.call(dsvc.DSVC_GET_SPLIT, name="epoch=0", a=1, b=ack)
            ack = -1
            if got == sA:
                break
            time.sleep(0.05)
        assert got == sA, "stale assignment was never handed to the live worker"
        assert cB.call(dsvc.DSVC_GET_SPLIT, name="epoch=0,strict", a=1, b=sA)[0] == \
            dsvc.EPOCH_ROLLED
        sA2, raw = cA.call(dsvc.DSVC_GET_SPLIT, name="epoch=0", a=0, b=sA)
        assert json.loads(raw)["epoch"] == 1 and sA2 >= 0
        assert srv.stats()["completed"] == 0
        cA.close()
        cB.close()
    finally:
        srv.stop()


def test_restart_during_strict_get_split_does_not_end_the_epoch_early():
    splits = _splits(4)
    srv = dsvc.DataServiceServer(splits, batch_size=4, seed=0)
    port = srv.port
    warm = _source(port, 7)
    assert sum(1 for _ in warm.batches(repeat=False)) == 4 * 2
    warm.close()
    src = _source(port, 0)
    assert int(src.server_info["epoch"]) == 1
    srv.stop()
    srv2 = dsvc.DataServiceServer(splits, batch_size=4, seed=0, port=port)
    try:
        assert {int(b["image"][0, 0]) for b in src.batches(repeat=False)} == set(range(4))
        src.close()
    finally:
        srv2.stop()


def test_batches_deterministic_in_seed_and_split_not_epoch():
    srv = dsvc.DataServiceServer(_splits(2, rows=12), batch_size=4, seed=7)
    port = srv.port
    try:
        c = dsvc.DataServiceClient("127.0.0.1", port, role="d0_ds")
        _, b0 = c.call(dsvc.DSVC_GET_BATCH, a=0, b=1, batch=True)
        c.close()
    finally:
        srv.stop()
    srv2 = dsvc.DataServiceServer(_splits(2, rows=12), batch_size=4, seed=7, port=port)
    try:
        c = dsvc.DataServiceClient("127.0.0.1", port, role="d0_ds")
        _, b1 = c.call(dsvc.DSVC_GET_BATCH, a=0, b=1, batch=True)
        c.close()
        _equal_batches([b0], [b1])
    finally:
        srv2.stop()


def _consume_epoch(port, w, seen, counts, errors, delay=0.0, marker=None):
    try:
        src = _source(port, w, reconnect_deadline_s=120.0)
        for b in src.batches(repeat=False):
            seen[w].add(marker(b) if marker else int(b["image"][0, 0]))
            counts[w] += 1
            if delay:
                time.sleep(delay)
        src.close()
    except BaseException as e:  # noqa: BLE001 — asserted by the test
        errors.append((w, e))


def _two_workers(port, **kw):
    seen, counts, errors = {0: set(), 1: set()}, {0: 0, 1: 0}, []
    ts = [threading.Thread(target=_consume_epoch, args=(port, w, seen, counts, errors), kwargs=kw)
          for w in (0, 1)]
    for t in ts:
        t.start()
    return ts, seen, counts, errors


def test_two_workers_consume_one_epoch_every_split_once():
    srv = dsvc.DataServiceServer(_splits(6, rows=8), batch_size=4, seed=0)
    try:
        ts, seen, counts, errors = _two_workers(srv.port)
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts) and not errors, errors
        assert seen[0] | seen[1] == set(range(6)) and not (seen[0] & seen[1])
        assert counts[0] + counts[1] == 6 * 2
        st = _source(srv.port, 9).stats()
        assert st["epochs_completed"] == 1 and st["last_epoch_min_visits"] == 1
    finally:
        srv.stop()


def test_server_restart_mid_epoch_still_visits_every_split(caplog):
    caplog.set_level("INFO", logger="dtx.faults")
    splits = _splits(8, rows=16)  # 32 batches an epoch
    srv = dsvc.DataServiceServer(splits, batch_size=4, seed=0)
    port = srv.port
    ts, seen, counts, errors = _two_workers(port, delay=0.05)
    deadline = time.time() + 30
    while sum(counts.values()) < 6 and time.time() < deadline:
        time.sleep(0.01)
    assert sum(counts.values()) >= 6, "workers never started consuming"
    srv.stop()
    srv2 = dsvc.DataServiceServer(splits, batch_size=4, seed=0, port=port)
    try:
        for t in ts:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in ts) and not errors, errors
        assert seen[0] | seen[1] == set(range(8))
        events = [r.getMessage() for r in caplog.records if "dtx.faults" in r.getMessage()]
        assert any("event=reconnected" in m and "_ds" in m for m in events), events
        assert any("event=dsvc_reincarnation" in m for m in events), events
    finally:
        srv2.stop()


def test_bad_spec_missing_eval_and_unreachable_service():
    with pytest.raises(ValueError, match="dsvc://"):
        dsvc.parse_spec("dsvc://nohost")
    with pytest.raises(ValueError, match="not a data-service spec"):
        dsvc.parse_spec("/some/dir")
    srv = dsvc.DataServiceServer(_splits(1), batch_size=4)
    try:
        src = _source(srv.port, 0)
        assert src.eval_chunk() is None
        src.close()
    finally:
        srv.stop()
    # Nothing listens there: the client gives up once its deadline passes.
    (port,) = free_ports(1)
    with pytest.raises(dsvc.DSVCDeadlineError, match="unreachable"):
        _source(port, 0, reconnect_deadline_s=0.5)


# ----------------------------------------------------------------------------
# Across packages
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("server,client", [(jax_dsvc, dsvc), (dsvc, jax_dsvc)],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_clients_and_servers_interoperate_with_equal_bytes(server, client):
    def epoch(srv_mod, cli_mod):
        srv = srv_mod.DataServiceServer(_splits(5, rows=12), batch_size=4, seed=3,
                                        eval_chunk=_splits(1, rows=5)[0])
        try:
            src = _source(srv.port, 0, mod=cli_mod)
            got = list(src.batches(repeat=False))
            ev = src.eval_chunk()
            stats = src.stats()
            src.close()
            return got, ev, stats
        finally:
            srv.stop()

    mixed, mixed_eval, mixed_stats = epoch(server, client)
    same, same_eval, _ = epoch(server, server)
    assert len(mixed) == 15
    _equal_batches(mixed, same)
    _equal_batches([mixed_eval], [same_eval])
    assert mixed_stats["epochs_completed"] == 1 and mixed_stats["service"] == "dsvc"


# ----------------------------------------------------------------------------
# streams: the four branches against JAX's
# ----------------------------------------------------------------------------


def _u8_images(n, seed, size=8):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, size=(n, size, size, 3)).astype(np.uint8),
            "label": rng.integers(0, 10, size=n).astype(np.int32)}


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """5 ``.npz`` shards of 16 rows (4 train, 1 held out).  The native
    loader runs a thread a shard (up to 2) and its threads race for
    chunks, so the ``.dtxr`` directories give each reader one train shard:
    ``dtxr2`` 1 train shard of 32 rows and 1 held out, ``dtxr3`` 2 train
    shards (one a rank of 2) and 1 held out."""
    root = tmp_path_factory.mktemp("shards")
    x = _u8_images(80, 0)
    filestream.write_array_shards(str(root / "npz"), x, rows_per_shard=16)
    native_loader.write_raw_shards(str(root / "dtxr2"), {k: v[:48] for k, v in x.items()},
                                   shard_records=32)
    native_loader.write_raw_shards(str(root / "dtxr3"), {k: v[:48] for k, v in x.items()},
                                   shard_records=16)
    return root


class _Servers:
    """A port and a JAX data service over one ``.npz`` directory, one
    worker each, so the FCFS claims of each are its own."""

    def __init__(self, data_dir, batch_size, seed=0):
        self.port = dsvc.serve_from_dir(data_dir, batch_size=batch_size, seed=seed)
        self.jax = jax_dsvc.serve_from_dir(data_dir, batch_size=batch_size, seed=seed)

    def specs(self):
        return f"dsvc://127.0.0.1:{self.port.port}", f"dsvc://127.0.0.1:{self.jax.port}"

    def stop(self):
        self.port.stop()
        self.jax.stop()


def _fallbacks():
    x, t = _u8_images(64, 1), _u8_images(16, 2)
    return (lambda: datasets.ArrayDataset(x, t, "synthetic", 10),
            lambda: jax_datasets.ArrayDataset(x, t, "synthetic", 10))


@pytest.mark.parametrize("kind", ["memory", "native", "stream", "dsvc"])
def test_resolution_and_train_iter_match_jax_streams(shard_dirs, kind):
    fallback, jfallback = _fallbacks()
    servers = _Servers(str(shard_dirs / "npz"), batch_size=8) if kind == "dsvc" else None
    try:
        if kind == "dsvc":
            data_dir, jdata_dir = servers.specs()
        else:
            data_dir = jdata_dir = {"memory": None, "native": str(shard_dirs / "dtxr2"),
                                    "stream": str(shard_dirs / "npz")}[kind]
        src = streams.resolve_image_source(data_dir, fallback=fallback, seed=4, num_classes=10)
        jsrc = jax_streams.resolve_image_source(jdata_dir, fallback=jfallback, seed=4,
                                                num_classes=10)
        assert src.kind == jsrc.kind == kind
        assert src.train_shards == jsrc.train_shards
        assert len(src.train_shards) == {"native": 1, "stream": 4}.get(kind, 0)
        assert src.ds.num_classes == 10 and (src.remote_spec != "") == (kind == "dsvc")
        _equal_batches([src.ds.test], [jsrc.ds.test])
        ours = streams.train_iter(src, batch_size=8, seed=4)
        theirs = jax_streams.train_iter(jsrc, batch_size=8, seed=4)
        _equal_batches(_take(ours, 10), _take(theirs, 10))  # past one epoch of 8 batches
        for it in (ours, theirs):
            getattr(it, "close", lambda: None)()
    finally:
        if servers is not None:
            servers.stop()


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("kind", ["native", "stream", "dsvc"])
def test_streamed_rank_is_the_jax_worker_split(shard_dirs, kind, rank):
    """Rank r of 2 at the global batch 16 reads what JAX's worker r of 2
    reads at 8 rows: native shards r::2 at seed + r, the npz stride, the
    service's claims for worker r."""
    servers = _Servers(str(shard_dirs / "npz"), batch_size=8) if kind == "dsvc" else None
    try:
        if kind == "dsvc":
            data_dir, jdata_dir = servers.specs()
        else:
            data_dir = jdata_dir = str(shard_dirs / {"native": "dtxr3", "stream": "npz"}[kind])
        src = streams.resolve_image_source(data_dir, fallback=None, seed=1, num_classes=10)
        jsrc = jax_streams.resolve_image_source(jdata_dir, fallback=None, seed=1, num_classes=10)
        mesh = types.SimpleNamespace(data_index=rank, shape={"data": 2})
        ours = streams.train_iter(src, batch_size=16, seed=1, mesh=mesh, microbatches=2)
        theirs = jax_streams.train_iter(jsrc, batch_size=8, seed=1, worker=rank, n_workers=2)
        got = _take(ours, 6)
        assert all(len(b["label"]) == 8 for b in got)
        _equal_batches(got, _take(theirs, 6))
        # The explicit worker split is the same stream.
        again = streams.train_iter(src, batch_size=8, seed=1, worker=rank, n_workers=2) \
            if kind != "dsvc" else None
        if again is not None:
            _equal_batches(_take(again, 6), got)
        with pytest.raises(ValueError, match="not divisible by 2"):
            streams.train_iter(src, batch_size=15, seed=1, mesh=mesh)
        for it in (ours, theirs):
            getattr(it, "close", lambda: None)()
    finally:
        if servers is not None:
            servers.stop()


# ----------------------------------------------------------------------------
# The supervised data_service task, killed and healed
# ----------------------------------------------------------------------------


def _marker(batch) -> int:
    # Invert the image decode's normalisation (x = v/255 - 0.5).
    return int(round((float(batch["image"].flat[0]) + 0.5) * 255))


def test_data_service_task_kill_mid_epoch_heals_via_supervised_restart(tmp_path, caplog):
    """The CIFAR-10 CLI's ``--job_name=data_service`` task (supervised,
    ``--ps_restarts=2``) dies by ``die:role=data_service0,after_reqs=25``
    mid-epoch; its supervisor restarts it on the same port (the fired spec
    stripped), the clients re-claim their splits in the new incarnation,
    and between two workers every split is visited."""
    caplog.set_level("INFO", logger="dtx.faults")
    n_train = 8
    marker = np.repeat(np.arange(9, dtype=np.uint8), 16)
    filestream.write_array_shards(
        str(tmp_path / "shards"),
        {"image": np.broadcast_to(marker[:, None, None, None], (144, 2, 2, 3)).copy(),
         "label": np.zeros(144, np.int64)},
        rows_per_shard=16)
    (port,) = free_ports(1)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               DTX_FAULT_PLAN="die:role=data_service0,after_reqs=25")
    log = open(tmp_path / "dsvc_task.log", "w")
    # Local batch 8 = --batch_size 16 over 2 workers: 2 batches a split.
    proc = subprocess.Popen(
        [sys.executable, "-m", CLI, "--device=cpu", "--job_name=data_service",
         "--sync_replicas=false", "--worker_hosts=a:1,b:1", "--batch_size=16",
         f"--data_service_hosts=127.0.0.1:{port}", f"--data_dir={tmp_path / 'shards'}",
         "--ps_restarts=2"],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                dsvc.DataServiceClient("127.0.0.1", port, role="probe_ds",
                                       reconnect_deadline_s=0.0).close()
                break
            except OSError:
                assert proc.poll() is None, open(tmp_path / "dsvc_task.log").read()
                time.sleep(0.2)
        else:
            pytest.fail("data service task never came up")
        ts, seen, counts, errors = _two_workers(port, delay=0.03, marker=_marker)
        for t in ts:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in ts), "workers hung"
        assert not errors, errors
        assert seen[0] | seen[1] == set(range(n_train))
        events = [r.getMessage() for r in caplog.records if "dtx.faults" in r.getMessage()]
        assert any("event=dsvc_reincarnation" in m for m in events), events
        ctl = dsvc.DataServiceClient("127.0.0.1", port, role="ctl_ds")
        assert ctl.stats()["incarnation"] != 0
        ctl.shutdown_server()
        ctl.close()
        assert proc.wait(timeout=60) == 0
        out = open(tmp_path / "dsvc_task.log").read()
        assert "child exited 43" in out and f"DSVC_DONE port={port}" in out, out
        assert "supervisor_healed_plan" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()


# ----------------------------------------------------------------------------
# The W2 CLI from shards and from a service, against the JAX CLI's wiring
# ----------------------------------------------------------------------------


class _Losses(hooks.Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))


class _JaxLosses(jax_hooks.Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))


@pytest.fixture(scope="module")
def cifar_shards(tmp_path_factory):
    """2 files of CIFAR-shaped uint8 records in each format: 1 train shard
    of 64 rows, 1 held out of 32."""
    root = tmp_path_factory.mktemp("cifar")
    x = _u8_images(96, 5, size=32)
    native_loader.write_raw_shards(str(root / "dtxr"), x, shard_records=64)
    filestream.write_array_shards(str(root / "npz"), x, rows_per_shard=64)
    return root


@pytest.mark.parametrize("kind", ["stream", "native", "dsvc"])
def test_cnn_cli_steps_match_the_jax_cli_from_streamed_sources(cifar_shards, kind, monkeypatch):
    monkeypatch.setattr(cnn, "Config", functools.partial(cnn.Config, compute_dtype="float32"))
    steps, bs, seed = 3, 16, 2
    servers = _Servers(str(cifar_shards / "npz"), batch_size=bs, seed=seed) \
        if kind == "dsvc" else None
    try:
        if kind == "dsvc":
            data_dir, jdata_dir = servers.specs()
        else:
            data_dir = jdata_dir = str(cifar_shards / ("dtxr" if kind == "native" else "npz"))
        args = cifar10_cnn.build_parser().parse_args(
            ["--device=cpu", "--log_every_steps=1", f"--batch_size={bs}",
             f"--train_steps={steps}", f"--seed={seed}", f"--data_dir={data_dir}"])
        clock = _Losses()
        exp = cifar10_cnn.run_training(args, extra_hooks=[clock])
        assert exp.source.kind == kind and len(exp.source.ds.test["image"]) == 32

        jcfg = jax_cnn.Config(compute_dtype="float32")
        jsrc = jax_streams.resolve_image_source(jdata_dir, fallback=None, seed=seed,
                                                num_classes=10)
        jclock = _JaxLosses()
        jflags = types.SimpleNamespace(**{**vars(args), "watchdog": False, "log_dir": None})
        mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec.parse("data=1"), devices=jax.devices()[:1])
        jexp = jax_train.Experiment(
            init_fn=lambda r: jax_cnn.init(jcfg, r), loss_fn=jax_cnn.loss_fn(jcfg),
            optimizer=optax.sgd(args.learning_rate), rules=jax_cnn.SHARDING_RULES,
            flags=jflags, mesh=mesh, extra_hooks=[jclock])
        jexp.run(jax_streams.train_iter(jsrc, batch_size=bs, seed=seed))
        jexp.writer.close()
        assert len(clock.losses) == len(jclock.losses) == steps
        np.testing.assert_allclose(clock.losses, jclock.losses, rtol=0, atol=LOSS_ATOL)
        assert exp.session.step == steps
    finally:
        if servers is not None:
            servers.stop()
