"""The port's data-parallel spine against the JAX package's, in one process.

The cluster resolver on the same ``TF_CONFIG`` and argument cases (chief,
worker, ps, evaluator, malformed); ``MeshSpec.resolved`` and the mesh
over a world, errors included; the in-memory pipeline's per-rank shards
against the JAX class's per-process ones (both take the process index
and count as arguments); the backend rule; the watchdog with a fake
store; and SyncBN on simulated ranks (``collectives.ThreadRanks``: the
all-reduce an explicit sum over two ranks run as threads) against the
JAX ``batchnorm`` on the 8-device CPU mesh, the JAX Pallas kernels in
interpret mode under ``FORCE_PALLAS`` as the JAX package's own tests run
them, and the plain path against the JAX plain path (GSPMD's global
moments).  The JAX loss is sum(y * w) over the global batch; the port's
ranks each take sum(y_r * w_r) over their rows, so the JAX gradient of x
is the ranks' dx concatenated and the JAX gradient of scale and bias the
ranks' local gradients summed (the data-parallel step then averages
them, with a mean loss).

Tolerances (float32): y 1e-5 relative to its largest (seen 1.3e-7), the
running stats 1e-5 (seen 1.2e-7), dx 1e-4 relative (seen 1.3e-7), dscale
and dbias 1e-4 relative (seen 2.1e-7: two partial sums where JAX sums
eight).
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributed_tensorflow_examples_tpu.data import pipeline as jax_pipeline
from distributed_tensorflow_examples_tpu.models import layers as jax_layers
from distributed_tensorflow_examples_tpu.ops import bn as jax_bn
from distributed_tensorflow_examples_tpu.parallel import dist as jax_dist
from distributed_tensorflow_examples_tpu.parallel import mesh as jax_mesh
from distributed_tensorflow_examples_tpu_torch.data import pipeline
from distributed_tensorflow_examples_tpu_torch.models import layers, lstm
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.utils import threefry

torch.set_num_threads(1)


def _tf_config(cluster, task_type, index=0):
    return json.dumps({"cluster": cluster, "task": {"type": task_type, "index": index}})


TWO = {"worker": ["h0:7000", "h1:7000"]}
CHIEF = {"chief": ["c:7000"], "worker": ["w0:7000", "w1:7000"], "ps": ["p:7001"]}
CLUSTER_CASES = [
    ("nothing", None, {}),
    ("args", None, dict(coordinator_address="h:1", num_processes=2, process_id=1)),
    ("worker_1", _tf_config(TWO, "worker", 1), {}),
    ("chief", _tf_config(CHIEF, "chief", 0), {}),
    ("worker_after_chief", _tf_config(CHIEF, "worker", 1), {}),
    ("ps", _tf_config(CHIEF, "ps", 0), {}),
    ("evaluator", _tf_config(CHIEF, "evaluator", 0), {}),
    ("only_ps", _tf_config({"ps": ["p:1"]}, "ps", 0), {}),
    ("malformed", "{not json", {}),
]


@pytest.mark.parametrize("name,tf_config,kwargs", CLUSTER_CASES, ids=[c[0] for c in CLUSTER_CASES])
def test_resolve_cluster_matches_jax(name, tf_config, kwargs, monkeypatch):
    if tf_config is None:
        monkeypatch.delenv("TF_CONFIG", raising=False)
    else:
        monkeypatch.setenv("TF_CONFIG", tf_config)
    want = jax_dist.resolve_cluster(**kwargs)
    got = dist.resolve_cluster(**kwargs)
    fields = ("coordinator_address", "num_processes", "process_id", "source", "task_type")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.is_ps_task == want.is_ps_task
    if name == "worker_after_chief":
        assert got.process_id == 2 and got.hosts == ("c:7000", "w0:7000", "w1:7000")
        assert got.local_ranks() == (0, 1)  # alone on its host


def test_local_ranks_and_the_backend_rule():
    local = dist.ClusterConfig("localhost:9", 3, 2, "tf_config", "worker",
                               ("localhost:9", "other:9", "localhost:9"))
    assert local.local_ranks() == (1, 2)
    assert dist.ClusterConfig("h:9", 4, 3, "args").local_ranks() == (3, 4)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dist.backend_for(cpu, 2, 0) == "gloo"
    assert dist.backend_for(cuda, 1, 1) == "nccl"  # a card each
    assert dist.backend_for(cuda, 2, 2) == "nccl"
    assert dist.backend_for(cuda, 2, 1) == "gloo"  # two ranks share one card
    assert dist.backend_for(cuda, 8, 4) == "gloo"
    with pytest.raises(ValueError, match="no collective backend"):
        dist.backend_for(torch.device("meta"), 1, 0)
    # No cluster information: one process, no group.
    assert not dist.is_initialized()
    assert (dist.process_index(), dist.process_count(), dist.is_chief()) == (0, 1, True)


RESOLVE_CASES = [("", 1), ("", 2), ("data=2", 2), ("data=4", 2), ("data=-1", 6),
                 ("data=2,model=-1", 4), ("data=3", 4), ("data=-1,model=-1", 4),
                 ("model=3", 4), ("slice=2,data=2", 4)]


@pytest.mark.parametrize("text,n", RESOLVE_CASES)
def test_mesh_spec_resolved_matches_jax(text, n):
    ours, theirs = mesh_lib.MeshSpec.parse(text), jax_mesh.MeshSpec.parse(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    try:
        want = theirs.resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours.resolved(n)
        assert str(got.value) == str(e)
        return
    assert ours.resolved(n) == want


def _on_two_ranks(text):
    return collectives.ThreadRanks(2).run(
        lambda r: mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(text), "cpu"))


def test_build_mesh_over_the_world():
    for text in ("", "data=2", "data=-1"):
        for m in _on_two_ranks(text):
            assert m.shape == {"data": 2} and m.size == 2 and m.group.size == 2
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        _on_two_ranks("data=4")
    for text in ("model=2", "data=1,model=-1", "slice=2"):
        with pytest.raises(NotImplementedError, match="A8"):
            _on_two_ranks(text)
    # The mesh owns its group: a data axis of 1 has none, and sums nothing.
    one = mesh_lib.Mesh(device=torch.device("cpu"), shape={"data": 1})
    assert one.group is None and mesh_lib.build_mesh(None, "cpu").group is None


@pytest.mark.parametrize("count,n,batch", [(2, 50, 8), (3, 40, 6), (2, 33, 4)])
def test_pipeline_shards_match_jax(count, n, batch):
    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(n, 3)).astype(np.float32), "y": np.arange(n)}
    for idx in range(count):
        ours = iter(pipeline.InMemoryPipeline(arrays, batch_size=batch, seed=5,
                                              process_index=idx, process_count=count))
        theirs = iter(jax_pipeline.InMemoryPipeline(arrays, batch_size=batch, seed=5,
                                                    process_index=idx, process_count=count))
        for _ in range(3 * n // batch):  # across epoch boundaries
            a, b = next(ours), next(theirs)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="not divisible by 3 ranks"):
        pipeline.InMemoryPipeline(arrays, batch_size=8, process_index=0, process_count=3)


def test_rank_rows_and_the_lstm_dropout_draw():
    assert sharding.rank_rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.rank_rows(7, 0, 2)
    ids = np.arange(103)
    blocks = collectives.ThreadRanks(2).run(lambda r: sharding.stream_block(ids, 8))
    np.testing.assert_array_equal(blocks[0][0], ids[:51])
    np.testing.assert_array_equal(blocks[1][0], ids[51:102])
    assert blocks[0][1] == blocks[1][1] == 4
    # Dropout: each rank's mask is its rows of the global batch's draw, so
    # the ranks' outputs, row-independent, concatenate to the full batch's.
    cfg = lstm.Config(vocab_size=11, dim=4, num_layers=1, keep_prob=0.5,
                      compute_dtype="float32")
    params, carry = lstm.init_numpy(cfg, 0, batch_size=6)
    params = {k: {n: torch.from_numpy(v) for n, v in p.items()} for k, p in params.items()}
    carry = {k: {n: torch.from_numpy(v) for n, v in c.items()} for k, c in carry.items()}
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 11, (6, 3)))
    key = threefry.key(3)
    want, _ = lstm.apply(cfg, params, carry, x, rng=key)
    no_drop, _ = lstm.apply(cfg, params, carry, x)
    assert not torch.equal(want, no_drop)

    def rank_logits(_rank):
        rows = sharding.rank_rows(6)
        local = {k: {n: v[rows] for n, v in c.items()} for k, c in carry.items()}
        return lstm.apply(cfg, params, local, x[rows], rng=key)[0]

    got = collectives.ThreadRanks(2).run(rank_logits)
    torch.testing.assert_close(torch.cat(got), want, rtol=0, atol=0)


class _FakeStore:
    def __init__(self):
        self.kv, self.lock = {}, threading.Lock()

    def set(self, key, value):
        with self.lock:
            self.kv[key] = value

    def get(self, key):
        with self.lock:
            return self.kv.get(key)


def test_watchdog_declares_a_silent_peer_dead_and_spares_a_clean_one():
    store = _FakeStore()
    dead = []
    fired = threading.Event()
    try:
        assert dist.start_watchdog(interval_s=0.05, grace_s=0.15, on_failure=lambda d: (
            dead.extend(d), fired.set()), _client=store, _idx=0, _count=3)
        store.set("dtx/hb/1", "done")  # left cleanly: never dead
        store.set("dtx/hb/2", "7")  # beat once, then silent
        assert fired.wait(5.0)
        assert dead == [2]
    finally:
        dist.stop_watchdog(_client=store, _idx=0)
    assert store.get("dtx/hb/0") == "done"
    assert not dist.start_watchdog(_client=store, _idx=0, _count=1)  # one rank: none


def _bn_inputs(seed=0, shape=(16, 4, 4, 24)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    w = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    params = {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
              "bias": np.linspace(-1.0, 1.0, c, dtype=np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    return x, w, params, stats


def _jax_global_bn(mesh8, x, w, params, stats, *, fused, relu):
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh8, PartitionSpec("data")))

    def f(p, xx):
        y, ns = jax_layers.batchnorm(p, stats, xx, train=True, mesh=mesh8 if fused else None,
                                     relu=relu)
        return jnp.sum(y * w), (y, ns)

    old = jax_bn.FORCE_PALLAS
    jax_bn.FORCE_PALLAS = fused
    try:
        (_, (y, ns)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()}, xs)
    finally:
        jax_bn.FORCE_PALLAS = old
    return np.asarray(y), jax.device_get(ns), jax.device_get(gp), np.asarray(gx)


def _port_rank_bn(rank, x, w, params, stats, *, fused, relu):
    rows = sharding.rank_rows(x.shape[0])
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(""), "cpu") if fused else None
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    s = {k: torch.from_numpy(v.copy()) for k, v in stats.items()}
    xx = torch.from_numpy(x[rows].copy()).requires_grad_(True)
    y, ns = layers.batchnorm(p, s, xx, train=True, mesh=mesh, relu=relu)
    (y * torch.from_numpy(w[rows])).sum().backward()
    return (y.detach().numpy(), {k: v.numpy() for k, v in ns.items()},
            {k: v.grad.numpy() for k, v in p.items()}, xx.grad.numpy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("fused,relu", [(True, True), (True, False), (False, True)])
def test_syncbn_on_two_simulated_ranks_matches_jax_on_the_mesh(mesh8, fused, relu):
    x, w, params, stats = _bn_inputs(seed=1 if relu else 2)
    jy, jns, jgp, jgx = _jax_global_bn(mesh8, x, w, params, stats, fused=fused, relu=relu)
    ranks = collectives.ThreadRanks(2).run(
        lambda r: _port_rank_bn(r, x, w, params, stats, fused=fused, relu=relu))
    assert _rel(np.concatenate([r[0] for r in ranks]), jy) <= 1e-5
    for k in ("mean", "var"):
        # Every rank's running stats are the global batch's, bit for bit alike.
        np.testing.assert_array_equal(ranks[0][1][k], ranks[1][1][k])
        np.testing.assert_allclose(ranks[0][1][k], jns[k], rtol=1e-5, atol=1e-5)
    assert _rel(np.concatenate([r[3] for r in ranks]), jgx) <= 1e-4
    for k in ("scale", "bias"):
        assert _rel(ranks[0][2][k] + ranks[1][2][k], jgp[k]) <= 1e-4, k


def test_the_step_sums_over_its_mesh_group_only():
    """A step over a one-rank mesh inside a two-rank group (rank 0 alone
    runs it) sums nothing over the group, plain BN included: it is the
    same step as in a process without a group, bit for bit."""
    from distributed_tensorflow_examples_tpu_torch.train import optim, state, step

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))

    def loss_fn(params, mstate, batch, _rng):
        y, ns = layers.batchnorm(params["bn"], mstate["bn"], batch["x"], train=True)
        loss = (y * w).sum()
        return loss, ({"bn": ns}, {"loss": loss})

    def run(mesh):
        p, s = layers.batchnorm_init(6)
        st = state.create_state(lambda _seed: ({"bn": p}, {"bn": s}), optim.SGD(0.1), 0, "cpu")
        st, _m = step.build_train_step(loss_fn, optim.SGD(0.1), mesh=mesh)(st, {"x": x})
        return [t.detach().clone() for t in state.leaves(st.params) + state.leaves(st.model_state)]

    want = run(None)
    one = mesh_lib.Mesh(device=torch.device("cpu"), shape={"data": 1})
    got = collectives.ThreadRanks(2, timeout=10).run(lambda r: run(one) if r == 0 else None)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_ps_task_exits_0_and_the_supervisor_restarts_a_failing_task(
        monkeypatch, tmp_path, capsys):
    import sys

    from distributed_tensorflow_examples_tpu_torch.examples import mnist_mlp
    from distributed_tensorflow_examples_tpu_torch.utils import supervisor

    # A TF_CONFIG ps task holds no seat: the Experiment prints and exits 0
    # before joining any group, as the JAX runner does.
    monkeypatch.setenv("TF_CONFIG", _tf_config(CHIEF, "ps", 0))
    with pytest.raises(SystemExit) as e:
        mnist_mlp.main(["--device=cpu", "--hidden_units=8", "--train_steps=1"])
    assert e.value.code == 0 and not dist.is_initialized()
    assert "needs no parameter servers; exiting 0" in capsys.readouterr().out
    # A child that fails once (as a rank does on EXIT_PEER_LOST) is restarted.
    marker = tmp_path / "failed_once"
    child = [sys.executable, "-c",
             f"import os, sys; m = {str(marker)!r}\n"
             "if not os.path.exists(m):\n    open(m, 'w').close(); sys.exit(83)\n"]
    assert supervisor.supervise(child, max_restarts=1, backoff_s=0.0) == 0
    assert marker.exists()
    marker.unlink()
    assert supervisor.supervise(child, max_restarts=0, backoff_s=0.0) == 83
    assert supervisor.main(["--bogus=1", "--", "true"]) == 2
