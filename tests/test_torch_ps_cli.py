"""The port's PS-emulation CLI path (``train/ps_experiment.py``, the MNIST and
CIFAR-10 CLIs' PS branches, the legacy cluster flags under PS emulation)
against the JAX package's.

The two ``run_ps_emulation`` are called with one ``SimpleNamespace`` of
flags (the JAX one reads them through ``getattr``), the same initial
parameters (the JAX init, carried across as numpy) and each package's
own data streams, which are equal bit for bit (tested here too).  W2's
deterministic path (the fixed interleave, CIFAR-10 CNN at channels 8/8,
dense 32/16, float32, the CLI's warmup schedule): ``first_loss`` and
``last_loss`` within 1e-5 relative, ``test_accuracy`` within one test
example's share.  W1 (``--ps_emulation``) through the port's CLI: its
FINAL line has the JAX line's fields, in its order.
"""

import functools
import inspect
import os
import re
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
from distributed_tensorflow_examples_tpu.models import mlp as jax_mlp
from distributed_tensorflow_examples_tpu.parallel import async_ps as jax_async_ps
from distributed_tensorflow_examples_tpu.utils import flags as jax_flags
from distributed_tensorflow_examples_tpu_torch.data import data_service as dsvc
from distributed_tensorflow_examples_tpu_torch.data import datasets, streams
from distributed_tensorflow_examples_tpu_torch.examples import mnist_mlp
from distributed_tensorflow_examples_tpu_torch.models import cnn
from distributed_tensorflow_examples_tpu_torch.train import optim, ps_experiment
from distributed_tensorflow_examples_tpu_torch.utils import determinism, flags
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
#: The FINAL line of the PS paths (both packages): fields and order.
FINAL_PS = (r"^FINAL step={step} steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
            r"mode={mode} stale_dropped=\d+ first_loss=[0-9.]+ last_loss=[0-9.]+ "
            r"test_accuracy=[0-9.]+$")


@pytest.fixture(autouse=True)
def _no_tensorboard_events(monkeypatch):
    """No test here reads an event file: the runs write metrics.jsonl only
    (a TensorBoard writer's first import pulls in TensorFlow, seconds a
    process)."""
    monkeypatch.setattr(MetricsWriter, "__init__",
                        functools.partialmethod(MetricsWriter.__init__, tensorboard=False))


@pytest.fixture(autouse=True)
def _restore_determinism():
    """``--deterministic`` turns on process-wide settings; put them back."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    torch.use_deterministic_algorithms(saved[0])
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved[1:]


def _flags(**kw):
    base = dict(worker_hosts="a:1,b:1", job_name="", ps_hosts="", ps_emulation=False,
                sync_replicas=False, replicas_to_aggregate=0, max_staleness=0,
                deterministic=False, train_steps=8, log_dir=None, checkpoint_every_steps=1000,
                batch_size=32, seed=0, grad_accum=1, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


class _Kept(jax_async_ps.AsyncPSTrainer):
    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Kept.made.append(self)


def _final(out: str) -> str:
    lines = [l for l in out.splitlines() if l.startswith("FINAL ")]
    assert len(lines) == 1, out
    return lines[0]


def _field(line: str, key: str) -> float:
    return float(re.search(rf"\b{key}=([0-9.]+)", line).group(1))


def test_w2_deterministic_run_ps_emulation_matches_jax(monkeypatch, capsys):
    fl = _flags(deterministic=True, train_steps=8)
    jcfg = jax_cnn.Config(channels=(8, 8), dense=(32, 16), compute_dtype="float32")
    pcfg = cnn.Config(channels=(8, 8), dense=(32, 16), compute_dtype="float32")
    lr, warmup = 0.05, 20
    jds = jax_datasets.cifar10(None, seed=0)
    jsrc = jax_streams.resolve_image_source(None, fallback=lambda: jds, seed=0, num_classes=10)
    src = streams.resolve_image_source(None, fallback=lambda: datasets.cifar10(None, seed=0))

    def init_np(seed):
        return jax.tree.map(np.asarray, jax_cnn.init(jcfg, jax.random.key(seed)))

    trainer = ps_experiment.run_ps_emulation(
        init_fn=init_np, loss_fn=cnn.loss_fn(pcfg),
        optimizer=optim.SGD(optim.linear_schedule(lr / 10.0, lr, warmup)),
        batches_for_worker=lambda w, bs, nw: streams.train_iter(
            src, batch_size=bs, seed=0, worker=w, n_workers=nw),
        FLAGS=fl, mode="async",
        eval_fn=ps_experiment.array_eval_fn(
            lambda p, b: cnn.apply(pcfg, p, b["image"]), src.ds.test, fl.batch_size,
            device="cpu"),
    )
    port_line = _final(capsys.readouterr().out)
    monkeypatch.setattr(jax_async_ps, "AsyncPSTrainer", _Kept)
    _Kept.made.clear()
    jax_train.run_ps_emulation(
        init_fn=lambda rng: jax_cnn.init(jcfg, rng), loss_fn=jax_cnn.loss_fn(jcfg),
        optimizer=optax.sgd(optax.linear_schedule(lr / 10.0, lr, warmup)),
        batches_for_worker=lambda w, bs, nw: jax_streams.train_iter(
            jsrc, batch_size=bs, seed=0, worker=w, n_workers=nw),
        FLAGS=fl, mode="async",
        eval_fn=jax_train.array_eval_fn(
            lambda p, b: jax_cnn.apply(jcfg, p, b["image"]), jds.test, fl.batch_size),
    )
    jax_line = _final(capsys.readouterr().out)
    (jt,) = _Kept.made
    for line in (port_line, jax_line):
        assert re.match(FINAL_PS.format(step=8, mode="async"), line), line
    assert trainer.apply_log == jt.apply_log
    assert [h[:2] for h in trainer.history] == [h[:2] for h in jt.history]
    losses = [h[2] for h in trainer.history]
    jlosses = [h[2] for h in jt.history]
    np.testing.assert_allclose([losses[0], losses[-1]], [jlosses[0], jlosses[-1]],
                               rtol=LOSS_RTOL)
    n_test = (len(jds.test["label"]) // fl.batch_size) * fl.batch_size
    assert abs(trainer.metrics["test_accuracy"] - _field(jax_line, "test_accuracy")) \
        <= 1.0 / n_test + 1e-4  # + the JAX line's 4-decimal rounding
    assert torch.are_deterministic_algorithms_enabled()  # --deterministic took effect


def test_w1_cli_final_line_has_the_jax_form(capsys):
    argv = ["--device=cpu", "--ps_emulation", "--worker_hosts=a:1,b:1", "--train_steps=6",
            "--hidden_units=32,16", "--batch_size=32"]
    assert mnist_mlp.main(argv) == 0
    port_line = _final(capsys.readouterr().out)
    jcfg = jax_mlp.Config(hidden=(32, 16))
    ds = jax_datasets.mnist(None, seed=0)
    from distributed_tensorflow_examples_tpu.data import pipeline as jax_pipeline

    jax_train.run_ps_emulation(
        init_fn=lambda rng: jax_mlp.init(jcfg, rng), loss_fn=jax_mlp.loss_fn(jcfg),
        optimizer=optax.sgd(0.01),
        batches_for_worker=lambda w, bs, nw: iter(jax_pipeline.InMemoryPipeline(
            ds.train, batch_size=bs, seed=w, process_index=0, process_count=1)),
        FLAGS=_flags(ps_emulation=True, sync_replicas=True, train_steps=6),
        mode="sync_replicas",
        eval_fn=jax_train.array_eval_fn(
            lambda p, b: jax_mlp.apply(jcfg, p, b["image"]), ds.test, 32),
    )
    jax_line = _final(capsys.readouterr().out)
    for line in (port_line, jax_line):
        assert re.match(FINAL_PS.format(step=6, mode="sync_replicas"), line), line
    keys = [re.findall(r"(\w+)=", line) for line in (port_line, jax_line)]
    assert keys[0] == keys[1]


def test_cli_ps_checkpoint_resumes(tmp_path, capsys):
    """``--log_dir``: the run checkpoints under ``ps_ckpt/<step>/`` and a
    rerun with a higher ``--train_steps`` resumes there."""
    argv = ["--device=cpu", "--sync_replicas=false", "--hidden_units=16", "--batch_size=16",
            f"--log_dir={tmp_path}", "--checkpoint_every_steps=2"]
    assert mnist_mlp.main([*argv, "--train_steps=4"]) == 0
    assert sorted(p.name for p in (tmp_path / "ps_ckpt").iterdir()) == ["2", "4"]
    capsys.readouterr()
    trainer = mnist_mlp.run_training(mnist_mlp.build_parser().parse_args(
        [*argv, "--train_steps=6"]))
    assert trainer.global_step == 6 and len(trainer.apply_log) == 0
    assert min(s for _w, s, _l in trainer.history) >= 4  # nothing recomputed before 4
    assert re.match(FINAL_PS.format(step=6, mode="async"), _final(capsys.readouterr().out))


def test_train_iter_worker_streams_match_jax():
    jsrc = jax_streams.resolve_image_source(
        None, fallback=lambda: jax_datasets.cifar10(None, seed=3), seed=3, num_classes=10)
    src = streams.resolve_image_source(None, fallback=lambda: datasets.cifar10(None, seed=3))
    for w in range(2):
        ours = streams.train_iter(src, batch_size=16, seed=3, worker=w, n_workers=2)
        ref = jax_streams.train_iter(jsrc, batch_size=16, seed=3, worker=w, n_workers=2)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="worker 2"):
        streams.train_iter(src, batch_size=16, seed=3, worker=2, n_workers=2)


@pytest.mark.parametrize("argv", [
    ["--ps_hosts=h:1,h:2", "--ps_emulation"],
    ["--ps_hosts=h:1,h:2,h:3,h:4", "--sync_replicas=false", "--worker_hosts=w:1,w:2"],
    ["--ps_hosts=h:1", "--worker_hosts=w:1,w:2,w:3"],
])
def test_ps_topology_under_emulation_matches_the_reference(argv):
    """Under PS emulation ``--ps_hosts`` is the validated topology, as in
    JAX (the port's CLIs define no ``--ps_shards``: one shard a host)."""
    args = mnist_mlp.build_parser().parse_args(argv)
    ref = jax_flags.resolve_legacy_cluster(types.SimpleNamespace(**{
        k: getattr(args, k) for k in ("job_name", "ps_hosts", "worker_hosts", "task_index",
                                      "sync_replicas", "ps_emulation")}))
    assert flags.resolve_legacy_cluster(args) == ref


@pytest.mark.parametrize("spec", ["h", "h:1,h:1", "h:x", ":1", "h:1,"])
def test_bad_ps_hosts_raise_as_in_the_reference(spec):
    ns = types.SimpleNamespace(ps_hosts=spec)
    with pytest.raises(ValueError) as ours:
        flags.ps_shard_topology(ns)
    with pytest.raises(ValueError) as ref:
        jax_flags.ps_shard_topology(ns)
    assert str(ours.value) == str(ref.value)


def _bound_call(fn, calls: list):
    """A stand-in for ``fn`` that records each call's arguments, bound to
    ``fn``'s signature with its defaults filled in."""
    sig = inspect.signature(fn)

    def record(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return 0

    return record


def test_cross_process_task_waits_for_a9b(monkeypatch):
    """A cross-process task role dispatches to ``run_ps_cluster_task``, as
    the JAX ``run_ps_emulation`` does.  What earlier slices refused, more
    than one PS shard, replicas and a serve replica over the PS, now runs:
    at 2 shards x 2 replicas each PS task (and a ``--ps_reshard_to``
    joiner), a worker and the serve replica are wired exactly as the JAX
    ``run_ps_cluster_task`` wires them on the same flags (the arguments of
    ``host_ps_task``, ``remote_worker_loop`` and ``host_serve_task``, with
    their defaults, equal; the two signatures' names and defaults equal
    too).  The data service role, refused until the data planes came,
    dispatches to ``host_data_service_task`` with JAX's arguments."""
    from distributed_tensorflow_examples_tpu import serve as jax_serve
    from distributed_tensorflow_examples_tpu.utils import faults as jax_faults
    from distributed_tensorflow_examples_tpu_torch import serve
    from distributed_tensorflow_examples_tpu_torch.parallel import async_ps, ps_service
    from distributed_tensorflow_examples_tpu_torch.utils import faults
    from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import free_ports

    fl = _flags(job_name="worker", ps_hosts="h:1", sync_replicas=False)
    assert jax_flags.is_cross_process_ps(fl) and flags.is_cross_process_ps(fl)
    calls = []
    monkeypatch.setattr(ps_experiment, "run_ps_cluster_task",
                        lambda **kw: calls.append(kw) or "dispatched")
    assert ps_experiment.run_ps_emulation(init_fn=None, loss_fn=None, optimizer=None,
                                          batches_for_worker=None, FLAGS=fl,
                                          mode="async") == "dispatched"
    assert calls[0]["FLAGS"] is fl and calls[0]["mode"] == "async"
    monkeypatch.undo()
    fl = _flags(job_name="data_service", data_service_hosts="127.0.0.1:1")
    assert jax_flags.is_cross_process_ps(fl) and flags.is_cross_process_ps(fl)

    for fn, ref in ((async_ps.host_ps_task, jax_async_ps.host_ps_task),
                    (serve.host_serve_task, jax_serve.host_serve_task)):
        ours, theirs = inspect.signature(fn).parameters, inspect.signature(ref).parameters
        # ``ps_addrs`` defaults to none in the port: its pinned transformer
        # replica omits it.
        common = (set(ours) & set(theirs)) - {"ps_addrs"}
        assert {n: ours[n].default for n in common} == {n: theirs[n].default for n in common}
    # Roles are set only where none is (the tasks run in this process here).
    monkeypatch.setattr(faults, "current_role", lambda: "test")
    monkeypatch.setattr(jax_faults, "current_role", lambda: "test")
    dsvc_calls = {"port": [], "jax": []}
    for mod, key in ((dsvc, "port"), (jax_dsvc, "jax")):
        monkeypatch.setattr(mod, "host_data_service_task",
                            _bound_call(mod.host_data_service_task, dsvc_calls[key]))
    for extra in ({}, dict(ps_hosts="127.0.0.1:7301,127.0.0.1:7302", ps_shards=1, ps_replicas=2,
                           ps_layout_version=3, tenant_quotas="a=2", task_index=1,
                           data_service_hosts="127.0.0.1:7310,127.0.0.1:7311")):
        fl = _flags(**{**dict(job_name="data_service", data_service_hosts="127.0.0.1:7310",
                              data_dir="/shards", ps_restarts=0, batch_size=48, seed=5,
                              task_index=0), **extra})
        for run in (ps_experiment.run_ps_emulation, jax_train.run_ps_emulation):
            assert run(init_fn=None, loss_fn=None, optimizer=None, batches_for_worker=None,
                       FLAGS=fl, mode="async") is None
    assert len(dsvc_calls["port"]) == len(dsvc_calls["jax"]) == 2
    for ours, theirs in zip(dsvc_calls["port"], dsvc_calls["jax"]):
        assert ours.keys() == theirs.keys()
        assert {k: v for k, v in ours.items() if k != "tenant_quotas"} == \
            {k: v for k, v in theirs.items() if k != "tenant_quotas"}
        assert (ours["tenant_quotas"] is None) == (theirs["tenant_quotas"] is None)
    first, second = dsvc_calls["port"]
    assert (first["port"], first["batch_size"], first["ps_addrs"]) == (7310, 24, None)
    assert second["port"] == 7311 and second["ps_layout_version"] == 3
    assert second["ps_addrs"] == [("127.0.0.1", 7301), ("127.0.0.1", 7302)]
    assert second["tenant_quotas"]["a"].weight == 2.0
    got = {"port": [], "jax": []}
    for mod, key in ((async_ps, "port"), (jax_async_ps, "jax")):
        for name in ("host_ps_task", "remote_worker_loop"):
            monkeypatch.setattr(mod, name, _bound_call(getattr(mod, name), got[key]))
    monkeypatch.setattr(serve, "host_serve_task",
                        _bound_call(serve.host_serve_task, got["port"]))
    monkeypatch.setattr(jax_serve, "host_serve_task",
                        _bound_call(jax_serve.host_serve_task, got["jax"]))
    ports = [ps_service.start_server(0) for _ in range(4)]  # the roles probe them
    try:
        hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
        new_hosts = ",".join(f"127.0.0.1:{p}" for p in free_ports(3))
        base = dict(ps_hosts=hosts, ps_shards=2, ps_replicas=2, ps_layout_version=1,
                    ps_tasks=-1, ps_restarts=0, serve_hosts="127.0.0.1:7211")
        roles = [dict(job_name="ps", task_index=i) for i in range(4)] + [
            dict(job_name="ps", task_index=1, ps_reshard_to=f"2:{new_hosts}"),
            dict(job_name="worker", task_index=1),
            dict(job_name="serve", task_index=0, serve_refresh_ms=20.0, tenant_quotas="a=2"),
        ]
        for role in roles:
            fl = _flags(**base, **role)
            assert jax_flags.is_cross_process_ps(fl) and flags.is_cross_process_ps(fl)
            ps_experiment.run_ps_emulation(
                init_fn=lambda seed: {"w": np.zeros(3, np.float32)}, loss_fn=None,
                optimizer=None, batches_for_worker=lambda w, bs, nw: iter(()), FLAGS=fl,
                mode="async", predict_fn=lambda p, b: None)
            jax_train.run_ps_emulation(
                init_fn=lambda rng: {"w": jax.numpy.zeros(3)}, loss_fn=None,
                optimizer=None, batches_for_worker=lambda w, bs, nw: iter(()), FLAGS=fl,
                mode="async", predict_fn=lambda p, b: None)
    finally:
        for p in ports:
            ps_service.stop_server(p)
    assert len(got["port"]) == len(got["jax"]) == len(roles)
    # Values that are each package's own objects (functions, configs,
    # iterators, the tree template) are compared where they carry wiring.
    own = {"init_fn", "param_shapes", "predict_fn", "loss_fn", "batches", "model_state",
           "rng", "seed", "device", "cfg", "decode_fns", "tenant_quotas"}
    for ours, theirs in zip(got["port"], got["jax"]):
        common = (set(ours) & set(theirs)) - own
        assert {k: ours[k] for k in common} == {k: theirs[k] for k in common}
    (w,) = [c for c in got["port"] if "wid" in c]
    assert w["ps_replicas"] == 2 and w["layout_version"] == 1 and len(w["addrs"]) == 4
    (sv,) = [c for c in got["port"] if "param_shapes" in c]
    assert sv["ps_replicas"] == 2 and sv["refresh_ms"] == 20.0
    assert sv["tenant_quotas"]["a"].weight == 2.0
    assert [c["peer"][1] for c in got["port"][:4]] == [ports[2], ports[3], ports[0], ports[1]]
    assert got["port"][4]["reshard_from"]["new_addrs"][0][1] == int(
        new_hosts.split(",")[0].rsplit(":", 1)[1])


def test_determinism_enable_pins_the_gpu_choices(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")  # restored after the test
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    determinism.enable()

    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
