"""The port's MNIST MLP (W1) and CIFAR-10 CNN (W2) against the JAX package's.

At narrow widths on the CPU (MLP hidden 32/16; CNN channels 8/8, dense
32/16; both at their datasets' image shapes): the port's ``init_numpy``
against the JAX ``init`` from one seed, the forward, loss and per-leaf
gradients on one numpy batch from the same weights, then per-step losses
through both packages' ``build_train_step`` with SGD from the same seed on
the same batches: 20 steps in float32, 5 in bfloat16 (the default).
Also the datasets bit for bit (synthetic and the file branches, on small
files the test writes), each CLI's FINAL line, the CLI's first steps
against the JAX ``Experiment`` wired as the JAX CLI wires it, and a run
cut at step 2 and resumed from its ``--log_dir``.

Tolerances.  Initial weights: glorot leaves bit for bit, He-normal leaves
within ``NORMAL_ULPS`` float32 ulps (seen 3: XLA's erf_inv rounding).
float32: logits 1e-5 absolute (seen 4e-7), loss 1e-6 (seen 2.4e-7),
gradients 1e-5 relative per leaf (seen 4e-7); 20 steps, loss 5e-6 (seen
4.8e-7) and parameters 1e-6 (seen 9e-8).  bfloat16: step 1's loss 1e-5
(seen 2.4e-7: the same bf16 forward), later steps 1e-2 (seen 3.7e-3 at
step 5: the two frameworks round bf16 gradients apart, one bf16 step is
2^-8) and parameters 1e-2 (seen 2.1e-3).  The CLI against the JAX
``Experiment``, bf16 at the CLI's widths: step 1's loss 1e-4 (seen 2.2e-5
for the CNN's 64-channel convs, whose bf16 outputs the two frameworks
round apart where their sums run in another order), 1e-2 over 4 steps
(seen 8e-4) at the CLI's default learning rate.
"""

import functools
import itertools
import pickle
import re
import types

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data import datasets as jax_datasets
from distributed_tensorflow_examples_tpu.data import pipeline as jax_pipeline
from distributed_tensorflow_examples_tpu.models import cnn as jax_cnn
from distributed_tensorflow_examples_tpu.models import mlp as jax_mlp
from distributed_tensorflow_examples_tpu.parallel import mesh as jax_mesh
from distributed_tensorflow_examples_tpu.train import hooks as jax_hooks
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import datasets, pipeline, streams
from distributed_tensorflow_examples_tpu_torch.examples import cifar10_cnn, mnist_mlp
from distributed_tensorflow_examples_tpu_torch.models import cnn, mlp
from distributed_tensorflow_examples_tpu_torch.train import hooks, optim, state, step

torch.set_num_threads(1)

NORMAL_ULPS = 4
TOL = {
    "float32": dict(steps=20, first=5e-6, loss=5e-6, param=1e-6),
    "bfloat16": dict(steps=5, first=1e-5, loss=1e-2, param=1e-2),
}
#: Each model: JAX module, port module, narrow widths, learning rate,
#: dataset, the normal-drawn leaves.
MODELS = {
    "mlp": (jax_mlp, mlp, dict(hidden=(32, 16)), 0.1, "mnist", lambda p: False),
    "cnn": (jax_cnn, cnn, dict(channels=(8, 8), dense=(32, 16)), 0.05, "cifar10",
            lambda p: p.endswith("kernel")),
}
SEED = 3


@functools.lru_cache(maxsize=None)
def _dataset(name):
    return getattr(datasets, name)(None, seed=0)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _batches(name, n, batch_size=32):
    it = iter(pipeline.InMemoryPipeline(_dataset(name).train, batch_size=batch_size, seed=0))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 7])
def test_init_numpy_is_the_jax_init(name, seed):
    jmod, tmod, kw, _lr, _data, normal = MODELS[name]
    want = jax.device_get(jax.jit(functools.partial(jmod.init, jmod.Config(**kw)))(
        jax.random.key(seed)))
    got = tmod.init_numpy(tmod.Config(**kw), seed, device="cpu")
    ours, theirs = list(bridge._leaves(got)), list(bridge._leaves(want))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.dtype == np.float32 and a.shape == np.shape(b), path
        if normal(path):
            assert _ulps(a, b) <= NORMAL_ULPS, path
        else:
            np.testing.assert_array_equal(a.view(np.int32), np.asarray(b).view(np.int32),
                                          err_msg=path)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_gradients_match_jax(name):
    jmod, tmod, kw, _lr, data, _normal = MODELS[name]
    jcfg = jmod.Config(compute_dtype="float32", **kw)
    tcfg = tmod.Config(compute_dtype="float32", **kw)
    jparams = jax.device_get(jax.jit(functools.partial(jmod.init, jcfg))(jax.random.key(SEED)))
    batch = _batches(data, 1, batch_size=8)[0]
    (jloss, (_, jm)), jgrads = jax.jit(jax.value_and_grad(jmod.loss_fn(jcfg), has_aux=True))(
        jparams, {}, batch, jax.random.key(0))
    jlogits = np.asarray(jmod.apply(jcfg, jparams, batch["image"]))  # eager: no second compile
    params = state.as_param_leaves(jax.tree.map(np.asarray, jparams), "cpu")
    tb = _torch_batch(batch)
    np.testing.assert_allclose(tmod.apply(tcfg, params, tb["image"]).detach().numpy(), jlogits,
                               rtol=0, atol=1e-5)
    loss, (_, m) = tmod.loss_fn(tcfg)(params, {}, tb, None)
    loss.backward()
    assert float(m["loss"]) == pytest.approx(float(jloss), abs=1e-6)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    for (path, p), (_, want) in zip(bridge._leaves(params), bridge._leaves(jgrads)):
        want = np.asarray(want)
        rel = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-5, f"{path}: grad rel err {rel:.3e}"


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_steps_match_jax(name, dtype):
    """Per-step losses from the same seed on the same batches, each package
    from its own init and ``build_train_step``."""
    jmod, tmod, kw, lr, data, _normal = MODELS[name]
    tol = TOL[dtype]
    jcfg = jmod.Config(compute_dtype=dtype, **kw)
    tcfg = tmod.Config(compute_dtype=dtype, **kw)
    js = jax_state.create_state(jax.jit(functools.partial(jmod.init, jcfg)), optax.sgd(lr),
                                jax.random.key(SEED))
    jstep = jax_step.build_train_step(jmod.loss_fn(jcfg), optax.sgd(lr))
    ts = state.create_state(lambda s: tmod.init_numpy(tcfg, s, device="cpu"), optim.SGD(lr),
                            SEED, "cpu")
    tstep = step.build_train_step(tmod.loss_fn(tcfg), optim.SGD(lr))
    jl, tl = [], []
    for b in _batches(data, tol["steps"]):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _torch_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert tl[0] == pytest.approx(jl[0], abs=tol["first"])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol["loss"])
    for (path, p), (_, want) in zip(bridge._leaves(ts.params),
                                    bridge._leaves(jax.device_get(js.params))):
        diff = np.abs(p.detach().numpy() - np.asarray(want)).max()
        assert diff <= tol["param"], f"{path}: max |dparam| {diff:.3e}"


def _write_image_files(tmp_path, rng):
    """Small mnist.npz, cifar10.npz and cifar-10-batches-py files."""
    mn = tmp_path / "mnist"
    mn.mkdir()
    np.savez(mn / "mnist.npz",
             x_train=rng.integers(0, 256, (20, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 20, dtype=np.uint8),
             x_test=rng.integers(0, 256, (6, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 6, dtype=np.uint8))
    cz = tmp_path / "cifar_npz"
    cz.mkdir()
    np.savez(cz / "cifar10.npz",
             x_train=rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (12, 1), dtype=np.uint8),
             x_test=rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             y_test=rng.integers(0, 10, (4, 1), dtype=np.uint8))
    cb = tmp_path / "cifar_py" / "cifar-10-batches-py"
    cb.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                b"labels": rng.integers(0, 10, 3).tolist()}
        with open(cb / name, "wb") as f:
            pickle.dump(blob, f)
    return mn, cz, cb.parent


def _same_dataset(a, b):
    assert a.source == b.source and a.num_classes == b.num_classes
    for split in ("train", "test"):
        assert a.__dict__[split].keys() == b.__dict__[split].keys()
        for k in a.__dict__[split]:
            x, y = a.__dict__[split][k], b.__dict__[split][k]
            assert x.dtype == y.dtype and x.shape == y.shape, (split, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{split}/{k}")


def test_datasets_are_bit_identical(tmp_path):
    _same_dataset(datasets.mnist(None, seed=5), jax_datasets.mnist(None, seed=5))
    _same_dataset(_dataset("cifar10"), jax_datasets.cifar10(None, seed=0))
    mn, cz, cb = _write_image_files(tmp_path, np.random.default_rng(0))
    _same_dataset(datasets.mnist(str(mn)), jax_datasets.mnist(str(mn)))
    for d in (cz, cb):
        ours, theirs = datasets.cifar10(str(d)), jax_datasets.cifar10(str(d))
        assert ours.source.startswith("file:")
        _same_dataset(ours, theirs)
    # The in-memory pipeline over the CIFAR source: the JAX CLI's batches.
    src = streams.resolve_image_source(None, fallback=lambda: _dataset("cifar10"))
    ours = streams.train_iter(src, batch_size=32, seed=4)
    theirs = iter(jax_pipeline.InMemoryPipeline(_dataset("cifar10").train, batch_size=32, seed=4,
                                                process_index=0, process_count=1))
    for a, b in itertools.islice(zip(ours, theirs), 3):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


#: Each CLI with a tiny CPU run's flags, and its FINAL metric.
CLIS = {
    "mnist_mlp": (mnist_mlp, ["--hidden_units=32,16", "--batch_size=32"], "test_accuracy"),
    "cifar10_cnn": (cifar10_cnn, ["--batch_size=16"], "test_accuracy"),
}


class _Losses(hooks.Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))


@pytest.fixture(autouse=True)
def _cached_datasets(monkeypatch):
    """The CLIs' synthetic datasets drawn once per seed (a CIFAR-10 draw
    takes a second)."""
    for name in ("mnist", "cifar10"):
        real = functools.lru_cache(maxsize=None)(getattr(datasets, name))
        monkeypatch.setattr(datasets, name, lambda d=None, *, seed=0, _f=real: _f(d, seed=seed))


def _args(name, *extra):
    cli, argv, _metric = CLIS[name]
    return cli.build_parser().parse_args(
        ["--device=cpu", "--log_every_steps=1", *argv, *extra])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_prints_final_and_ps_task_exits(name, capsys):
    cli, argv, metric = CLIS[name]
    assert cli.main(["--device=cpu", "--train_steps=2", *argv]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"^FINAL step=2 steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
                     rf"{metric}=[0-9.]+$", out, re.M), out
    assert cli.main(["--job_name=ps", "--ps_hosts=h:1"]) == 0
    assert "parameter servers are not needed" in capsys.readouterr().out
    # --sync_replicas=false runs the async PS emulation, as the JAX CLI does.
    assert cli.main(["--device=cpu", "--sync_replicas=false", "--train_steps=2", *argv]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"^FINAL step=2 steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
                     rf"mode=async stale_dropped=\d+ first_loss=\S+ last_loss=\S+ "
                     rf"{metric}=[0-9.]+$", out, re.M), out
    with pytest.raises(NotImplementedError, match="A8"):
        cli.main(["--device=cpu", "--zero_opt", *argv])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_steps_match_the_jax_experiment(name):
    """The CLI (bf16, its default) against the JAX ``Experiment`` wired as
    the JAX CLI wires it: init from ``key(--seed)``, ``optax.sgd``, the
    same dataset and pipeline seed."""
    steps = 4
    args = _args(name, f"--train_steps={steps}", "--seed=2")
    clock = _Losses()
    cli = CLIS[name][0]
    exp = cli.run_training(args, extra_hooks=[clock])
    jcfg = (jax_mlp.Config(hidden=tuple(args.hidden_units)) if name == "mnist_mlp"
            else jax_cnn.Config())
    jmod = jax_mlp if name == "mnist_mlp" else jax_cnn
    ds = (jax_datasets.mnist if name == "mnist_mlp" else jax_datasets.cifar10)(None, seed=2)

    class JaxLosses(jax_hooks.Hook):
        def __init__(self):
            self.losses = []

        def after_step(self, loop, metrics):
            self.losses.append(float(metrics["loss"]))

    jclock = JaxLosses()
    jflags = types.SimpleNamespace(**{**vars(args), "watchdog": False, "log_dir": None})
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec.parse("data=1"), devices=jax.devices()[:1])
    jexp = jax_train.Experiment(
        init_fn=lambda r: jmod.init(jcfg, r), loss_fn=jmod.loss_fn(jcfg),
        optimizer=optax.sgd(args.learning_rate), flags=jflags, mesh=mesh,
        extra_hooks=[jclock],
    )
    jexp.run(iter(jax_pipeline.InMemoryPipeline(ds.train, batch_size=args.batch_size,
                                                seed=args.seed, process_index=0,
                                                process_count=1)))
    jexp.writer.close()
    assert len(clock.losses) == len(jclock.losses) == steps
    assert clock.losses[0] == pytest.approx(jclock.losses[0], abs=1e-4)
    np.testing.assert_allclose(clock.losses, jclock.losses, rtol=0, atol=1e-2)
    assert exp.session.step == steps


def _restarting(factory, k):
    """The stream of ``factory``'s first ``k`` items, then its whole stream
    again: what a run cut at step k and resumed reads (each run starts its
    data from the beginning, in both packages)."""

    def make(*a, **kw):
        return itertools.chain(itertools.islice(iter(factory(*a, **kw)), k),
                               iter(factory(*a, **kw)))

    return make


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_resumes_from_its_checkpoint(name, tmp_path, monkeypatch):
    """A run cut at step 2 and rerun to step 4 from its --log_dir takes the
    uninterrupted run's steps 3 and 4 (that run reading the same batches:
    the first two again), bit for bit."""
    cli = CLIS[name][0]
    cut = _Losses()
    cli.run_training(_args(name, "--train_steps=2", f"--log_dir={tmp_path / 'cut'}"),
                     extra_hooks=[cut])
    resumed = _Losses()
    rexp = cli.run_training(_args(name, "--train_steps=4", f"--log_dir={tmp_path / 'cut'}"),
                            extra_hooks=[resumed])
    assert rexp.session.records["resumed_at"] == 2
    if name == "mnist_mlp":
        monkeypatch.setattr(cli, "InMemoryPipeline", _restarting(pipeline.InMemoryPipeline, 2))
    else:
        monkeypatch.setattr(streams, "train_iter", _restarting(streams.train_iter, 2))
    straight = _Losses()
    sexp = cli.run_training(_args(name, "--train_steps=4"), extra_hooks=[straight])
    assert cut.losses + resumed.losses == straight.losses
    for (path, a), b in zip(bridge._leaves(rexp.state.params), state.leaves(sexp.state.params)):
        assert torch.equal(a, b), path
