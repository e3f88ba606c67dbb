"""The port's ResNet slice against the JAX package's, at tiny size on the CPU.

A tiny ResNet (``stage_sizes=(1, 1)``, ``width=8``, 10 classes, 32 x 32
images): JAX ``init`` draws the weights and BN state, both cross to the
port as numpy trees, and both packages run the same numpy batch —
forward in train and eval mode, then two steps of
``optax.sgd(piecewise_constant_schedule(0.1, {1: 0.1}), momentum=0.9)``
(the port's ``train.optim.SGD``) from their own ``build_train_step``.  The
fused path runs with a one-device mesh on both sides (the JAX Pallas
kernels in interpret mode under ``FORCE_PALLAS``, the port's plain
versions); the plain path without.  Also: the piecewise schedule and SGD
against optax, the synthetic ImageNet data and the in-memory pipeline bit
for bit, the flat-vector bridge of a ResNet tree, the conv padding rules
against ``lax.conv_general_dilated``, checkpoint resume of BN stats and
momentum buffers, and the example CLI.

The first update of each leaf is -lr times its gradient, so it stands for
the gradient.  Tolerances.  float32: loss and metrics 1e-5, logits and BN
state 1e-4 (seen 1e-6), the first update 1e-4 relative per leaf (seen
1e-5), parameters after two steps 1e-5 absolute.  bfloat16 on the fused
path: loss 5e-3 (seen 2.0e-3 at the second step, after one update from
gradients that differ by rounding), logits 3e-2 relative to their largest
(bf16 activations through 7 layers), BN state 1e-2 (seen 2.7e-3: the
statistics of bf16 conv outputs that the frameworks round differently,
one bf16 step being 2^-8 = 3.9e-3), the first update 2e-2 relative (seen
3.2e-3: s1/s2 are f32 sums on both sides), parameters after two steps
3e-3 (seen 1.2e-3 at the stem).  The plain path in bf16
is compared in the forward only: its BatchNorm gradients carry bf16
rounding of 10-40% of their size in JAX itself (JAX bf16 vs JAX f32).
"""

import functools
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh

from distributed_tensorflow_examples_tpu.data import data_service as jax_dsvc
from distributed_tensorflow_examples_tpu.data import datasets as jax_datasets
from distributed_tensorflow_examples_tpu.data import pipeline as jax_pipeline
from distributed_tensorflow_examples_tpu.data import streams as jax_streams
from distributed_tensorflow_examples_tpu.models import resnet as jax_resnet
from distributed_tensorflow_examples_tpu.ops import bn as jax_bn
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu.train.checkpoint import (
    flat_params_of as jax_flat_params_of,
)
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import data_service as dsvc
from distributed_tensorflow_examples_tpu_torch.data import (
    datasets,
    filestream,
    native_loader,
    pipeline,
    streams,
)
from distributed_tensorflow_examples_tpu_torch.examples import resnet50 as cli
from distributed_tensorflow_examples_tpu_torch.models import layers, resnet
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import Experiment, checkpoint, optim, state, step

torch.set_num_threads(1)

TINY = dict(stage_sizes=(1, 1), width=8, num_classes=10)
LR, BOUNDARIES = 0.1, {1: 0.1}
TOL = {
    "float32": dict(loss=1e-5, logits=1e-4, state=1e-4, grad=1e-4, param=1e-5),
    "bfloat16": dict(loss=5e-3, logits=3e-2, state=1e-2, grad=2e-2, param=3e-3),
}


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _port_mesh():
    return mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=1"), "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


class _ForcePallas:
    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = jax_bn.FORCE_PALLAS
        jax_bn.FORCE_PALLAS = self.on

    def __exit__(self, *exc):
        jax_bn.FORCE_PALLAS = self.old


@functools.lru_cache(maxsize=None)
def _jax_tiny_init():
    """JAX ``init`` of the tiny config, once (it reads neither the stem nor
    the compute dtype), jitted: op by op it takes seconds."""
    params, mstate = jax.jit(lambda k: jax_resnet.init(jax_resnet.Config(**TINY), k))(
        jax.random.key(0)
    )
    return jax.device_get(params), jax.device_get(mstate)


def _jax_init(stem, dtype):
    params, mstate = _jax_tiny_init()
    return jax_resnet.Config(**TINY, stem=stem, compute_dtype=dtype), params, mstate


STEP_CASES = [
    ("s2d", "float32", False),
    ("s2d", "float32", True),
    ("s2d", "bfloat16", True),
    ("conv7", "bfloat16", True),
]


@pytest.mark.parametrize("stem,dtype,use_mesh", STEP_CASES)
def test_train_steps_match_jax(stem, dtype, use_mesh):
    jcfg, jparams, jmstate = _jax_init(stem, dtype)
    batches = [_batch(seed=0), _batch(seed=1)]
    jmesh = _jax_mesh() if use_mesh else None
    jloss = jax_resnet.loss_fn(jcfg, mesh=jmesh)
    jopt = optax.sgd(optax.piecewise_constant_schedule(LR, BOUNDARIES), momentum=0.9)
    with _ForcePallas(use_mesh):
        js = jax_state.create_state(lambda r: (jparams, jmstate), jopt, jax.random.key(0))
        jstep = jax_step.build_train_step(jloss, jopt, donate=False)
        jmetrics, jfirst = [], None
        for b in batches:
            js, m = jstep(js, b)
            jmetrics.append({k: float(v) for k, v in m.items()})
            jfirst = jfirst or jax.device_get(js.params)

    tcfg = resnet.Config(**TINY, stem=stem, compute_dtype=dtype)
    tloss = resnet.loss_fn(tcfg, mesh=_port_mesh() if use_mesh else None)
    topt = optim.SGD(optim.piecewise_constant_schedule(LR, BOUNDARIES), momentum=0.9)
    ts = state.create_state(lambda seed: (jparams, jmstate), topt, 0, "cpu")
    tstep = step.build_train_step(tloss, topt)
    tol = TOL[dtype]
    for i, b in enumerate(batches):
        ts, m = tstep(ts, _tb(b))
        for k in ("loss", "ce", "accuracy"):
            assert abs(float(m[k]) - jmetrics[i][k]) <= tol["loss"], (i, k)
        if i == 0:  # the first update is -lr * gradient: the gradients, per leaf
            for (path, p), p0, p1 in zip(bridge._leaves(ts.params), jax.tree.leaves(jparams),
                                         jax.tree.leaves(jfirst)):
                want = np.asarray(p0, np.float64) - np.asarray(p1, np.float64)
                got = np.asarray(p0, np.float64) - p.detach().numpy().astype(np.float64)
                assert _rel(got, want) <= tol["grad"], f"{path}: first update"
    assert ts.step == 2
    for (path, p), want in zip(bridge._leaves(ts.params), jax.tree.leaves(js.params)):
        diff = np.abs(p.detach().numpy() - np.asarray(want)).max()
        assert diff <= tol["param"], f"{path}: max |Δparam| {diff:.3e}"
    for (path, s), want in zip(bridge._leaves(ts.model_state), jax.tree.leaves(js.model_state)):
        assert not s.requires_grad
        np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=tol["state"],
                                   atol=tol["state"], err_msg=path)


@pytest.mark.parametrize(
    "stem,dtype,use_mesh",
    [("s2d", "bfloat16", False), ("conv7", "bfloat16", False), ("s2d", "float32", True)],
)
def test_forward_train_and_eval_match_jax(stem, dtype, use_mesh):
    jcfg, jparams, jmstate = _jax_init(stem, dtype)
    b = _batch(seed=2)
    # Running stats away from their init, so eval reads real values.
    jmstate = jax.tree.map(lambda v: v * 0.5 + 0.25, jmstate)
    tcfg = resnet.Config(**TINY, stem=stem, compute_dtype=dtype)
    tparams = bridge.params_from_numpy(jparams)
    tmstate = bridge.params_from_numpy(jax.device_get(jmstate))
    tol = TOL[dtype]
    for train in (True, False):
        with _ForcePallas(use_mesh and train):
            jlogits, jnew = jax.jit(
                lambda p, s, x: jax_resnet.apply(
                    jcfg, p, s, x, train=train, mesh=_jax_mesh() if use_mesh else None
                )
            )(jparams, jmstate, b["image"])
        tlogits, tnew = resnet.apply(tcfg, tparams, tmstate, torch.from_numpy(b["image"]),
                                     train=train, mesh=_port_mesh() if use_mesh else None)
        assert tlogits.dtype == tcfg.dtype and tuple(tlogits.shape) == (4, 10)
        got = tlogits.to(torch.float32).numpy()
        want = np.asarray(jlogits, np.float32)
        assert np.abs(got - want).max() <= tol["logits"] * max(np.abs(want).max(), 1.0)
        for (path, s), w in zip(bridge._leaves(tnew), jax.tree.leaves(jnew)):
            np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=tol["state"],
                                       atol=tol["state"], err_msg=path)
        assert (tlogits.argmax(-1).numpy() == np.asarray(jlogits).argmax(-1)).mean() >= 0.75
        acc = layers.accuracy(tlogits, torch.from_numpy(b["label"]))
        assert float(acc) == pytest.approx(float(np.mean(got.argmax(-1) == b["label"])))


@pytest.mark.parametrize(
    "size,k,stride,padding",
    [(8, 3, 1, "SAME"), (8, 3, 2, "SAME"), (7, 3, 2, "SAME"), (8, 1, 2, "SAME"),
     (9, 7, 2, "SAME"), (8, 3, 1, "VALID"), (8, 4, 1, ((1, 2), (1, 2)))],
)
def test_conv2d_pads_as_lax_does(size, k, stride, padding):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    kern = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    want = lax.conv_general_dilated(
        x, kern, (stride, stride), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST,
    )
    got = layers.conv2d({"kernel": torch.from_numpy(kern)}, torch.from_numpy(x),
                        stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    assert got.is_contiguous()  # NHWC in memory: what the BN kernels read
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "boundaries", [{1: 0.1}, {3: 0.1, 4: 0.1}, {int(1 * 0.6): 0.1, int(1 * 0.8): 0.1}, {}],
    ids=["one", "two", "folded", "none"],
)
def test_piecewise_schedule_matches_optax(boundaries):
    ours = optim.piecewise_constant_schedule(0.1, boundaries)
    theirs = optax.piecewise_constant_schedule(0.1, boundaries)
    for count in range(8):
        assert ours(count) == float(theirs(count)), count


def test_sgd_momentum_matches_optax():
    rng = np.random.default_rng(6)
    params = {"a": {"kernel": rng.standard_normal((5, 7)).astype(np.float32)},
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
             for _ in range(5)]
    sched = {2: 0.1, 4: 0.5}
    jopt = optax.sgd(optax.piecewise_constant_schedule(0.1, sched), momentum=0.9)
    topt = optim.SGD(optim.piecewise_constant_schedule(0.1, sched), momentum=0.9)
    jp, js = params, jopt.init(params)
    tp = state.as_param_leaves(params, "cpu")
    ts = topt.init(tp)
    for k, g in enumerate(grads):
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(state.leaves(tp), state.leaves(g)):
            p.grad = torch.from_numpy(x)
        topt.update(ts, tp, k)
    for (path, got), want in zip(bridge._leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=path)


def test_imagenet_synthetic_and_pipeline_are_bit_identical():
    ours = datasets.imagenet_synthetic(image_size=16, n_train=24, n_test=8, num_classes=5, seed=3)
    theirs = jax_datasets.imagenet_synthetic(image_size=16, n_train=24, n_test=8,
                                             num_classes=5, seed=3)
    assert ours.source == theirs.source == "synthetic" and ours.num_classes == 5
    for split in ("train", "test"):
        for k in ("image", "label"):
            a, b = getattr(ours, split)[k], getattr(theirs, split)[k]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    mine = iter(pipeline.InMemoryPipeline(ours.train, batch_size=5, seed=7))
    ref = iter(jax_pipeline.InMemoryPipeline(theirs.train, batch_size=5, seed=7,
                                             process_index=0, process_count=1))
    src = streams.resolve_image_source(None, fallback=lambda: ours)
    via_streams = streams.train_iter(src, batch_size=5, seed=7)
    for _ in range(12):  # past two epoch boundaries (4 batches an epoch)
        a, b, c = next(mine), next(ref), next(via_streams)
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(c[k], b[k])


def test_flat_vector_of_a_resnet_tree_matches_jax_and_round_trips():
    _jcfg, jparams, _ = _jax_init("s2d", "float32")
    tparams = bridge.params_from_numpy(jparams)
    flat = bridge.flat_params_of(tparams)
    np.testing.assert_array_equal(flat, jax_flat_params_of(jparams))
    total, unflatten = bridge.flat_param_spec(resnet.init_numpy(resnet.Config(**TINY), 1)[0])
    assert total == flat.size
    back = unflatten(flat)
    assert "stage0/block0" in back and "conv1" in back["stage0/block0"]

    def keys(tree):
        return {k: keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None

    assert keys(back) == keys(tparams)
    for (path, a), (_, b) in zip(bridge._leaves(back), bridge._leaves(tparams)):
        assert torch.equal(a, b), path


def _flags(tmp, steps, **kw):
    args = cli.build_parser().parse_args([
        "--device=cpu", "--image_size=32", "--num_classes=10", "--batch_size=4",
        f"--train_steps={steps}", "--synthetic_examples=16", "--log_every_steps=1",
        "--checkpoint_every_steps=1000", f"--log_dir={tmp}", "--learning_rate=0.1",
    ])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _tiny_experiment(args):
    cfg = resnet.Config(**TINY, compute_dtype="float32")
    return Experiment(
        init_fn=lambda seed: resnet.init_numpy(cfg, seed),
        loss_fn_factory=lambda mesh: resnet.loss_fn(cfg, mesh=mesh),
        optimizer=optim.SGD(cli.lr_schedule(args), momentum=0.9),
        flags=args,
    )


def _momentum_buffers(opt_state):
    return [opt_state.state[p]["momentum_buffer"] for g in opt_state.param_groups
            for p in g["params"]]


def test_checkpoint_resume_restores_bn_stats_and_momentum(tmp_path):
    """3 steps with --log_dir; a restarted run auto-resumes with the BN
    running stats and SGD momentum buffers bit for bit."""
    batch = _batch()
    first = _tiny_experiment(_flags(tmp_path, 3))
    assert all(isinstance(s, torch.Tensor) and not s.requires_grad
               for s in state.leaves(first.state.model_state))
    first.run(itertools.repeat(batch))
    first.finish()
    assert checkpoint.CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 3
    again = _tiny_experiment(_flags(tmp_path, 3))
    again.run(itertools.repeat(batch))
    assert again.session.records["resumed_at"] == 3 and again.state.step == 3
    for (path, a), b in zip(bridge._leaves(again.state.model_state),
                            state.leaves(first.state.model_state)):
        assert torch.equal(a, b), path
    bufs_a, bufs_b = _momentum_buffers(again.state.opt_state), _momentum_buffers(first.state.opt_state)
    assert len(bufs_a) == len(state.leaves(first.state.params))
    assert all(torch.equal(a, b) for a, b in zip(bufs_a, bufs_b))
    for (path, a), b in zip(bridge._leaves(again.state.params), state.leaves(first.state.params)):
        assert torch.equal(a, b), path
    # The restored run steps on from there.
    more = _tiny_experiment(_flags(tmp_path, 4))
    more.run(itertools.repeat(batch))
    assert more.state.step == 4


def test_cli_trains_evaluates_and_prints_final(tmp_path, capsys):
    # Batch 64: the 256 test images in 4 eval batches.
    exp = cli.run_training(_flags(tmp_path, 2, log_dir=None, batch_size=64,
                                  synthetic_examples=64))
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("FINAL ")]
    assert line and re.search(r"FINAL step=2 steps_per_sec=\S+ "
                              r"examples_per_sec_per_chip=\S+ test_accuracy=\S+", line[0])
    assert set(exp.test_metrics) == {"accuracy", "loss"}


@pytest.mark.parametrize(
    "extra,error,match",
    [
        (["--bn_ghost_slices=2"], NotImplementedError, "A8b"),
        (["--mesh=data=2"], ValueError, "needs 2 devices, have 1"),
        (["--data_dir=dsvc://127.0.0.1:1"], dsvc.DSVCDeadlineError, "unreachable"),
    ],
    # Stable case ids: the data=2 case raised NotImplementedError (A5)
    # while the port ran on one device only, and the dsvc:// case raised
    # NotImplementedError (A10) until the data planes came.
    ids=["extra0-NotImplementedError-A8", "extra1-NotImplementedError-A5",
         "extra2-NotImplementedError-A10"],
)
def test_cli_refuses_what_later_slices_bring(extra, error, match, tmp_path, monkeypatch):
    """An unreachable data service fails as JAX's client fails, once the
    client's reconnect deadline (cut to half a second in both packages
    here; 60 s by default) passes: never on fallback data."""
    for mod in (dsvc, jax_dsvc):
        monkeypatch.setattr(mod.RemoteDatasetSource, "__init__", functools.partialmethod(
            mod.RemoteDatasetSource.__init__, reconnect_deadline_s=0.5))
    with pytest.raises(error, match=match):
        cli.main(["--device=cpu", "--image_size=32", "--num_classes=10", "--batch_size=4",
                  "--train_steps=1", "--synthetic_examples=8", *extra])
    if error is dsvc.DSVCDeadlineError:
        with pytest.raises(jax_dsvc.DSVCDeadlineError, match=match):
            jax_streams.resolve_image_source(extra[0].split("=", 1)[1], fallback=None, seed=0,
                                             num_classes=10)


def test_cli_ps_job_exits_zero_and_shard_dirs_refuse(tmp_path, capsys):
    """A ``--job_name=ps`` task exits 0; a shard directory, refused until
    the data planes came, resolves to its branch as JAX's does, its last
    shard held out as the test split."""
    assert cli.main(["--job_name=ps"]) == 0
    assert "job_name=ps" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    x = {"image": rng.integers(0, 256, size=(24, 8, 8, 3)).astype(np.uint8),
         "label": rng.integers(0, 10, size=24).astype(np.int32)}
    native_loader.write_raw_shards(str(tmp_path / "dtxr"), x, shard_records=8)
    filestream.write_array_shards(str(tmp_path / "npz"), x, rows_per_shard=8)
    for sub, kind in (("dtxr", "native"), ("npz", "stream")):
        src = streams.resolve_image_source(str(tmp_path / sub), fallback=None, seed=0,
                                           num_classes=10)
        ref = jax_streams.resolve_image_source(str(tmp_path / sub), fallback=None, seed=0,
                                               num_classes=10)
        assert src.kind == ref.kind == kind and src.train_shards == ref.train_shards
        assert len(src.train_shards) == 2 and src.ds.train == {}
        assert src.ds.test["image"].dtype == np.float32 and len(src.ds.test["image"]) == 8
        assert src.ds.test["image"].tobytes() == ref.ds.test["image"].tobytes()
