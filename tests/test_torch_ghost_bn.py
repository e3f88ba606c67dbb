"""Ghost-batch BatchNorm in the port (``models/layers.py::_batchnorm_ghost``,
``--bn_ghost_slices``), the twins of ``tests/test_models.py``'s
``test_resnet_ghost_bn_slice_local_stats_and_parity``,
``test_ghost_bn_eval_recovers_global_moments`` and
``test_ghost_bn_composes_with_zero1_and_checkpoint``.

A small ResNet (one bottleneck stage, width 8, float32, 10 classes, 2
ghost slices) takes one SGD step on 16 images of 16 x 16 on a
``slice=2,data=4`` mesh: the JAX step on ``local_mesh_for_testing``, the
port's on 8 ``collectives.ThreadRanks``, each rank holding its 2 rows
(slice major), from the port's ``init_numpy`` in both.  Through the
plain path (autograd through the moments) and through the fused path
(``ops/bn.py``'s wrappers, the B6/B7 kernels on the card), the port's
loss is JAX's within 1e-5, every parameter within 1e-5 after the step,
and every rank's row of the [2, C] running stats equal to JAX's row of
its slice within 1e-6.  Every BatchNorm all-reduce is over the rank's
slice-local data group, never a group that crosses a slice; the
gradient bucket alone crosses.  Against SyncBN on the same mesh the
slice means average to the global mean and the within-slice variances
fall short of the global by a positive share under 20%, as JAX's.
Evaluation with [S, C] stats normalises with the global moments (the
law of total variance), on one rank and gathered over ``slice``; ghost
BN composes with ZeRO-1 over slice x data and the checkpoint.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import layers, resnet
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import checkpoint, optim, state
from distributed_tensorflow_examples_tpu_torch.train import step as step_lib

CFG = resnet.Config(num_classes=10, stage_sizes=(1,), width=8, compute_dtype="float32",
                    bn_ghost_slices=2)
MESH = "slice=2,data=4"


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
            "label": rng.integers(0, 10, size=(16,)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _init(ghost: int):
    return resnet.init_numpy(dataclasses.replace(CFG, bn_ghost_slices=ghost), 0)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's loss, params and model state after one ghost step."""
    mesh = local_mesh_for_testing({"slice": 2, "data": 4})
    jcfg = jax_models.resnet.Config(num_classes=10, stage_sizes=(1,), width=8,
                                    compute_dtype="float32", bn_ghost_slices=2)
    bspec = JP(("slice", "data"))
    opt = optax.sgd(0.1)
    st, sh = jax_train.create_sharded_state(
        lambda r: jax.tree.map(jnp.asarray, _init(2)), opt, jax.random.key(0), mesh=mesh,
        rules=jax_models.resnet.sharding_rules(jcfg))
    step = jax_train.build_train_step(jax_models.resnet.loss_fn(jcfg, l2=0.0), opt, mesh=mesh,
                                      state_shardings=sh, batch_spec=bspec)
    st, m = step(st, as_global(_batch(), mesh, spec=bspec))
    return (float(m["loss"]), dict(bridge._leaves(jax.device_get(st.params))),
            dict(bridge._leaves(jax.device_get(st.model_state))))


def _port_step(ghost: int, fused: bool, *, zero=False, ckpt_dir=None):
    """One SGD step on the mesh: each rank's (slice, loss, params, model
    state, the BN all-reduces' groups, this rank's mesh groups)."""
    cfg = dataclasses.replace(CFG, bn_ghost_slices=ghost)
    calls = {}
    real = collectives.all_reduce_sum_

    def recording(t, *, tag="other", axis_name="data"):
        g = collectives.group(axis_name)
        calls.setdefault(threading.get_ident(), []).append((tag, g))
        return real(t, tag=tag, axis_name=axis_name)

    def rank(_r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(MESH), "cpu")
        opt = optim.SGD(0.1)
        st, specs = state.create_sharded_state(
            lambda s: _init(ghost), opt, 0, "cpu", mesh=mesh, rules=resnet.sharding_rules(cfg),
            zero_opt_sharding=zero, zero_min_elements=256)
        f = step_lib.build_train_step(resnet.loss_fn(cfg, l2=0.0, mesh=mesh if fused else None),
                                      opt, mesh=mesh)
        rows = sharding.rank_rows(16, mesh.row_index, mesh.row_shards)
        batch = {k: torch.from_numpy(v[rows]) for k, v in _batch().items()}
        st, m = f(st, batch)
        out = dict(slice=mesh.slice_index, loss=float(m["loss"]),
                   params={p: t.detach().numpy().copy() for p, t in bridge._leaves(st.params)},
                   model_state={p: t.numpy().copy() for p, t in bridge._leaves(st.model_state)},
                   calls=list(calls.get(threading.get_ident(), [])),
                   groups=(mesh.group, mesh.batch_group), specs=specs)
        if ckpt_dir is not None:
            mgr = checkpoint.CheckpointManager(
                str(ckpt_dir / f"r{mesh.row_index}"), param_specs=specs["params"],
                state_specs=specs["model_state"])
            with mesh.axes():
                mgr.save(1, st)
                fresh, _s = state.create_sharded_state(
                    lambda s: _init(ghost), opt, 0, "cpu", mesh=mesh,
                    rules=resnet.sharding_rules(cfg), zero_opt_sharding=zero,
                    zero_min_elements=256)
                restored = mgr.restore_latest(fresh)
            out["restored"] = {p: t.numpy().copy()
                               for p, t in bridge._leaves(restored.model_state)}
            restored, m2 = f(restored, batch)
            out["loss2"] = float(m2["loss"])
        return out

    collectives.all_reduce_sum_ = recording
    try:
        return collectives.ThreadRanks(8, timeout=120).run(rank)
    finally:
        collectives.all_reduce_sum_ = real


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_resnet_ghost_bn_slice_local_stats_and_parity(fused):
    want_loss, want_params, want_state = _jax_step()
    ranks = _port_step(2, fused)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=0, atol=1e-5)
        for path, w in want_params.items():
            np.testing.assert_allclose(r["params"][path], np.asarray(w), rtol=0, atol=1e-5,
                                       err_msg=path)
        for path, w in want_state.items():  # the rank's slice's row of [2, C]
            got = r["model_state"][path]
            assert got.shape == (1, np.asarray(w).shape[1]), path
            np.testing.assert_allclose(got[0], np.asarray(w)[r["slice"]], rtol=0, atol=1e-6,
                                       err_msg=path)
        data_group, batch_group = r["groups"]
        bn = [g for tag, g in r["calls"] if tag == "bn"]
        assert len(bn) >= 8 and all(g is data_group for g in bn)  # slice-local, 4 ranks
        assert data_group.size == 4
        grads = [g for tag, g in r["calls"] if tag == "grads"]
        assert grads and all(g is batch_group and g.size == 8 for g in grads)


def test_ghost_statistics_against_syncbn_on_the_slice_mesh():
    ghost = _port_step(2, True)
    sync = _port_step(0, True)
    mom = CFG.bn_momentum
    mean_g = np.stack([r["model_state"]["bn_stem/mean"][0] for r in ghost[::4]]) / (1 - mom)
    var_g = (np.stack([r["model_state"]["bn_stem/var"][0] for r in ghost[::4]]) - mom) / (
        1 - mom)
    assert [r["slice"] for r in ghost[::4]] == [0, 1]
    mean_s = sync[0]["model_state"]["bn_stem/mean"] / (1 - mom)
    var_s = (sync[0]["model_state"]["bn_stem/var"] - mom) / (1 - mom)
    np.testing.assert_allclose(mean_g.mean(0), mean_s, rtol=1e-4, atol=1e-5)
    gap = (var_s - var_g.mean(0)) / np.maximum(var_s, 1e-8)
    assert np.all(gap > -1e-5), gap
    assert 0.0 < float(gap.max()) < 0.20, gap
    np.testing.assert_allclose(ghost[0]["loss"], sync[0]["loss"], rtol=0.05)


def test_ghost_bn_on_one_rank_splits_the_batch():
    """With no slice axis the local batch splits into S ghost batches, each
    with its own statistics (JAX's reshape), on the plain and fused paths
    alike, and their running stats are JAX's on the slice mesh."""
    _want_loss, _p, want_state = _jax_step()
    x = torch.from_numpy(_batch()["image"])
    params, st = _init(2)
    one = mesh_lib.build_mesh(mesh_lib.MeshSpec(), "cpu")
    outs = []
    for mesh in (None, one):
        with one.axes():
            _logits, new = resnet.apply(CFG, state.as_param_leaves(params, "cpu"),
                                        state.as_state_leaves(st, "cpu"), x, train=True,
                                        mesh=mesh)
        outs.append(new)
        for path, w in want_state.items():
            np.testing.assert_allclose(dict(bridge._leaves(new))[path].numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match="not divisible by 2 slices"):
        layers.batchnorm({"scale": torch.ones(3), "bias": torch.zeros(3)},
                         {"mean": torch.zeros(2, 3), "var": torch.ones(2, 3)},
                         torch.zeros(3, 3), train=True, ghost_slices=2)


def test_ghost_bn_eval_recovers_global_moments():
    c = 5
    params = {"scale": torch.full((c,), 2.0), "bias": torch.full((c,), 0.5)}
    rng = np.random.default_rng(3)
    means = rng.normal(size=(2, c)).astype(np.float32)
    vars_ = rng.uniform(0.5, 2.0, size=(2, c)).astype(np.float32)
    x = rng.normal(size=(4, 3, 3, c)).astype(np.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want, _ = jax_models.layers.batchnorm(jp, {"mean": jnp.asarray(means),
                                               "var": jnp.asarray(vars_)},
                                          jnp.asarray(x), train=False)
    got, _ = layers.batchnorm(params, {"mean": torch.from_numpy(means),
                                       "var": torch.from_numpy(vars_)},
                              torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def rank(_r):  # a rank holds its slice's row; eval gathers the rows
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("slice=2"), "cpu")
        s = mesh.slice_index
        with mesh.axes():
            y, _ = layers.batchnorm(params, {"mean": torch.from_numpy(means[s:s + 1]),
                                             "var": torch.from_numpy(vars_[s:s + 1])},
                                    torch.from_numpy(x), train=False)
        return y.numpy()

    for y in collectives.ThreadRanks(2).run(rank):
        np.testing.assert_allclose(y, np.asarray(want), rtol=1e-6)


def test_ghost_bn_composes_with_zero1_and_checkpoint(tmp_path):
    ranks = _port_step(2, True, zero=True, ckpt_dir=tmp_path)
    plain = _port_step(2, True)
    specs = ranks[0]["specs"]
    assert any("slice" in str(s) for s in state.leaves(specs["opt_state"]))
    assert any("slice" in str(s) for s in state.leaves(specs["model_state"]))
    for z, p in zip(ranks, plain):
        assert z["loss"] == p["loss"]  # ZeRO-1's numbers are the replicated run's
        for path, w in p["params"].items():
            np.testing.assert_array_equal(z["params"][path], w, err_msg=path)
        for path, w in z["model_state"].items():
            np.testing.assert_array_equal(z["restored"][path], w, err_msg=path)
        assert np.isfinite(z["loss2"])


GHOST = [(s, f) for s in (1, 2, 4, 8) for f in (False, True)]


@pytest.mark.parametrize("slices,fused", GHOST,
                         ids=[f"S{s}-{'fused' if f else 'plain'}" for s, f in GHOST])
def test_ghost_batchnorm_matches_jax_on_one_device(slices, fused):
    """``layers.batchnorm(train=True, ghost_slices=S)`` on one rank (the
    batch read as S ghost batches) against JAX's on one device: the
    output (ReLU inside), the [S, C] running stats, and the gradients of
    x, scale and bias, float32."""
    rng = np.random.default_rng(slices)
    x = rng.normal(size=(8, 3, 3, 6)).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    jp, js = jax_models.layers.batchnorm_init(6, ghost_slices=slices)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def jax_loss(p, x):
        y, st = jax_models.layers.batchnorm(p, js, x, train=True, relu=True,
                                            ghost_slices=slices)
        return jnp.sum(y * jnp.arange(6.0)), (y, st)

    (_l, (want_y, want_st)), (g_p, g_x) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    p = {"scale": torch.tensor(scale, requires_grad=True),
         "bias": torch.tensor(bias, requires_grad=True)}
    st = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    xt = torch.tensor(x, requires_grad=True)
    one = mesh_lib.build_mesh(mesh_lib.MeshSpec(), "cpu")
    with one.axes():
        y, new = layers.batchnorm(p, st, xt, train=True, relu=True, ghost_slices=slices,
                                  mesh=one if fused else None)
    (y * torch.arange(6.0)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0, atol=1e-5)
    for k in ("mean", "var"):
        assert new[k].shape == (slices, 6)
        np.testing.assert_allclose(new[k].numpy(), np.asarray(want_st[k]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=0, atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_p[k]), rtol=0, atol=1e-4)


SLICE_MESHES = [(2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (8, 1)]


@pytest.mark.parametrize("slices,data", SLICE_MESHES,
                         ids=[f"slice={s},data={d}" for s, d in SLICE_MESHES])
def test_slice_mesh_statistics_are_the_ghost_batches(slices, data):
    """On ``slice=S,data=D`` every rank normalises with its slice's
    statistics, summed over the slice's D ranks through the fused path
    (``ops/bn.py`` over the slice-local data group), and keeps its
    slice's row: the one-rank ghost path over the global batch (rows slice
    major, so ghost batch s is slice s's rows) within float32 rounding."""
    rng = np.random.default_rng(slices * 10 + data)
    n = slices * data
    x = rng.normal(size=(2 * n, 3, 3, 5)).astype(np.float32)
    p = {"scale": torch.full((5,), 1.5), "bias": torch.full((5,), 0.25)}
    st = {"mean": torch.zeros(slices, 5), "var": torch.ones(slices, 5)}
    want_y, want = layers.batchnorm(p, st, torch.from_numpy(x), train=True, relu=True,
                                    ghost_slices=slices)

    def rank(_r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(f"slice={slices},data={data}"),
                                   "cpu")
        rows = sharding.rank_rows(2 * n, mesh.row_index, mesh.row_shards)
        s = mesh.slice_index
        with mesh.axes():
            y, new = layers.batchnorm(p, {k: v[s:s + 1] for k, v in st.items()},
                                      torch.from_numpy(x[rows]), train=True, relu=True,
                                      ghost_slices=slices, mesh=mesh)
        return rows, s, y, new

    for rows, s, y, new in collectives.ThreadRanks(n).run(rank):
        torch.testing.assert_close(y, want_y[rows], rtol=0, atol=1e-5)
        for k in ("mean", "var"):
            torch.testing.assert_close(new[k], want[k][s:s + 1], rtol=0, atol=1e-6)
