"""GPipe over the ``pipe`` axis in the port (``parallel/pipeline.py``,
the pipelined transformer) against the JAX package's
``tests/test_pipeline.py``.

The JAX side runs on ``local_mesh_for_testing({"data": 2, "pipe": 4})``
(8 fake CPU devices), the port on 8 ``collectives.ThreadRanks`` building
the same mesh; both read the same numpy inputs drawn from a seed.

- the MLP stack (8 layers over 4 stages, 4 microbatches; 4 layers, 2
  microbatches for the gradients): forward and ``jax.grad`` of the
  sequential stack at rtol 1e-5 in float32, every rank's gradient of
  its layers and of the input (the input's cotangent summed over pipe,
  as JAX's ``shard_map`` transposes a replicated input);
- a batch that does not split into the microbatches raises JAX's
  ``ValueError``;
- the transformer at the file's ``vocab 64, dim 32, 4 layers, pipe=4,
  M=2`` against JAX ``apply`` on the same mesh (2e-4), and
  ``init_numpy`` stacked equal to JAX ``init`` (uniform leaves bit for
  bit, the normal positions within float32 ulps, as the flat layout);
- three SGD steps of the train step against the JAX step on the mesh
  (loss 1e-5, leaves 2e-4), the stacked leaves each rank's layers;
- the checkpoint: saved on the pipe=4 mesh, restored there and at one
  rank, and one rank's restored back on the mesh, all bit for bit;
- ``collapse_pipeline`` then ``decode_step`` per position against the
  pipelined forward (2e-4), and ``generate`` greedy end to end.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.parallel import pipeline as jax_pipeline
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.parallel import pipeline as pipeline_lib
from distributed_tensorflow_examples_tpu_torch.train import checkpoint, optim, state
from distributed_tensorflow_examples_tpu_torch.train import step as step_lib

MESH = {"data": 2, "pipe": 4}
TINY = dict(vocab_size=64, dim=32, n_layers=4, n_heads=2, max_seq_len=16,
            attention="xla", compute_dtype="float32")
STEPS, LR = 3, 0.1


@pytest.fixture(scope="module")
def jax_mesh():
    return local_mesh_for_testing(MESH)


def _on_mesh(fn, text="data=2,pipe=4", n=8):
    """``fn(mesh)`` on each of ``n`` simulated ranks of the ``text`` mesh."""
    def rank(_r):
        return fn(mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(text), "cpu"))

    return collectives.ThreadRanks(n, timeout=120).run(rank)


def _stack(n_layers, dim, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, dim, dim)) / np.sqrt(dim)).astype(np.float32),
            "b": (0.1 * rng.standard_normal((n_layers, dim))).astype(np.float32)}


def _jax_stage(p, x):
    def body(x, q):
        return jnp.tanh(x @ q["w"] + q["b"]), None

    return jax.lax.scan(body, x, p)[0]


def _torch_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _port_pipeline(stacked, x, microbatches, *, grads: bool):
    """Every rank's (pipe index, output, gradients of its layers and of
    the input) for ``sum(out ** 2)``."""
    def fn(mesh):
        k = stacked["w"].shape[0] // mesh.shape["pipe"]
        mine = {n: torch.tensor(a[mesh.pipe_index * k:(mesh.pipe_index + 1) * k],
                                requires_grad=True) for n, a in stacked.items()}
        xt = torch.tensor(x, requires_grad=True)
        with mesh.axes():
            out = pipeline_lib.pipeline_apply(mesh, _torch_stage, mine, xt,
                                              microbatches=microbatches)
            if grads:
                out.square().sum().backward()
        g = {n: t.grad for n, t in mine.items()} if grads else None
        return mesh.pipe_index, out.detach().numpy(), g, xt.grad

    return _on_mesh(fn)


def test_pipeline_forward_matches_sequential(jax_mesh):
    dim, L, B, M = 16, 8, 8, 4  # 8 layers over 4 stages, 4 microbatches
    stacked = _stack(L, dim, 0)
    x = np.random.default_rng(1).standard_normal((B, dim)).astype(np.float32)
    ref = x
    for p in pipeline_lib.unstack_stages(stacked, L):  # the stack/unstack round trip
        ref = np.tanh(ref @ p["w"] + p["b"])
    sharded = jax.device_put(jax.tree.map(jnp.asarray, stacked), NamedSharding(jax_mesh, JP("pipe")))
    want = np.asarray(jax.jit(lambda p, x: jax_pipeline.pipeline_apply(
        jax_mesh, _jax_stage, p, x, microbatches=M))(sharded, jnp.asarray(x)))
    np.testing.assert_allclose(want, ref, rtol=1e-5, atol=1e-5)
    for _pi, out, _g, _gx in _port_pipeline(stacked, x, M, grads=False):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_pipeline_grads_match_sequential(jax_mesh):
    dim, L, B, M = 8, 4, 8, 2
    stacked = _stack(L, dim, 3)
    x = np.random.default_rng(2).standard_normal((B, dim)).astype(np.float32)
    jstack = jax.tree.map(jnp.asarray, stacked)
    g_ref, gx_ref = jax.grad(lambda p, x: jnp.sum(_jax_stage(p, x) ** 2), argnums=(0, 1))(
        jstack, jnp.asarray(x))
    sharded = jax.device_put(jstack, NamedSharding(jax_mesh, JP("pipe")))
    g_pipe = jax.jit(jax.grad(lambda p: jnp.sum(jax_pipeline.pipeline_apply(
        jax_mesh, _jax_stage, p, jnp.asarray(x), microbatches=M) ** 2)))(sharded)
    for n in stacked:
        np.testing.assert_allclose(np.asarray(g_pipe[n]), np.asarray(g_ref[n]), rtol=1e-4,
                                   atol=1e-5)
    for pi, _out, g, gx in _port_pipeline(stacked, x, M, grads=True):
        for n in stacked:
            np.testing.assert_allclose(g[n].numpy(), np.asarray(g_ref[n])[pi:pi + 1],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), rtol=1e-5, atol=1e-6)
    traffic = collectives.TRAFFIC
    assert traffic["pipe_calls"] and traffic["pipe_out_calls"] and traffic["pipe_in_calls"]


def test_pipeline_rejects_bad_microbatch(jax_mesh):
    stacked = _stack(4, 8, 0)
    with pytest.raises(ValueError, match="microbatches"):
        jax_pipeline.pipeline_apply(jax_mesh, _jax_stage, jax.tree.map(jnp.asarray, stacked),
                                    jnp.zeros((6, 8), jnp.float32), microbatches=4)

    def fn(mesh):
        with mesh.axes():
            pipeline_lib.pipeline_apply(mesh, _torch_stage, stacked, torch.zeros(6, 8),
                                        microbatches=4)

    with pytest.raises(ValueError, match="not divisible by microbatches=4"):
        _on_mesh(fn)


def _cfgs():
    return (torch_tf.Config(**TINY),
            torch_tf.Config(**TINY, pipeline_stages=4, microbatches=2))


@functools.lru_cache(maxsize=None)
def _inits():
    flat, pipe = _cfgs()
    return torch_tf.init_numpy(flat, 0), torch_tf.init_numpy(pipe, 0)


def test_init_numpy_stacked_equals_jax_init():
    flat, pipe = _cfgs()
    p_flat, p_pipe = _inits()
    want = jax_models.transformer.init(
        jax_models.transformer.Config(**TINY, pipeline_stages=4, microbatches=2),
        jax.random.key(0))
    got = dict(bridge._leaves(p_pipe))
    for path, leaf in bridge._leaves(jax.device_get(want)):
        tol = 1e-6 if path == "pos/table" else 0
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=0, atol=tol, err_msg=path)
    assert got.keys() == dict(bridge._leaves(want)).keys()
    for i in range(flat.n_layers):  # the per-layer draws, stacked
        np.testing.assert_array_equal(p_pipe["blocks"]["qkv"]["kernel"][i],
                                      p_flat[f"block_{i}"]["qkv"]["kernel"])
    shapes = torch_tf.param_shapes(pipe)
    assert shapes["blocks"]["qkv"]["kernel"] == (4, 32, 96)
    assert [tuple(a.shape) for _p, a in bridge._leaves(p_pipe)] == [
        s for _p, s in bridge._leaves(shapes)]


def _port_state(cfg, mesh, init=None, seed=0):
    params = init if init is not None else _inits()[1]
    return state.create_sharded_state(lambda s: params, optim.SGD(LR), seed, "cpu", mesh=mesh,
                                      rules=torch_tf.sharding_rules(cfg))


def test_transformer_pipeline_matches_jax_apply(jax_mesh):
    flat, pipe = _cfgs()
    x = np.random.default_rng(5).integers(0, 64, size=(4, 16))
    jcfg = jax_models.transformer.Config(**TINY, pipeline_stages=4, microbatches=2)
    jstate, _sh = jax_train.create_sharded_state(
        lambda r: jax.tree.map(jnp.asarray, _inits()[1]), optax.sgd(LR), jax.random.key(0),
        mesh=jax_mesh, rules=jax_models.transformer.sharding_rules(jcfg))
    want = np.asarray(jax.jit(lambda p, x: jax_models.transformer.apply(
        jcfg, p, x, mesh=jax_mesh))(jstate.params, jnp.asarray(x)))
    ref = torch_tf.apply(flat, state.as_param_leaves(_inits()[0], "cpu"), torch.tensor(x))
    np.testing.assert_allclose(ref.detach().numpy(), want, rtol=2e-4, atol=2e-4)

    def fn(mesh):
        st, specs = _port_state(pipe, mesh)
        assert st.params["blocks"]["qkv"]["kernel"].shape == (1, 32, 96)
        assert tuple(specs["params"]["blocks"]["qkv"]["kernel"]) == ("pipe", None, "model")
        with mesh.axes(), torch.no_grad():
            return torch_tf.apply(pipe, st.params, torch.tensor(x), mesh=mesh).numpy()

    for out in _on_mesh(fn):
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="'pipe' axis is exactly that size"):
        torch_tf.apply(pipe, {**state.as_param_leaves(_inits()[1], "cpu")}, torch.tensor(x),
                       mesh=mesh_lib.build_mesh(mesh_lib.MeshSpec(), "cpu"))


def _lm_batches(n, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.integers(0, 64, size=(rows, 17)).astype(np.int32)
        out.append({"x": xy[:, :-1], "y": xy[:, 1:]})
    return out


def _global(leaves_by_rank):
    """Each leaf's global array from every rank's (pipe index, leaves):
    a stacked leaf's blocks concatenated in pipe order."""
    out = {}
    for path in leaves_by_rank[0][1]:
        blocks = {pi: lv[path] for pi, lv in leaves_by_rank}
        out[path] = (np.concatenate([blocks[i] for i in sorted(blocks)])
                     if path.startswith("blocks/") else blocks[0])
    return out


@pytest.fixture(scope="module")
def trained(jax_mesh):
    """The port's 3 SGD steps on data=2,pipe=4 and the JAX step's."""
    _flat, pipe = _cfgs()
    batches = _lm_batches(STEPS)
    jcfg = jax_models.transformer.Config(**TINY, pipeline_stages=4, microbatches=2)
    jst, sh = jax_train.create_sharded_state(
        lambda r: jax.tree.map(jnp.asarray, _inits()[1]), optax.sgd(LR), jax.random.key(0),
        mesh=jax_mesh, rules=jax_models.transformer.sharding_rules(jcfg))
    stepper = jax_train.build_train_step(
        jax_models.transformer.loss_fn(jcfg, mesh=jax_mesh), optax.sgd(LR), mesh=jax_mesh,
        state_shardings=sh)
    want_losses = []
    for b in batches:
        jst, m = stepper(jst, as_global({k: jnp.asarray(v) for k, v in b.items()}, jax_mesh))
        want_losses.append(float(m["loss"]))
    want = dict(bridge._leaves(jax.device_get(jst.params)))

    def fn(mesh):
        st, _specs = _port_state(pipe, mesh)
        f = step_lib.build_train_step(torch_tf.loss_fn(pipe, mesh=mesh), optim.SGD(LR),
                                      mesh=mesh)
        rows = sharding.rank_rows(8, mesh.row_index, mesh.row_shards)
        losses = []
        for b in batches:
            st, m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
            losses.append(float(m["loss"]))
        leaves = {p: t.detach().numpy().copy() for p, t in bridge._leaves(st.params)}
        return mesh.data_index, mesh.pipe_index, losses, leaves

    return _on_mesh(fn), want_losses, want


def test_transformer_pipeline_train_step_matches_jax(trained):
    ranks, want_losses, want = trained
    for _d, _pi, losses, _lv in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
    assert want_losses[-1] < want_losses[0]
    for d in (0, 1):
        got = _global([(pi, lv) for dd, pi, _l, lv in ranks if dd == d])
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[path], np.asarray(w), rtol=0, atol=2e-4,
                                       err_msg=path)
    # The replicated leaves are one gradient on every pipe rank.
    heads = [lv["emb/table"] for _d, _pi, _l, lv in ranks]
    assert all(np.array_equal(h, heads[0]) for h in heads)


def test_pipeline_checkpoint_roundtrip(tmp_path):
    """Stacked ``P("pipe")`` leaves survive save -> restore on the mesh,
    at one rank, and from one rank back on the mesh, bit for bit (each
    simulated rank writes its own directory: they share one process)."""
    _flat, pipe = _cfgs()
    whole = _inits()[1]

    def fn(mesh):
        r = mesh.data_index * 4 + mesh.pipe_index
        st, specs = _port_state(pipe, mesh)
        mgr = checkpoint.CheckpointManager(str(tmp_path / f"r{r}"),
                                           param_specs=specs["params"])
        with mesh.axes():
            mgr.save(0, st)
            other, _s = _port_state(pipe, mesh, init=jax.tree.map(np.zeros_like, whole))
            restored = mgr.restore_latest(other)
        return mesh.pipe_index, {p: t.detach().numpy().copy()
                                 for p, t in bridge._leaves(restored.params)}

    ranks = _on_mesh(fn)
    got = _global(ranks[:4])
    for path, w in bridge._leaves(whole):
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    # At one rank (pipe 1: every layer here), then back on the mesh.
    one = mesh_lib.build_mesh(mesh_lib.MeshSpec(), "cpu")
    st1, specs1 = _port_state(pipe, one, init=jax.tree.map(np.zeros_like, whole))
    mgr = checkpoint.CheckpointManager(str(tmp_path / "r0"), param_specs=specs1["params"])
    with one.axes():
        restored = mgr.restore_latest(st1)
        for path, t in bridge._leaves(restored.params):
            np.testing.assert_array_equal(t.detach().numpy(), dict(bridge._leaves(whole))[path])
        st1.step = 1
        mgr.save(1, st1)

    def back(mesh):
        mine = checkpoint.CheckpointManager(str(tmp_path / "r0"),
                                            param_specs=_port_state(pipe, mesh)[1]["params"])
        other, _s = _port_state(pipe, mesh, init=jax.tree.map(np.zeros_like, whole))
        with mesh.axes():
            got = mine.restore_latest(other)
        return mesh.pipe_index, {p: t.detach().numpy().copy()
                                 for p, t in bridge._leaves(got.params)}

    got = _global(_on_mesh(back)[:4])
    for path, w in bridge._leaves(whole):
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_pipeline_collapse_then_decode_matches_training_forward():
    _flat, pipe = _cfgs()
    x = np.random.default_rng(5).integers(0, 64, size=(2, 10))

    def fn(mesh):
        st, _specs = _port_state(pipe, mesh)
        with mesh.axes(), torch.no_grad():
            return torch_tf.apply(pipe, st.params, torch.tensor(x), mesh=mesh).numpy()

    logits_pipe = _on_mesh(fn)[0]
    cfg_flat, params_flat = torch_tf.collapse_pipeline(pipe, state.as_param_leaves(
        _inits()[1], "cpu"))
    assert cfg_flat.pipeline_stages == 1 and "blocks" not in params_flat
    with torch.no_grad():
        cache = torch_tf.init_cache(cfg_flat, 2, 10)
        for pos in range(10):
            logits, cache = torch_tf.decode_step(cfg_flat, params_flat, cache,
                                                 torch.tensor(x[:, pos]), pos)
            np.testing.assert_allclose(logits.numpy(), logits_pipe[:, pos], rtol=2e-4,
                                       atol=2e-4)
    out = torch_tf.generate(cfg_flat, params_flat, x[:, :4], max_new_tokens=5)
    assert tuple(out.shape) == (2, 9)
    with pytest.raises(NotImplementedError, match="non-pipelined"):
        torch_tf.decode_step(pipe, {}, {}, torch.zeros(2, dtype=torch.int64), 0)
    assert torch_tf.collapse_pipeline(cfg_flat, params_flat)[1] is params_flat
    assert dataclasses.replace(pipe, pipeline_stages=1, microbatches=1) == cfg_flat


#: (stages, microbatches, data ranks, remat): M below, at and above S, one
#: microbatch (all bubble but one tick), a microbatch a row.
SCHEDULES = [(2, 1, 1, True), (2, 2, 2, True), (2, 3, 1, True), (2, 6, 4, True),
             (2, 12, 1, True), (4, 1, 1, True), (4, 2, 2, True), (4, 3, 1, True),
             (4, 6, 2, True), (8, 1, 1, True), (8, 4, 1, True), (8, 12, 1, True),
             (2, 2, 1, False), (4, 2, 1, False), (2, 12, 1, False)]


@functools.lru_cache(maxsize=None)
def _schedule_reference():
    """The schedules' stack (8 layers), input (12 rows) and JAX's output
    and ``jax.grad`` of the sequential stack, computed once."""
    stacked = _stack(8, 4, 7)
    x = np.random.default_rng(9).standard_normal((12, 4)).astype(np.float32)
    jstack = jax.tree.map(jnp.asarray, stacked)
    ref = np.asarray(_jax_stage(jstack, jnp.asarray(x)))
    g_ref, gx_ref = jax.grad(lambda p, x: jnp.sum(_jax_stage(p, x) ** 2), argnums=(0, 1))(
        jstack, jnp.asarray(x))
    return stacked, x, ref, g_ref, gx_ref


@pytest.mark.parametrize("stages,micro,data,remat", SCHEDULES,
                         ids=[f"S{s}-M{m}-D{d}" + ("" if r else "-noremat")
                              for s, m, d, r in SCHEDULES])
def test_pipeline_schedules_match_the_sequential_stack(stages, micro, data, remat):
    """The GPipe schedule at S stages and M microbatches (bubble ticks S - 1
    of M + S - 1) beside a data axis, with and without the stage recompute:
    the output and every rank's gradients of its layers and of the input
    are ``jax.grad`` of the sequential stack's, float32."""
    stacked, x, ref, g_ref, gx_ref = _schedule_reference()
    L = stacked["w"].shape[0]

    def fn(mesh):
        k = L // stages
        mine = {n: torch.tensor(a[mesh.pipe_index * k:(mesh.pipe_index + 1) * k],
                                requires_grad=True) for n, a in stacked.items()}
        xt = torch.tensor(x, requires_grad=True)
        with mesh.axes():
            out = pipeline_lib.pipeline_apply(mesh, _torch_stage, mine, xt,
                                              microbatches=micro, remat=remat)
            out.square().sum().backward()
        return mesh.pipe_index, out.detach().numpy(), {n: t.grad for n, t in mine.items()}, \
            xt.grad

    k = L // stages
    for pi, out, g, gx in _on_mesh(fn, f"data={data},pipe={stages}", data * stages):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        for n in stacked:
            np.testing.assert_allclose(g[n].numpy(), np.asarray(g_ref[n])[pi * k:(pi + 1) * k],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), rtol=1e-5, atol=1e-6)
