"""The port's mixture-of-experts layer and MoE transformer against the JAX
package, on the CPU, in one process (``ThreadRanks`` for the meshes).

The cases of ``tests/test_moe.py`` at their shapes: no drops (:49),
capacity drops (:59), the balanced aux loss (:75), expert-sharded against
replicated on ``data=2,expert=4`` (:88), the non-dividing shape's numbers
and warnings (:193), decode against the training forward (:231), the
pipeline refusal (:148) and the group size (:327); the MoE transformer's
train step on ``data=2,expert=4`` (:119) and its sharded ``generate``
(:258) against the JAX ones.  Routing decisions (expert, place, kept)
equal JAX's exactly; values within JAX's own tolerances, rtol 1e-4 and
atol 1e-5, gradients against ``jax.grad``.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.ops import moe as jax_moe
from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.parallel import sharding as jax_sharding
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import layers
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.ops import moe as torch_moe
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import optim, state, step
from distributed_tensorflow_examples_tpu_torch.utils import threefry

jax_tf = jax_models.transformer
RTOL, ATOL = 1e-4, 1e-5
EXPERT_MESH = {"data": 2, "expert": 4}


def _pair(n_experts, top_k, capacity_factor, dim, hidden, group_size=1024):
    """(JAX config, port config, JAX params, port params as tensors that
    take gradients): the port's ``moe.init`` from key 0 (JAX ``init``'s
    numbers bit for bit, ``test_init_numpy_moe_leaves_equal_jax_init``),
    the same arrays in both packages."""
    kw = dict(n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
              group_size=group_size)
    jcfg, tcfg = jax_moe.MoEConfig(**kw), torch_moe.MoEConfig(**kw)
    tp = layers.as_numpy(torch_moe.init(threefry.key(0), dim, hidden, tcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tp), _tensors(tp)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(True)


def _as_jax(tree):
    """The port's ``init_numpy`` tree as JAX arrays: both packages start
    from the same numbers (``init_numpy`` is JAX ``init``'s, to a few
    ulps in the normal positions: ``test_init_numpy_moe_leaves_equal_jax_init``)."""
    return jax.tree.map(jnp.asarray, tree)


def _leaves(tree):
    return {jax_sharding.path_of(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_reference(p, x, moe, w):
    """In one compiled call: JAX ``apply``'s value and ``jax.grad`` of
    ``sum(y * w) + 0.3 aux`` (params and x), and its routing decisions."""
    def loss(p, x):
        y, aux = jax_moe.apply(p, x, moe)
        return jnp.sum(y * w) + 0.3 * aux, (y, aux)

    (_l, (y, aux)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
    return y, aux, grads, _jax_routing(p, x, moe)


def _jax_routing(p, x, moe):
    """JAX ``apply``'s routing decisions (its lines, on one device):
    (expert idx, place, kept), [G, g, k] each."""
    B, T, D = x.shape
    N = B * T
    g = jax_moe._group(N, moe.group_size, 1)
    tok = x.reshape(N // g, g, D)
    logits = jnp.einsum("gnd,de->gne", tok.astype(jnp.float32), p["router"]["kernel"])
    _vals, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), moe.top_k)
    onehot = jax.nn.one_hot(idx, moe.n_experts, dtype=jnp.float32)
    G, k, E = N // g, moe.top_k, moe.n_experts
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, k * g, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(G, k, g, E)
                  .transpose(0, 2, 1, 3) * onehot, axis=-1)
    keep = pos < jax_moe.capacity(g, moe)
    return idx, pos.astype(jnp.int32), keep


CASES = {
    # name: (E, k, capacity factor, D, H, x shape, x key) of tests/test_moe.py
    "no_drops_49": (4, 2, 8.0, 16, 32, (2, 8, 16)),
    "drops_59": (2, 1, 0.1, 8, 16, (2, 16, 8)),
    "grouped": (8, 2, 1.25, 16, 32, (4, 64, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_routing_outputs_and_gradients_match_jax(name):
    E, k, cf, D, H, shape = CASES[name]
    group = 64 if name == "grouped" else 1024  # 4 groups of 64 (with drops)
    jcfg, tcfg, jp, tp = _pair(E, k, cf, D, H, group)
    x = np.asarray(jax.random.normal(jax.random.key(1), shape, jnp.float32))
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    jy, jaux, (jg, jgx), (want_idx, want_pos, want_keep) = _jax_reference(
        jp, jnp.asarray(x), jcfg, jnp.asarray(w))

    # Routing decisions: exactly JAX's.
    g = want_idx.shape[1]
    C = torch_moe.capacity(g, tcfg)
    _probs, idx, _gates, pos, keep = torch_moe.route(
        torch.tensor(x).reshape(-1, g, D), tp["router"]["kernel"].detach(), tcfg, C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))

    # Values and gradients (of sum(y * w) + 0.3 aux) against jax.grad.
    xt = torch.tensor(x, requires_grad=True)
    ty, taux = torch_moe.apply(tp, xt, tcfg)
    (torch.sum(ty * torch.tensor(w)) + 0.3 * taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    got = {p: t.grad.numpy() for p, t in bridge._leaves(tp)}
    for path, want in _leaves(jg).items():
        np.testing.assert_allclose(got[path], want, rtol=RTOL, atol=ATOL, err_msg=path)
    if name == "drops_59":
        # C = max(4, ceil(32/2*0.1)) = 4 slots an expert: at most 8 of 32
        # tokens routed, the others exactly zero.
        zero_rows = int((ty.detach().reshape(-1, D) == 0).all(dim=-1).sum())
        assert zero_rows >= 32 - 2 * 4, zero_rows
    else:
        assert float(taux.detach()) > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_aux_loss_balanced_is_one_and_ties_route_as_jax(top_k):
    """:75: a zero router gives uniform probabilities, so aux == 1; the
    ties go to the lowest experts first, as ``jax.lax.top_k`` breaks
    them."""
    jcfg, tcfg, jp, tp = _pair(4, top_k, 1.25, 8, 16)
    jp["router"]["kernel"] = jnp.zeros_like(jp["router"]["kernel"])
    with torch.no_grad():
        tp["router"]["kernel"].zero_()
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 16, 8), jnp.float32))
    _y, jaux, _g, (want_idx, want_pos, want_keep) = _jax_reference(
        jp, jnp.asarray(x), jcfg, jnp.zeros(x.shape, jnp.float32))
    _y, taux = torch_moe.apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(float(taux), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=ATOL)
    _p, idx, _g, pos, keep = torch_moe.route(
        torch.tensor(x).reshape(1, 64, 8), tp["router"]["kernel"].detach(), tcfg,
        torch_moe.capacity(64, tcfg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


def _on_expert_mesh(fn):
    """``fn(mesh)`` on 8 simulated ranks of a ``data=2,expert=4`` mesh,
    under its axes; the ranks' results."""
    def rank(_r):
        m = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2,expert=4"), "cpu")
        with m.axes():
            return fn(m)

    return collectives.ThreadRanks(8).run(rank)


def _expert_block(p, m):
    """This rank's experts of the port params ``p`` (the rule table's
    blocks), as tensors that take gradients."""
    rules = [(r.split("moe/")[1], spec) for r, spec in torch_moe.SHARDING_RULES]
    return _tensors(sharding.shard_pytree(layers.as_numpy(p), m, rules))


def test_moe_expert_sharded_matches_replicated():
    """:88 on ``data=2,expert=4``: expert-sharded weights give the
    replicated numbers.  The JAX test's [4, 8, 16] input is replicated
    over the mesh (every rank routes the whole batch with the experts
    gathered); a [8, 8, 16] input, one row a rank, routes its own groups
    and crosses the expert group by all-to-all.  The step's gradient
    rules then give ``jax.grad``'s: replicated leaves averaged over the
    batch group, expert leaves summed over data and divided by its size."""
    jcfg, tcfg, jp, tp = _pair(4, 2, 4.0, 16, 32)
    small = np.asarray(jax.random.normal(jax.random.key(1), (4, 8, 16), jnp.float32))
    big = np.asarray(jax.random.normal(jax.random.key(2), (8, 8, 16), jnp.float32))
    w = np.random.default_rng(3).normal(size=big.shape).astype(np.float32)
    want_small, _ = jax.jit(jax_moe.apply, static_argnums=2)(jp, jnp.asarray(small), jcfg)

    def jax_loss(p, x):  # the mean over the 8 ranks of their losses below
        y, aux = jax_moe.apply(p, x, jcfg)
        return jnp.sum(y * w) / 8 + 0.3 * aux, (y, aux)

    (_l, (want_big, want_aux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(big))
    collectives.TRAFFIC.clear()

    def rank(m):
        p = _expert_block(tp, m)
        assert p["w1"].shape[0] == 1  # E/X experts here
        whole, _ = torch_moe.apply(p, torch.tensor(small), tcfg, mesh=m, x_sharded=False)
        rows = sharding.rank_rows(8, m.row_index, m.row_shards)
        x = torch.tensor(big[rows], requires_grad=True)
        y, aux = torch_moe.apply(p, x, tcfg, mesh=m)
        (torch.sum(y * torch.tensor(w[rows])) + 0.3 * aux).backward()
        plan = [m.shape.get("expert", 1) > 1 and path != "router/kernel"
                for path, _t in bridge._leaves(p)]
        step.sync_gradients(p, m.batch_group, plan, m.expert_grad_group)
        grads = {path: t.grad.numpy() for path, t in bridge._leaves(p)}
        return whole.detach().numpy(), y.detach().numpy(), float(aux), x.grad.numpy(), grads

    out = _on_expert_mesh(rank)
    assert collectives.TRAFFIC["expert_a2a_calls"] > 0
    for r, (whole, y, aux, gx, grads) in enumerate(out):
        np.testing.assert_allclose(whole, np.asarray(want_small), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(y, np.asarray(want_big)[r:r + 1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(aux, float(want_aux), rtol=RTOL, atol=ATOL)
        # x's cotangent sums every rank's loss (the all-to-all and the aux
        # sums carry it back): 8 times the mean loss's.
        np.testing.assert_allclose(gx / 8, np.asarray(jgx)[r:r + 1], rtol=RTOL, atol=ATOL)
        e = r % 4
        for path, want in _leaves(jg).items():
            want = want if path == "router/kernel" else want[e:e + 1]
            np.testing.assert_allclose(grads[path], want, rtol=RTOL, atol=ATOL, err_msg=path)


def test_moe_nondividing_shape_gives_jax_numbers_and_warnings():
    """:193: B*T = 6 tokens over data=2 x expert=4 shards: no group size
    gives a shard multiple, so the layer warns (JAX's "pad batch*seq" and
    "token pin" warnings) and still gives the replicated numbers."""
    jcfg, tcfg, jp, tp = _pair(4, 2, 4.0, 16, 32)
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 3, 16), jnp.float32))
    want, want_aux = jax.jit(jax_moe.apply, static_argnums=2)(jp, jnp.asarray(x), jcfg)

    def rank(m):
        y, aux = torch_moe.apply(_expert_block(tp, m), torch.tensor(x), tcfg, mesh=m,
                                 x_sharded=False)
        return y.detach().numpy(), float(aux)

    with warnings.catch_warnings(record=True) as ws:  # the module's state: every thread's
        warnings.simplefilter("always")
        out = _on_expert_mesh(rank)
    msgs = [str(w.message) for w in ws]
    for y, aux in out:
        np.testing.assert_allclose(y, np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(aux, float(want_aux), rtol=RTOL, atol=ATOL)
    assert sum("pad batch*seq" in s for s in msgs) == 8, msgs
    assert sum("token pin" in s for s in msgs) == 8, msgs


TINY = dict(vocab_size=211, dim=32, n_layers=2, n_heads=4, compute_dtype="float32",
            attention="xla", moe_experts=4, moe_capacity_factor=8.0)


def test_init_numpy_moe_leaves_equal_jax_init():
    """``init_numpy``'s MoE tree is JAX ``init``'s: the same keys, every
    leaf but the normal positions bit for bit."""
    cfg = dict(TINY, max_seq_len=32)
    want = _leaves(jax_tf.init(jax_tf.Config(**cfg), jax.random.key(0)))
    got = dict(bridge._leaves(torch_tf.init_numpy(torch_tf.Config(**cfg), 0)))
    assert got.keys() == want.keys()
    assert {p for p in want if "/moe/" in p} == {
        f"block_{i}/moe/{n}" for i in range(2)
        for n in ("router/kernel", "w1", "b1", "w2", "b2")}
    shapes = dict(bridge._leaves(torch_tf.param_shapes(torch_tf.Config(**cfg))))
    for path, w in want.items():
        assert tuple(shapes[path]) == w.shape, path
        if path == "pos/table":
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-8)
        else:
            np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_moe_decode_matches_training_forward():
    """:231: teacher-forcing the tokens through the KV-cache decode gives
    the training forward's logits, in the port and against JAX's."""
    cfg = dict(TINY, max_seq_len=32)
    tcfg = torch_tf.Config(**cfg)
    init = torch_tf.init_numpy(tcfg, 0)
    params = _tensors(init)
    toks = np.random.default_rng(1).integers(0, 211, size=(2, 10))
    with torch.no_grad():
        train = torch_tf.apply(tcfg, params, torch.tensor(toks))
        cache = torch_tf.init_cache(tcfg, 2, 10)
        for pos in range(10):
            logits, cache = torch_tf.decode_step(tcfg, params, cache, torch.tensor(toks[:, pos]),
                                                 pos)
            np.testing.assert_allclose(logits.numpy(), train[:, pos].numpy(),
                                       atol=2e-4, rtol=1e-4)
    jcfg = jax_tf.Config(**cfg)
    want = jax.jit(jax_tf.apply, static_argnums=0)(jcfg, _as_jax(init), jnp.asarray(toks))
    np.testing.assert_allclose(train.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_moe_with_pipeline_stages_does_not_compose():
    """:148: MoE and pipeline stages refuse together, as JAX ``init``."""
    cfg = torch_tf.Config(n_layers=4, moe_experts=4, pipeline_stages=2)
    with pytest.raises(ValueError, match="compose"):
        torch_tf.param_shapes(cfg)
    with pytest.raises(ValueError, match="compose"):
        torch_tf.init_numpy(cfg, 0)
    with pytest.raises(ValueError, match="compose"):
        jax_tf.init(jax_tf.Config(n_layers=4, moe_experts=4, pipeline_stages=2),
                    jax.random.key(0))


@pytest.mark.parametrize("group", [32, 64])
def test_moe_group_size_plumbs_from_transformer_config(group):
    """:327: ``Config.moe_group_size`` reaches the layer; the loss and its
    aux term equal JAX ``loss_fn``'s at both group sizes."""
    cfg = dict(vocab_size=64, dim=32, n_layers=1, n_heads=4, max_seq_len=64,
               compute_dtype="float32", moe_experts=4, moe_group_size=group)
    tcfg, jcfg = torch_tf.Config(**cfg), jax_tf.Config(**cfg)
    assert torch_tf._moe_cfg(tcfg).group_size == group == jax_tf._moe_cfg(jcfg).group_size
    toks = np.random.default_rng(group).integers(0, 64, size=(2, 65))
    batch = {"x": toks[:, :-1], "y": toks[:, 1:]}
    init = torch_tf.init_numpy(tcfg, 0)
    jloss, (_s, jm) = jax.jit(jax_tf.loss_fn(jcfg))(
        _as_jax(init), None, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))
    params = _tensors(init)
    loss, (_s, tm) = torch_tf.loss_fn(tcfg)(params, None,
                                            {k: torch.tensor(v) for k, v in batch.items()},
                                            threefry.key(1))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]), rtol=RTOL, atol=ATOL)


STEP_CFG = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, max_seq_len=16,
                attention="xla", compute_dtype="float32", moe_experts=4, moe_top_k=2)
STEPS, LR, CLIP = 2, 1e-2, 1.0


def test_transformer_moe_train_step_on_expert_mesh_matches_jax():
    """:119: the MoE transformer's train step on ``data=2,expert=4``
    (clip 1.0 + AdamW 1e-2) against the JAX step on
    ``local_mesh_for_testing`` of that shape: per-step loss and aux, and
    every leaf after the steps, each rank's experts its block; the rule
    table keeps the experts on their ranks."""
    jcfg, tcfg = jax_tf.Config(**STEP_CFG), torch_tf.Config(**STEP_CFG)
    mesh = local_mesh_for_testing(EXPERT_MESH)
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    init = torch_tf.init_numpy(tcfg, 0)
    st, shardings = jax_state.create_sharded_state(
        lambda r: _as_jax(init), opt, jax.random.key(0), mesh=mesh,
        rules=jax_tf.sharding_rules(jcfg))
    assert shardings.params["block_0"]["moe"]["w1"].spec[0] == "expert"
    spec = jax_tf.batch_spec(jcfg)
    stepper = jax_step.build_train_step(jax_tf.loss_fn(jcfg, mesh=mesh), opt, mesh=mesh,
                                        state_shardings=shardings, batch_spec=spec)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        xy = rng.integers(0, 64, size=(8, 17)).astype(np.int32)
        batches.append({"x": xy[:, :-1], "y": xy[:, 1:]})
    want = []
    for b in batches:
        st, m = stepper(st, as_global({k: jnp.asarray(v) for k, v in b.items()}, mesh,
                                      spec=spec))
        want.append((float(m["loss"]), float(m["moe_aux"])))
    want_leaves = _leaves(jax.device_get(st.params))
    collectives.TRAFFIC.clear()

    def rank(m):
        s, specs = state.create_sharded_state(
            lambda seed: init, optim.ClippedAdamW(LR, CLIP), 0, "cpu", mesh=m,
            rules=torch_tf.sharding_rules(tcfg))
        assert specs["params"]["block_0"]["moe"]["w1"][0] == "expert"
        fn = step.build_train_step(torch_tf.loss_fn(tcfg, mesh=m), optim.ClippedAdamW(LR, CLIP),
                                   mesh=m)
        rows = sharding.rank_rows(8, m.row_index, m.row_shards)
        got = []
        for b in batches:
            s, met = fn(s, {k: torch.tensor(v[rows]).long() for k, v in b.items()})
            got.append((float(met["loss"]), float(met["moe_aux"])))
        return got, {p: t.detach().numpy() for p, t in bridge._leaves(s.params)}

    out = _on_expert_mesh(rank)
    assert collectives.TRAFFIC["expert_a2a_calls"] > 0
    assert collectives.TRAFFIC["expert_grads_calls"] > 0
    for r, (got, leaves) in enumerate(out):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        e = r % 4
        for path, w in want_leaves.items():
            if "/moe/" in path and not path.endswith("router/kernel"):
                w = w[e:e + 1]
            np.testing.assert_allclose(leaves[path], w, rtol=0, atol=2e-4, err_msg=path)


def test_moe_generate_expert_sharded_matches_replicated():
    """:258: ``generate`` on ``data=2,expert=4`` (each rank its row, the
    experts' tokens crossing the expert group every position) gives the
    replicated greedy tokens, and JAX's."""
    cfg = dict(TINY, max_seq_len=48)
    tcfg = torch_tf.Config(**cfg)
    init = torch_tf.init_numpy(tcfg, 0)
    prompt = np.random.default_rng(0).integers(0, 211, size=(8, 6)).astype(np.int32)
    whole = torch_tf.generate(tcfg, _tensors(init), prompt, max_new_tokens=10)
    jcfg = jax_tf.Config(**cfg)
    want = jax_tf.generate(jcfg, _as_jax(init), prompt, max_new_tokens=10)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))

    def rank(m):
        params = _tensors(sharding.shard_pytree(init, m, torch_tf.sharding_rules(tcfg)))
        return torch_tf.generate(tcfg, params, prompt, max_new_tokens=10, mesh=m).numpy()

    for got in _on_expert_mesh(rank):
        np.testing.assert_array_equal(got, np.asarray(want))
