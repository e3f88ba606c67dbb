"""The port's transformer forward against the JAX package's, at tiny size.

JAX ``init`` draws the weights; they cross to the port through the flat
registry vector (``flat_params_of`` -> the port's ``flat_param_spec``
unflatten), exactly as a published version does, and both packages run
``apply`` on the same token ids.  The ``n_layers = 12`` config pins the
flat vector's leaf order: ``jax.tree`` sorts dict keys, so ``block_10``
comes before ``block_2``.  Tolerances: atol 1e-4 on float32 logits (the
same math in another summation order); atol 5e-2 on bfloat16 logits (every
matmul, the residual stream and the logits round to bf16, whose spacing
at |logit| ~ 2-4 is 2^-6..2^-5, and the two frameworks round at different
places inside GELU and the softmax)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.train.checkpoint import flat_params_of
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import layers
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, max_seq_len=64)
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _configs(n_layers, attention, dtype):
    kw = dict(TINY, n_layers=n_layers, attention=attention, compute_dtype=dtype)
    return jax_tf.Config(**kw), torch_tf.Config(**kw)


def _ids(batch=2, t=64, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t), dtype=np.int32)


def _jax_params(cfg, seed=0):
    return jax.device_get(jax_tf.init(cfg, jax.random.key(seed)))


def _port_params(jcfg, tcfg, jparams):
    total, unflatten = bridge.flat_param_spec(torch_tf.param_shapes(tcfg))
    flat = flat_params_of(jparams)
    assert flat.size == total
    return unflatten(flat, "cpu")


@pytest.mark.parametrize(
    "n_layers,attention,dtype",
    [
        (2, "xla", "float32"),
        (2, "xla", "bfloat16"),
        (2, "flash", "float32"),
        (2, "flash", "bfloat16"),
        (12, "xla", "float32"),
        (12, "flash", "bfloat16"),
    ],
)
def test_apply_matches_jax(n_layers, attention, dtype):
    jcfg, tcfg = _configs(n_layers, attention, dtype)
    jparams = _jax_params(jcfg, seed=n_layers)
    tparams = _port_params(jcfg, tcfg, jparams)
    ids = _ids(seed=n_layers)
    want = np.asarray(jax_tf.apply(jcfg, jparams, ids).astype(np.float32))
    with torch.inference_mode():
        got = torch_tf.apply(tcfg, tparams, torch.from_numpy(ids))
    assert got.dtype == tcfg.dtype and tuple(got.shape) == (2, 64, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ATOL[dtype])


def test_flat_order_is_jax_tree_order_at_twelve_layers():
    jcfg, tcfg = _configs(12, "xla", "float32")
    jparams = _jax_params(jcfg, seed=3)
    tparams = _port_params(jcfg, tcfg, jparams)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tflat = dict(
        ("/".join(str(getattr(k, "key", k)) for k in path), None)
        for path, _ in jleaves
    )
    assert list(tflat) == [p for p, _ in bridge._leaves(tparams)]
    for path, leaf in jleaves:
        node = tparams
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # The hazard itself: block_10's weights are not block_2's.
    assert not np.array_equal(
        tparams["block_10"]["qkv"]["kernel"].numpy(),
        tparams["block_2"]["qkv"]["kernel"].numpy(),
    )


def test_params_from_numpy_equals_registry_route():
    jcfg, tcfg = _configs(2, "xla", "float32")
    jparams = _jax_params(jcfg, seed=5)
    direct = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    via_flat = _port_params(jcfg, tcfg, jparams)
    assert [p for p, _ in bridge._leaves(direct)] == [
        p for p, _ in bridge._leaves(via_flat)
    ]
    for (_, a), (_, b) in zip(bridge._leaves(direct), bridge._leaves(via_flat)):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(
        bridge.flat_params_of(direct), flat_params_of(jparams)
    )


def test_param_shapes_match_jax_init():
    jcfg, tcfg = _configs(3, "xla", "float32")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), _jax_params(jcfg))
    tshapes = torch_tf.param_shapes(tcfg)
    assert jax.tree.structure(jshapes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.structure(tshapes, is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.leaves(jshapes, is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.leaves(tshapes, is_leaf=lambda x: isinstance(x, tuple))


def test_init_numpy_draws_jax_scales_deterministically():
    tcfg = torch_tf.Config(**TINY)
    a, b = torch_tf.init_numpy(tcfg, 0), torch_tf.init_numpy(tcfg, 0)
    np.testing.assert_array_equal(bridge.flat_params_of(a), bridge.flat_params_of(b))
    lim = np.sqrt(6.0 / (64 + 192))
    qkv = a["block_0"]["qkv"]["kernel"]
    assert qkv.dtype == np.float32 and np.abs(qkv).max() <= lim
    assert np.abs(a["emb"]["table"]).max() <= 1.0 / 64
    assert (a["block_1"]["ln2"]["scale"] == 1).all()
    assert (a["block_1"]["mlp_in"]["bias"] == 0).all()


def test_out_of_range_ids_give_nan_rows_like_jnp_take():
    table = {"table": torch.arange(12.0).reshape(4, 3)}
    out = layers.embedding_lookup(table, torch.tensor([0, -1, 4, -5]))
    np.testing.assert_array_equal(out[:2].numpy(), [[0, 1, 2], [9, 10, 11]])
    assert torch.isnan(out[2:]).all()


@pytest.mark.parametrize(
    "change", [dict(pipeline_stages=2), dict(moe_experts=4)]
)
def test_later_slices_raise_not_implemented(change):
    cfg = dataclasses.replace(torch_tf.Config(**TINY), **change)
    with pytest.raises(NotImplementedError, match="slice"):
        torch_tf.param_shapes(cfg)
    with pytest.raises(NotImplementedError, match="slice"):
        torch_tf.apply(cfg, {}, torch.zeros(1, 4, dtype=torch.int64))


def test_mesh_raises_not_implemented():
    cfg = torch_tf.Config(**TINY)
    with pytest.raises(NotImplementedError, match="slice"):
        torch_tf.apply(cfg, {}, torch.zeros(1, 4, dtype=torch.int64), mesh=object())
