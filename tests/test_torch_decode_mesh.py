"""KV-cache decode under a ``model`` and a ``seq`` mesh in the port, the
twin of ``tests/test_transformer.py::test_generate_tp_sharded_matches_replicated``.

Simulated ranks (``collectives.ThreadRanks``) lay JAX ``init``'s weights
(vocab 211, dim 64, 2 layers, 4 heads, float32) out by the rule table
and decode a [4, 8] prompt 12 tokens on ``data=2,model=2`` and on
``data=1,seq=2,model=2``: each rank its row shard's rows, its heads'
cache (``init_cache(mesh=)``) and its vocab block, the head's logits
gathered over ``model``, the ``seq`` axis replicated.  The tokens equal
the replicated run's and JAX ``generate``'s on a ``data=4,model=2`` mesh;
``decode_step``'s logits at one position agree with the replicated
step's within JAX's 2e-4, and so does ``decode_step_batch``'s.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import optim, state

KW = dict(vocab_size=211, dim=64, n_layers=2, n_heads=4, max_seq_len=48,
          compute_dtype="float32", attention="xla")
NEW = 12


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_models.transformer.Config(**KW)
    params = jax.device_get(jax_models.transformer.init(jcfg, jax.random.key(0)))
    prompt = np.random.default_rng(0).integers(0, KW["vocab_size"], size=(4, 8)).astype(
        np.int32)
    mesh = local_mesh_for_testing({"data": 4, "model": 2})
    st, _ = jax_train.create_sharded_state(lambda r: params, optax.sgd(0.1), jax.random.key(0),
                                           mesh=mesh, rules=jax_models.transformer.SHARDING_RULES)
    want = np.asarray(jax_models.transformer.generate(jcfg, st.params, prompt,
                                                      max_new_tokens=NEW, mesh=mesh))
    return jax.tree.map(np.asarray, params), prompt, want


def _replicated():
    params, prompt, _want = _setup()
    cfg = torch_tf.Config(**KW)
    leaves = state.as_param_leaves(params, "cpu")
    out = torch_tf.generate(cfg, leaves, prompt, max_new_tokens=NEW)
    cache = torch_tf.init_cache(cfg, 4, 16)
    with torch.no_grad():
        logits, _c = torch_tf.decode_step(cfg, leaves, cache, torch.tensor(prompt[:, 0]), 0)
    return out.numpy(), logits.numpy()


@pytest.mark.parametrize("text", ["data=2,model=2", "data=1,seq=2,model=2"])
def test_generate_tp_sharded_matches_replicated(text):
    params, prompt, want = _setup()
    rep, rep_logits = _replicated()
    np.testing.assert_array_equal(rep, want)
    cfg = torch_tf.Config(**KW)

    def rank(_r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(text), "cpu")
        st, _specs = state.create_sharded_state(
            lambda s: params, optim.SGD(0.1), 0, "cpu", mesh=mesh,
            rules=torch_tf.sharding_rules(cfg))
        assert st.params["head"]["kernel"].shape == (64, 211) or mesh.shape["model"] == 2
        out = torch_tf.generate(cfg, st.params, prompt, max_new_tokens=NEW, mesh=mesh)
        rows = sharding.rank_rows(4, mesh.row_index, mesh.row_shards)
        cache = torch_tf.init_cache(cfg, rows.stop - rows.start, 16, mesh=mesh)
        assert cache["block_0"]["k"].shape[1] == 4 // mesh.shape["model"]
        tok = torch.tensor(prompt[rows, 0])
        with torch.no_grad():
            logits, _c = torch_tf.decode_step(cfg, st.params, cache, tok, 0, mesh=mesh)
            cache = torch_tf.init_cache(cfg, rows.stop - rows.start, 16, mesh=mesh)
            batch, _c = torch_tf.decode_step_batch(cfg, st.params, cache, tok,
                                                   torch.zeros_like(tok), mesh=mesh)
        return out.numpy(), rows, logits.numpy(), batch.numpy()

    n = 1
    for a in text.split(","):
        n *= int(a.split("=")[1])
    for out, rows, logits, batch in collectives.ThreadRanks(n).run(rank):
        np.testing.assert_array_equal(out, want)
        np.testing.assert_allclose(logits, rep_logits[rows], rtol=0, atol=2e-4)
        np.testing.assert_allclose(batch, rep_logits[rows], rtol=0, atol=2e-4)
