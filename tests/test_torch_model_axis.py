"""The port's ``model`` mesh axis: the rule table, the vocab-parallel
tables of W4 (word2vec) and W5 (PTB LSTM), and checkpoints that move
between mesh shapes, against the JAX package.

- The rule table (``parallel/sharding.py``), ``_clamp_spec`` and the
  partitioners against the JAX functions on the same paths and shapes,
  and each model's ``SHARDING_RULES`` against its JAX table.
- The two operators of a vocab-parallel layer on simulated ranks
  (``collectives.ThreadRanks``): ``copy_to_model`` sums the gradient over
  ``model``, ``reduce_from_model`` sums the value; a row-sharded lookup
  gives the replicated rows, its NaN rows once, and each block's own
  gradient.
- The CLIs on real gloo CPU ranks (``utils.multiprocess``) at
  ``--mesh=data=1,model=2`` (2 ranks) and ``data=2,model=2`` (4 ranks),
  float32, against the JAX step on ``local_mesh_for_testing`` of the same
  shape with the JAX ``SHARDING_RULES``: W4 (vocab 512, dim 32, 16
  negatives, as ``tests/test_models.py``) 5 steps, the losses, every leaf
  (the ranks' blocks put together) and the negatives id for id; W5
  (vocab 64, width 16, 2 layers, batch 8 x 5, clip 0.05 so that the clip
  engages) 5 steps, the losses and every leaf.
- A W4 checkpoint saved at ``model=2`` resumes at ``model=1``, and one
  saved at ``model=1`` resumes at ``model=2``; both end where the JAX
  steps over the same batches end.

Tolerances (float32): losses within 1e-5 absolute, leaves within 1e-5
absolute.  The sharded logits sum one owner's value with zeros, which is
exact, so the port's sharded step is its replicated step to the bit;
what remains is the JAX step's own float32 summation order (XLA's
scatter-add of repeated ids, its dot products) and the nce weights'
few-ulp initial draw (``init_numpy``), the 1e-5 of the data-parallel
tests.
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributed_tensorflow_examples_tpu.models import lstm as jax_lstm
from distributed_tensorflow_examples_tpu.models import word2vec as jax_w2v
from distributed_tensorflow_examples_tpu.parallel import partitioner as jax_part
from distributed_tensorflow_examples_tpu.parallel import sharding as jax_sharding
from distributed_tensorflow_examples_tpu.parallel.mesh import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import datasets
from distributed_tensorflow_examples_tpu_torch.examples import word2vec as w2v_cli
from distributed_tensorflow_examples_tpu_torch.models import layers, lstm, word2vec
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, partitioner
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.parallel import sharding
from distributed_tensorflow_examples_tpu_torch.train import hooks
from distributed_tensorflow_examples_tpu_torch.train import runner as runner_lib
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

W2V = dict(vocab_size=512, dim=32, num_sampled=16)
W2V_ARGS = ["--device=cpu", "--vocab_size=512", "--embedding_dim=32", "--num_sampled=16",
            "--batch_size=64", "--learning_rate=0.5", "--seed=0", "--log_every_steps=1"]
LSTM = dict(vocab_size=64, dim=16, num_layers=2)
LSTM_ARGS = ["--device=cpu", "--vocab_size=64", "--hidden_dim=16", "--num_layers=2",
             "--batch_size=8", "--seq_len=5", "--learning_rate=1.0", "--clip_norm=0.05",
             "--seed=1", "--log_every_steps=1", "--train_steps=5"]
STEPS = 5
TOL = 1e-5

RULES = (
    ("embedding/table", partitioner.P("model", None)),
    (r"dense_\d+/kernel", partitioner.P(None, "model")),
)
JAX_RULES = tuple((r, PartitionSpec(*s)) for r, s in RULES)


# ----------------------------------------------------------------------------
# The rule table and the partitioners
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["embedding/table", "dense_0/kernel", "dense_0/bias",
                                  "0/mu/dense_0/kernel", "params/embedding/table", "x"])
def test_rule_lookup_matches_jax(path):
    assert tuple(sharding.spec_for_path(path, RULES)) == tuple(
        jax_sharding.spec_for_path(path, JAX_RULES))
    ours, theirs = sharding.match_rule(path, RULES), jax_sharding.match_rule(path, JAX_RULES)
    assert (ours is None) == (theirs is None)
    assert ours is None or tuple(ours) == tuple(theirs)


@pytest.mark.parametrize("sizes", [{"data": 4, "model": 2}, {"data": 1, "model": 2},
                                   {"data": 2, "model": 4}, {"data": 8}])
@pytest.mark.parametrize("spec,shape", [
    (("model", None), (16, 8)), (("model", None), (7, 8)), ((None, "model"), (8, 6)),
    (("model",), (10,)), (("data", "model"), (8, 4)), ((("data", "model"),), (16,)),
    (("model", None, None), (4, 4)), ((), (3,))])
def test_clamp_spec_matches_jax(sizes, spec, shape):
    mesh = local_mesh_for_testing(sizes)
    want = jax_sharding._clamp_spec(PartitionSpec(*spec), len(shape), shape, mesh)
    got = sharding._clamp_spec(partitioner.P(*spec), len(shape), shape, sizes)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_fixed_size_partitioner_matches_jax(dim):
    assert tuple(partitioner.fixed_size_partitioner("model", dim)) == tuple(
        jax_part.fixed_size_partitioner("model", dim))


@pytest.mark.parametrize("shape,nbytes,axis", [
    ((), 4, 2), ((10000, 128), 4, 2), ((128,), 4, 2), ((1024, 256), 2, 4), ((512, 512), 4, 1)])
def test_min_max_partitioner_matches_jax(shape, nbytes, axis):
    ours = partitioner.min_max_variable_partitioner(256 << 10)
    theirs = jax_part.min_max_variable_partitioner(256 << 10)
    assert tuple(ours(shape, nbytes, axis)) == tuple(theirs(shape, nbytes, axis))


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 2}, {"data": 4, "model": 2},
                                   {"data": 8}])
@pytest.mark.parametrize("model", ["word2vec", "lstm"])
def test_model_rule_tables_match_jax(model, sizes):
    """Each model's ``SHARDING_RULES`` give every param leaf the spec JAX's
    give it (``sharding_tree`` over the JAX init's shapes)."""
    mesh = local_mesh_for_testing(sizes)
    if model == "word2vec":
        cfg = jax_w2v.Config(**W2V)
        params = jax.eval_shape(lambda: jax_w2v.init(cfg, jax.random.key(0)))
        ours, theirs = word2vec.SHARDING_RULES, jax_w2v.SHARDING_RULES
    else:
        cfg = jax_lstm.Config(**LSTM)
        params = jax.eval_shape(lambda: jax_lstm.init(cfg, jax.random.key(0), batch_size=8)[0])
        ours, theirs = lstm.SHARDING_RULES, jax_lstm.SHARDING_RULES
    want = jax.tree.map(lambda s: tuple(s.spec), jax_sharding.sharding_tree(params, mesh, theirs))
    shapes = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    got = sharding.sharding_tree(shapes, sizes, ours)
    assert jax.tree.map(tuple, got, is_leaf=lambda x: isinstance(x, tuple)) == want
    assert [a for a, _b in ours] == [a for a, _b in theirs]
    assert [tuple(b) for _a, b in ours] == [tuple(b) for _a, b in theirs]


def test_shard_pytree_takes_each_ranks_block():
    tree = {"embedding": {"table": np.arange(32.0).reshape(16, 2)},
            "dense_0": {"kernel": np.arange(24.0).reshape(4, 6), "bias": np.ones(6)}}

    def rank(r):
        m = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2,model=2"), "cpu")
        return m.data_index, m.model_index, sharding.shard_pytree(tree, m, RULES)

    for d, mi, local in collectives.ThreadRanks(4).run(rank):
        np.testing.assert_array_equal(local["embedding"]["table"],
                                      tree["embedding"]["table"][8 * mi:8 * (mi + 1)])
        np.testing.assert_array_equal(local["dense_0"]["kernel"],
                                      tree["dense_0"]["kernel"][:, 3 * mi:3 * (mi + 1)])
        np.testing.assert_array_equal(local["dense_0"]["bias"], tree["dense_0"]["bias"])
        assert d in (0, 1)


# ----------------------------------------------------------------------------
# The vocab-parallel operators on simulated ranks
# ----------------------------------------------------------------------------


def _model_mesh():
    return mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("model=2"), "cpu")


def test_copy_and_reduce_over_model_have_the_vocab_parallel_gradients():
    """copy_to_model: identity forward, gradient summed over model;
    reduce_from_model: sum forward, identity backward.  psum would sum
    both ways, and scale a replicated loss's gradient by M."""

    def rank(r):
        with _model_mesh().axes():
            x = torch.full((3,), float(r + 1), requires_grad=True)
            y = collectives.copy_to_model(x)
            (y * (r + 1)).sum().backward()
            a = torch.full((2,), float(r + 1), requires_grad=True)
            s = collectives.reduce_from_model(a)
            (s * 5).sum().backward()
            p = torch.full((2,), float(r + 1), requires_grad=True)
            (collectives.psum(p, "model") * 5).sum().backward()
        return y.detach(), x.grad, s.detach(), a.grad, p.grad

    for r, (y, xg, s, ag, pg) in enumerate(collectives.ThreadRanks(2).run(rank)):
        assert torch.equal(y, torch.full((3,), float(r + 1)))
        assert torch.equal(xg, torch.full((3,), 3.0))  # 1 + 2, the ranks' cotangents
        assert torch.equal(s, torch.full((2,), 3.0))
        assert torch.equal(ag, torch.full((2,), 5.0))  # not 10: the loss is replicated
        assert torch.equal(pg, torch.full((2,), 10.0))
    with pytest.raises(NotImplementedError, match="A8b-2"):
        collectives.axis_size("pipe")


def test_row_sharded_lookup_matches_the_table_and_fills_nan_once():
    table = torch.arange(40.0).reshape(10, 4)
    ids = torch.tensor([[0, 9, 4], [5, -1, 12]])

    def rank(r):
        m = _model_mesh()
        block = table[5 * m.model_index:5 * (m.model_index + 1)].clone().requires_grad_(True)
        with m.axes():
            rows = layers.embedding_lookup({"table": block}, ids, vocab_size=10)
            rows.nan_to_num(0.0).sum().backward()
        return rows.detach(), block.grad

    want = layers.embedding_lookup({"table": table}, ids)
    grads = []
    for rows, grad in collectives.ThreadRanks(2).run(rank):
        torch.testing.assert_close(rows, want, rtol=0, atol=0, equal_nan=True)
        assert torch.isnan(rows[1, 2]).all() and not torch.isnan(rows[0]).any()
        grads.append(grad)
    count = torch.zeros(10)
    for i in (0, 9, 4, 5, 9):  # -1 is row 9; 12 is out of range (no gradient)
        count[i] += 1
    torch.testing.assert_close(torch.cat(grads), count[:, None].expand(10, 4))


def test_whole_tables_under_a_model_mesh_issue_no_collective():
    """A table a rule left whole (or a 1-rank reference step beside the
    model ranks) reads no model group, under the model mesh's axes too:
    only rank 0 runs W4's and W5's losses here, and a collective would
    leave it waiting for rank 1."""
    wcfg = word2vec.Config(**W2V)
    lcfg = lstm.Config(**LSTM, compute_dtype="float32")
    wparams = {k: {n: torch.from_numpy(a) for n, a in v.items()}
               for k, v in word2vec.init_numpy(wcfg, 0).items()}
    lparams, carry = lstm.init_numpy(lcfg, 1, batch_size=2)
    lparams = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in lparams.items()}
    carry = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in carry.items()}
    ids = torch.arange(8, dtype=torch.int32)
    key = (0, 5)

    def rank(r):
        with _model_mesh().axes():
            if r == 0:
                w = word2vec.loss_fn(wcfg)(wparams, {}, {"center": ids, "context": ids + 1},
                                           key)
                x = ids[:6].reshape(2, 3)
                return w[0], lstm.loss_fn(lcfg)(lparams, carry, {"x": x, "y": x}, None)[0]
        return None

    w_loss, l_loss = collectives.ThreadRanks(2, timeout=10).run(rank)[0]
    assert torch.equal(w_loss, word2vec.loss_fn(wcfg)(wparams, {}, {"center": ids,
                                                                    "context": ids + 1}, key)[0])
    x = ids[:6].reshape(2, 3)
    assert torch.equal(l_loss, lstm.loss_fn(lcfg)(lparams, carry, {"x": x, "y": x}, None)[0])


def test_vocab_parallel_cross_entropy_matches_the_whole_softmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32) * 4)
    labels = torch.tensor([0, 7, 3, 4, 1, 6])
    full = logits.clone().requires_grad_(True)
    want = layers.softmax_cross_entropy(full, labels)
    want.backward()

    def rank(r):
        m = _model_mesh()
        block = logits[:, 4 * m.model_index:4 * (m.model_index + 1)].clone().requires_grad_(True)
        with m.axes():
            loss = layers.vocab_parallel_cross_entropy(block, labels)
            loss.backward()
        return loss.detach(), block.grad

    out = collectives.ThreadRanks(2).run(rank)
    for loss, _g in out:
        torch.testing.assert_close(loss, want.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([g for _l, g in out], dim=1), full.grad,
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------------------
# W4 and W5 on real gloo ranks against the JAX step on the model mesh
# ----------------------------------------------------------------------------

RANKS = """
import functools, pickle
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm, word2vec as w2v_cli
from distributed_tensorflow_examples_tpu_torch.models import lstm, word2vec
from distributed_tensorflow_examples_tpu_torch.parallel import collectives
from distributed_tensorflow_examples_tpu_torch.train import hooks, runner
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter
from distributed_tensorflow_examples_tpu_torch import bridge

# The chief's --log_dir runs write no TensorBoard events (its import alone
# costs a process ~14 s); the checkpoints are what the runs compare.
runner.MetricsWriter = lambda log_dir: MetricsWriter(log_dir, tensorboard=False)

class Losses(hooks.Hook):
    def __init__(self):
        self.losses = []
    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))

def leaves(exp):
    specs = dict(bridge._leaves(exp.specs["params"]))
    return [(path, tuple(specs[path]), p.detach().numpy().copy())
            for path, p in bridge._leaves(exp.state.params)]

rank = dist.process_index()
res = {{}}
negatives = []
draw = word2vec.log_uniform_sample
def recording(rng, n, v, device="cpu"):
    ids = draw(rng, n, v, device)
    negatives.append(ids.numpy().copy())
    return ids
word2vec.log_uniform_sample = recording

mesh = {mesh!r}
rec = Losses()
exp = w2v_cli.run_training(w2v_cli.build_parser().parse_args(
    {w2v_args!r} + ["--train_steps={steps}", "--mesh=" + mesh]), extra_hooks=[rec])
res["w2v"] = dict(losses=rec.losses, leaves=leaves(exp), negatives=negatives[:{steps}],
                  data=exp.mesh.data_index, model=exp.mesh.model_index,
                  model_fwd=collectives.TRAFFIC["model_fwd_calls"],
                  model_bwd=collectives.TRAFFIC["model_bwd_calls"])

ptb_lstm.config_from_args = lambda a: lstm.Config(
    vocab_size=a.vocab_size, dim=a.hidden_dim, num_layers=a.num_layers, compute_dtype="float32")
rec = Losses()
exp = ptb_lstm.run_training(ptb_lstm.build_parser().parse_args({lstm_args!r} + ["--mesh=" + mesh]),
                            extra_hooks=[rec])
res["lstm"] = dict(losses=rec.losses, leaves=leaves(exp),
                   clip=collectives.TRAFFIC["model_clip_calls"])

for extra, key in {resume!r}:
    rec = Losses()
    exp = w2v_cli.run_training(w2v_cli.build_parser().parse_args(
        {w2v_args!r} + ["--mesh=" + mesh] + extra), extra_hooks=[rec])
    res[key] = dict(losses=rec.losses, leaves=leaves(exp),
                    resumed=exp.session.records.get("resumed_at"))
with open({out!r} + f"/rank{{rank}}.pkl", "wb") as f:
    pickle.dump(res, f)
print("RANK DONE", rank, flush=True)
"""


def _jax_steps(mesh, init_fn, loss_fn, opt, batches, seed, rules, state=None):
    """Losses, final param leaves (by path) and the (state, shardings) of
    the JAX step on ``mesh`` over global batches (from ``state``, a pair,
    when given)."""
    state, shardings = state or jax_state.create_sharded_state(
        init_fn, opt, jax.random.key(seed), mesh=mesh, rules=rules)
    stepper = jax_step.build_train_step(loss_fn, opt, mesh=mesh, state_shardings=shardings)
    spec = NamedSharding(mesh, PartitionSpec("data"))
    losses = []
    for b in batches:
        state, m = stepper(state, {k: jax.device_put(jnp.asarray(v), spec)
                                   for k, v in b.items()})
        losses.append(float(m["loss"]))
    params = jax.device_get(state.params)
    flat = {jax_sharding.path_of(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    return losses, flat, (state, shardings)


def _global_leaves(ranks, key, data_index=0):
    """Each leaf's global array from the ranks of ``data_index``: the
    model blocks of a sharded leaf concatenated in model order."""
    by_model = sorted([r for r in ranks if r["w2v"]["data"] == data_index],
                      key=lambda r: r["w2v"]["model"])
    out = {}
    for i, (path, spec, _a) in enumerate(by_model[0][key]["leaves"]):
        blocks = [r[key]["leaves"][i][2] for r in by_model]
        dim = spec.index("model") if "model" in spec else None
        out[path] = blocks[0] if dim is None else np.concatenate(blocks, axis=dim)
        if dim is not None:  # every row on exactly one model rank
            assert all(b.shape[dim] * len(blocks) == out[path].shape[dim] for b in blocks)
        else:
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0])  # replicated, bit for bit
    return out


def _w2v_batches(data, steps, local):
    ids, _vocab, _src = datasets.text_corpus(None, vocab_size=512, seed=0)
    streams = [datasets.skipgram_batches(ids, batch_size=local, window=5, seed=d)
               for d in range(data)]
    return [{k: np.concatenate([s[k] for s in step]) for k in step[0]}
            for step in zip(*([next(it) for _ in range(steps)] for it in streams))]


def _lstm_batches(data, steps):
    train_ids, _valid, _vocab, _src = datasets.ptb(None, vocab_size=64, seed=1)
    block = len(train_ids) // data
    its = [datasets.lm_batches(train_ids[d * block:(d + 1) * block], batch_size=8 // data,
                               seq_len=5) for d in range(data)]
    return [{k: np.concatenate([s[k] for s in step]) for k in step[0]}
            for step in zip(*([next(it) for _ in range(steps)] for it in its))]


def _check_leaves(got: dict, want: dict):
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=TOL, err_msg=path)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_w4_and_w5_on_gloo_ranks_match_the_jax_model_mesh(data, model, tmp_path, monkeypatch):
    monkeypatch.setattr(runner_lib, "MetricsWriter",
                        lambda log_dir: MetricsWriter(log_dir, tensorboard=False))
    out, n = str(tmp_path), data * model
    mesh_text = f"data={data},model={model}"
    resume = []
    if data == 1:
        # Saved at model=1 here, resumed at model=2 by the ranks; saved at
        # model=2 by the ranks, resumed at model=1 here.
        one = tmp_path / "from_model1"
        assert w2v_cli.main([*W2V_ARGS, "--train_steps=3", f"--log_dir={one}"]) == 0
        resume = [([f"--log_dir={one}", f"--train_steps={STEPS}"], "resumed_at_2"),
                  ([f"--log_dir={tmp_path / 'from_model2'}", "--train_steps=3"], "saved_at_2")]
    runner = MultiProcessRunner(n, RANKS.format(
        mesh=mesh_text, w2v_args=W2V_ARGS, steps=STEPS, lstm_args=LSTM_ARGS, resume=resume,
        out=out), timeout=240)
    runner.start()
    try:
        jmesh = local_mesh_for_testing({"data": data, "model": model})
        wcfg = jax_w2v.Config(**W2V)
        w_batches = _w2v_batches(data, STEPS, 64 // data)
        w_losses, w_params, _st = _jax_steps(
            jmesh, lambda k: jax_w2v.init(wcfg, k), jax_w2v.loss_fn(wcfg), optax.sgd(0.5),
            w_batches, 0, jax_w2v.SHARDING_RULES)
        w_negs = [np.asarray(jax_w2v.log_uniform_sample(
            jax.random.fold_in(jax.random.key(0), s), 16, 512)) for s in range(STEPS)]
        lcfg = jax_lstm.Config(**LSTM, compute_dtype="float32")
        l_losses, l_params, _st = _jax_steps(
            jmesh, lambda k: jax_lstm.init(lcfg, k, batch_size=8), jax_lstm.loss_fn(lcfg),
            optax.chain(optax.clip_by_global_norm(0.05), optax.sgd(1.0)),
            _lstm_batches(data, STEPS), 1, jax_lstm.SHARDING_RULES)
        if data == 1:
            # The resume: steps 1-3 on batches 1-3, then (data restarts on a
            # resume) steps 4-5 on batches 1-2.
            _l, _p, st3 = _jax_steps(jmesh, lambda k: jax_w2v.init(wcfg, k),
                                     jax_w2v.loss_fn(wcfg), optax.sgd(0.5), w_batches[:3],
                                     0, jax_w2v.SHARDING_RULES)
            r_losses, r_params, _st = _jax_steps(
                jmesh, None, jax_w2v.loss_fn(wcfg), optax.sgd(0.5), w_batches[:2], 0, (),
                state=st3)
    finally:
        codes = runner.join()
    outs = [runner.output(i) for i in range(n)]
    assert codes == [0] * n, "\n".join(outs)
    ranks = []
    for r in range(n):
        with open(f"{out}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    runner.cleanup()

    # Only the chief prints FINAL; rank r sits at data r // M, model r % M.
    assert re.search(r"^FINAL step=5 .* eval_loss=", outs[0], re.M), outs[0]
    assert all("FINAL" not in o for o in outs[1:])
    assert [(r["w2v"]["data"], r["w2v"]["model"]) for r in ranks] == [
        divmod(i, model) for i in range(n)]
    for res in ranks:
        assert res["w2v"]["model_fwd"] > 0 and res["w2v"]["model_bwd"] > 0
        assert res["lstm"]["clip"] > 0  # the clip's norm summed over model
        np.testing.assert_allclose(res["w2v"]["losses"], w_losses, rtol=0, atol=TOL)
        np.testing.assert_allclose(res["lstm"]["losses"], l_losses, rtol=0, atol=TOL)
        for got, want in zip(res["w2v"]["negatives"], w_negs, strict=True):
            np.testing.assert_array_equal(got, want)
    for d in range(data):
        _check_leaves(_global_leaves(ranks, "w2v", d), w_params)
        _check_leaves(_global_leaves(ranks, "lstm", d), l_params)
    table = {p: spec for p, spec, _a in ranks[0]["w2v"]["leaves"]}
    assert table == {"emb/table": ("model", None), "nce/bias": ("model",),
                     "nce/weights": ("model", None)}
    assert ranks[0]["w2v"]["leaves"][0][2].shape == (512 // model, 32)

    if data == 1:
        # model=1 -> model=2: the ranks resumed the chief-saved global arrays.
        assert all(r["resumed_at_2"]["resumed"] == 3 for r in ranks)
        assert all(r["resumed_at_2"]["losses"] == ranks[0]["resumed_at_2"]["losses"]
                   for r in ranks)
        np.testing.assert_allclose(ranks[0]["resumed_at_2"]["losses"], r_losses,
                                   rtol=0, atol=TOL)
        _check_leaves(_global_leaves(ranks, "resumed_at_2"), r_params)
        # model=2 -> model=1: this process resumes what the ranks saved.
        rec = _Losses()
        exp = w2v_cli.run_training(w2v_cli.build_parser().parse_args(
            [*W2V_ARGS, f"--log_dir={tmp_path / 'from_model2'}", f"--train_steps={STEPS}"]),
            extra_hooks=[rec])
        assert exp.session.records.get("resumed_at") == 3
        np.testing.assert_allclose(rec.losses, r_losses, rtol=0, atol=TOL)
        _check_leaves({p: t.detach().numpy() for p, t in bridge._leaves(exp.state.params)},
                      r_params)


class _Losses(hooks.Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))


def test_similarity_on_a_sharded_table_matches_jax():
    cfg = jax_w2v.Config(**W2V)
    params = jax.device_get(jax_w2v.init(cfg, jax.random.key(3)))
    q = np.array([0, 7, 300, 511], np.int32)
    want = np.asarray(jax_w2v.similarity(cfg, params, jnp.asarray(q)))
    pcfg = word2vec.Config(**W2V)

    def rank(r):
        m = _model_mesh()
        table = np.asarray(params["emb"]["table"])[256 * m.model_index:256 * (m.model_index + 1)]
        with m.axes():
            return word2vec.similarity(pcfg, {"emb": {"table": torch.from_numpy(table.copy())}},
                                       torch.from_numpy(q))

    for got in collectives.ThreadRanks(2).run(rank):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
