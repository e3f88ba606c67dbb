"""The LM CLI pipelined over real gloo CPU ranks, and decoding sharded,
against the JAX step and ``generate`` on the same meshes (the twins of
``tests/test_multiprocess.py::test_pipeline_parallel_across_processes``,
``tests/test_examples_e2e.py::test_transformer_pipeline_parallel`` and
``::test_transformer_tp_sharded_sampling``).

Four ranks (``utils.multiprocess``), spawned once, run
``examples.transformer_lm`` (float32, ``clip_by_global_norm(1.0) +
adamw(1e-3)``, attention "xla" in JAX and plain in the port; vocab 128,
dim 32, 4 layers, 4 heads, T 32, batch 8):

- ``--pipeline_stages=2 --microbatches=2 --mesh=pipe=2,model=2`` and
  ``--mesh=data=2,pipe=2``, 3 steps each, ``--sample_tokens=8`` and a
  checkpoint: each step's loss within 1e-4 of the JAX step's on the
  same mesh, every leaf within 2e-4 (a stacked leaf each pipe rank's
  layers, a model block its columns), the checkpoint the global leaves,
  and the chief's sampled ids (the stages collapsed, decoded on its own
  device) equal to JAX ``generate`` on the collapsed JAX weights;
- ``--mesh=data=2,model=2`` unpipelined, 1 step, ``--sample_tokens=8``:
  the TP-sharded decode (each rank's heads and vocab block) samples JAX's
  ``generate`` on the same mesh on every rank.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.parallel import sharding as jax_sharding
from distributed_tensorflow_examples_tpu.parallel.mesh import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch.data import datasets
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.parallel import sharding
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

LR, CLIP, BATCH, PROMPT, SAMPLE = 1e-3, 1.0, 8, 16, 8
TOL_LOSS, TOL_LEAF = 1e-4, 2e-4
STEPS = 3
MODEL = dict(vocab_size=128, dim=32, n_layers=4, n_heads=4, seq_len=32)
#: name: (mesh, stages, steps)
RUNS = {
    "pipe_model": ({"pipe": 2, "model": 2}, 2, STEPS),
    "data_pipe": ({"data": 2, "pipe": 2}, 2, STEPS),
    "decode_model": ({"data": 2, "model": 2}, 1, 1),
}


def _args(name: str, tmp) -> list:
    mesh, stages, steps = RUNS[name]
    out = ["--device=cpu", f"--batch_size={BATCH}", f"--learning_rate={LR}",
           f"--clip_norm={CLIP}", "--seed=0", "--log_every_steps=1", "--attention=xla",
           "--mesh=" + ",".join(f"{a}={n}" for a, n in mesh.items()),
           f"--train_steps={steps}", f"--sample_tokens={SAMPLE}",
           *[f"--{k}={v}" for k, v in MODEL.items()]]
    if stages > 1:
        out += [f"--pipeline_stages={stages}", "--microbatches=2",
                f"--log_dir={tmp / name}"]
    return out


RANKS = """
import dataclasses, pickle
import torch
torch.set_num_threads(1)
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, dist
from distributed_tensorflow_examples_tpu_torch.train import hooks, runner
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

runner.MetricsWriter = lambda log_dir: MetricsWriter(log_dir, tensorboard=False)
base = cli.config_from_args
cli.config_from_args = lambda a: dataclasses.replace(base(a), compute_dtype="float32")
corpora, text_corpus = {{}}, cli.datasets.text_corpus

def corpus(*a, **k):  # one corpus for every run
    key = (a, tuple(sorted(k.items())))
    if key not in corpora:
        corpora[key] = text_corpus(*a, **k)
    return corpora[key]

cli.datasets.text_corpus = corpus

class Metrics(hooks.Hook):
    def __init__(self):
        self.seen = []
    def after_step(self, loop, metrics):
        self.seen.append(float(metrics["loss"]))

res = {{}}
for name, args in {runs!r}:
    collectives.TRAFFIC.clear()
    rec = Metrics()
    exp = cli.run_training(cli.build_parser().parse_args(args), extra_hooks=[rec])
    specs = dict(bridge._leaves(exp.specs["params"]))
    m = exp.mesh
    res[name] = dict(
        metrics=rec.seen, index=(m.data_index, m.pipe_index, m.model_index),
        leaves=[(path, tuple(specs[path]), p.detach().numpy().copy())
                for path, p in bridge._leaves(exp.state.params)],
        traffic=dict(collectives.TRAFFIC), sampled=exp.sampled)
with open({out!r} + f"/rank{{dist.process_index()}}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


@functools.lru_cache(maxsize=None)
def _corpus():
    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=MODEL["vocab_size"],
        synth_tokens=max(2_000_000, BATCH * (MODEL["seq_len"] + 1) * 50), seed=0)
    return ids


def _batches(shards: int, n: int) -> list:
    """The CLI's global batches over ``shards`` row shards, shard order."""
    its = []
    for j in range(shards):
        block, rows = sharding.stream_block(_corpus(), BATCH, j, shards)
        its.append(datasets.lm_batches(block, batch_size=rows, seq_len=MODEL["seq_len"]))
    out = []
    for _ in range(n):
        parts = [next(it) for it in its]
        out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return out


def _cfg(stages: int):
    kw = {k: v for k, v in MODEL.items() if k != "seq_len"}
    return (jax_tf.Config(**kw, max_seq_len=MODEL["seq_len"], compute_dtype="float32",
                          attention="xla", pipeline_stages=stages, microbatches=2),
            torch_tf.Config(**kw, max_seq_len=MODEL["seq_len"], pipeline_stages=stages,
                            microbatches=2))


def _jax_run(name: str):
    """Each step's loss, every leaf by path, the final state and mesh of the
    JAX step on the run's mesh over the CLI's batches, from the port's
    ``init_numpy`` (JAX ``init``'s numbers, ``test_torch_pipeline.py``)."""
    mesh_shape, stages, steps = RUNS[name]
    mesh = local_mesh_for_testing(mesh_shape)
    cfg, tcfg = _cfg(stages)
    init = jax.tree.map(jnp.asarray, torch_tf.init_numpy(tcfg, 0))
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    st, shardings = jax_state.create_sharded_state(
        lambda r: init, opt, jax.random.key(0), mesh=mesh, rules=jax_tf.sharding_rules(cfg))
    stepper = jax_step.build_train_step(jax_tf.loss_fn(cfg, mesh=mesh), opt, mesh=mesh,
                                        state_shardings=shardings,
                                        batch_spec=jax_tf.batch_spec(cfg))
    seen = []
    for b in _batches(mesh_shape.get("data", 1), steps):
        st, m = stepper(st, as_global({k: jnp.asarray(v) for k, v in b.items()}, mesh,
                                      spec=jax_tf.batch_spec(cfg)))
        seen.append(float(m["loss"]))
    flat = {jax_sharding.path_of(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(st.params))[0]}
    return seen, flat, st, mesh


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_mesh")
    runs = [(name, _args(name, tmp)) for name in RUNS]
    ranks = MultiProcessRunner(4, RANKS.format(runs=runs, out=str(tmp)), prelude=False,
                               timeout=300)
    ranks.start()
    try:
        want = {name: _jax_run(name) for name in RUNS}
    finally:
        codes = ranks.join()
    assert codes == [0] * 4, "\n".join(ranks.output(i)[-3000:] for i in range(4))
    got = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want, tmp


def _global_leaves(ranks: list, name: str) -> dict:
    """Each leaf's global array from the ranks of data index 0 (blocks
    over ``pipe`` and ``model``); every rank's block is the one it should
    hold."""
    out = {}
    for i, (path, spec, _a) in enumerate(ranks[0][name]["leaves"]):
        blocks = {r[name]["index"]: r[name]["leaves"][i][2] for r in ranks}
        pipes = sorted({idx[1] for idx in blocks})
        models = sorted({idx[2] for idx in blocks})

        def along(axis, items):
            return items[0] if axis not in spec else np.concatenate(items, spec.index(axis))

        out[path] = along("model", [along("pipe", [blocks[(0, p, m)] for p in pipes])
                                    for m in models])
        for (_d, p, m), mine in blocks.items():
            np.testing.assert_array_equal(mine, blocks[(0, p if "pipe" in spec else 0,
                                                        m if "model" in spec else 0)],
                                          err_msg=path)
    return out


@pytest.mark.parametrize("name", ["pipe_model", "data_pipe", "decode_model"])
def test_cli_on_a_pipe_mesh_matches_the_jax_step(runs, name):
    ranks, want, _tmp = runs
    w_losses, w_leaves, _st, _mesh = want[name]
    for r in ranks:
        np.testing.assert_allclose(r[name]["metrics"], w_losses, rtol=0, atol=TOL_LOSS)
    got = _global_leaves(ranks, name)
    assert got.keys() == w_leaves.keys()
    gap = max(float(np.max(np.abs(got[p] - w_leaves[p]))) for p in w_leaves)
    print(f"{name}: leaf gap {gap:.3e}")
    assert gap <= TOL_LEAF, (name, gap)
    if RUNS[name][1] > 1:
        for r in ranks:
            t = r[name]["traffic"]
            assert t["pipe_calls"] and t["pipe_out_calls"] and t["pipe_in_calls"], t
            qkv = dict((p, a) for p, _s, a in r[name]["leaves"])["blocks/qkv/kernel"]
            assert qkv.shape[0] == 2  # 4 layers over pipe=2
        ckpt = sorted((_tmp / name / "ckpt").iterdir())[-1] / "state.pt"
        saved = torch.load(ckpt, weights_only=True)["params"]
        for path, w in got.items():
            np.testing.assert_array_equal(saved[path].numpy(), w, err_msg=path)


@pytest.mark.parametrize("name", ["pipe_model", "data_pipe"])
def test_cli_samples_the_collapsed_stages_as_jax_generate(runs, name):
    ranks, want, _tmp = runs
    _l, _leaves, st, _mesh = want[name]
    cfg, _tcfg = _cfg(2)
    dcfg, dparams = jax_tf.collapse_pipeline(cfg, jax.device_get(st.params))
    prompt = np.asarray(_corpus()[:PROMPT], np.int32)[None]
    out = np.asarray(jax_tf.generate(dcfg, dparams, prompt, max_new_tokens=SAMPLE))
    chief, *others = ranks
    assert chief[name]["sampled"] == out[0, PROMPT:].tolist()
    assert all(r[name]["sampled"] is None for r in others)


def test_cli_samples_tp_sharded_as_jax_generate(runs):
    ranks, want, _tmp = runs
    _l, _leaves, st, mesh = want["decode_model"]
    cfg, _tcfg = _cfg(1)
    prompt = np.tile(np.asarray(_corpus()[:PROMPT], np.int32)[None], (2, 1))
    out = np.asarray(jax_tf.generate(cfg, st.params, prompt, max_new_tokens=SAMPLE, mesh=mesh))
    for r in ranks:
        assert r["decode_model"]["sampled"] == out[0, PROMPT:].tolist()
        assert r["decode_model"]["traffic"].get("decode_calls", 0) > 0
