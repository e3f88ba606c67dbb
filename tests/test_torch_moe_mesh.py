"""The MoE transformer CLI on ``expert`` meshes of real gloo CPU ranks
against the JAX step on the same meshes.

Four ranks (``utils.multiprocess``), spawned once, run
``examples.transformer_lm --moe_experts=4`` (float32, ``clip_by_global_norm
(1.0) + adamw(1e-3)``, attention "xla" in JAX and the plain versions in the
port):

- ``--mesh=data=2,expert=2`` (vocab 128, dim 32, 2 layers, 4 heads, T 32,
  batch 8: each rank routes its own groups and trades tokens with its
  expert peer by all-to-all) for 3 steps with ``--sample_tokens=8`` and a
  checkpoint;
- MoE with the ring (``data=1,expert=2,seq=2``), with Ulysses (the same
  mesh, ``--attention=ulysses``) and with Megatron TP
  (``data=1,expert=2,model=2``) at ``tests/test_moe.py``'s :156/:292
  shape (vocab 256, dim 64, 2 layers, 4 heads, T 64, batch 8: a routing
  group of 256 tokens straddles both sequence halves, so the ranks gather
  the tokens), one step each.

The JAX step runs on ``local_mesh_for_testing`` over the port's global
batches (each row shard's block of the corpus, data major): on
``data=2,expert=2`` for the first run, and once on
``data=1,expert=2,seq=2`` (XLA attention) for the three composed runs,
whose global step is one function (the same 2 row shards, so the same
routing groups) that the meshes only lay out.  Gates: each step's loss within 1e-4 absolute and ``moe_aux``
within 1e-5, every leaf within 2e-4 (a rank's experts its block,
replicated leaves equal on every rank); the sampled ids equal JAX
``generate``'s on that mesh (the prompt tiled data x expert times, as
the JAX CLI tiles it); the 4 ranks' checkpoint resumes at one rank for
steps 4-5 and ends where the JAX steps from the JAX state at step 3 end.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.parallel import sharding as jax_sharding
from distributed_tensorflow_examples_tpu.parallel.mesh import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import datasets
from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.parallel import sharding
from distributed_tensorflow_examples_tpu_torch.train import hooks, runner
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

LR, CLIP, BATCH, PROMPT, SAMPLE = 1e-3, 1.0, 8, 16, 8
TOL_LOSS, TOL_AUX, TOL_LEAF = 1e-4, 1e-5, 2e-4
STEPS, RESUMED_TO = 3, 5
SMALL = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, seq_len=32)
WIDE = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, seq_len=64)
#: name: (model, mesh, --attention, steps)
RUNS = {
    "data_expert": (SMALL, {"data": 2, "expert": 2}, "auto", STEPS),
    "ring": (WIDE, {"data": 1, "expert": 2, "seq": 2}, "auto", 1),
    "ulysses": (WIDE, {"data": 1, "expert": 2, "seq": 2}, "ulysses", 1),
    "model": (WIDE, {"data": 1, "expert": 2, "model": 2}, "auto", 1),
}


def _args(model: dict, extra=()) -> list:
    return (["--device=cpu", "--moe_experts=4", f"--batch_size={BATCH}",
             f"--learning_rate={LR}", f"--clip_norm={CLIP}", "--seed=0",
             "--log_every_steps=1"]
            + [f"--{k}={v}" for k, v in model.items()] + list(extra))


def _mesh_arg(mesh: dict) -> str:
    return "--mesh=" + ",".join(f"{a}={n}" for a, n in mesh.items())


def _rank_runs(tmp_path) -> list:
    runs = []
    for name, (model, mesh, att, steps) in RUNS.items():
        extra = [_mesh_arg(mesh), f"--train_steps={steps}", f"--attention={att}"]
        if name == "data_expert":
            extra += [f"--sample_tokens={SAMPLE}", f"--log_dir={tmp_path / 'ckpt'}"]
        runs.append((name, _args(model, extra)))
    return runs


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
generate, sampled = cli.transformer.generate, []

def recorded(*a, **k):
    out = generate(*a, **k)
    sampled.append(out.tolist())
    return out

cli.transformer.generate = recorded
corpora, text_corpus = {{}}, cli.datasets.text_corpus

def corpus(*a, **k):  # SMALL and WIDE runs each build theirs once
    key = (a, tuple(sorted(k.items())))
    if key not in corpora:
        corpora[key] = text_corpus(*a, **k)
    return corpora[key]

cli.datasets.text_corpus = corpus

class Metrics(hooks.Hook):
    def __init__(self):
        self.seen = []
    def after_step(self, loop, metrics):
        self.seen.append((float(metrics["loss"]), float(metrics["moe_aux"])))

res = {{}}
for name, args in {runs!r}:
    collectives.TRAFFIC.clear()
    sampled.clear()
    rec = Metrics()
    exp = cli.run_training(cli.build_parser().parse_args(args), extra_hooks=[rec])
    specs = dict(bridge._leaves(exp.specs["params"]))
    m = exp.mesh
    res[name] = dict(
        metrics=rec.seen, index=(m.data_index, m.expert_index, m.seq_index, m.model_index),
        leaves=[(path, tuple(specs[path]), p.detach().numpy().copy())
                for path, p in bridge._leaves(exp.state.params)],
        traffic=dict(collectives.TRAFFIC), sampled=list(sampled))
with open({out!r} + f"/rank{{dist.process_index()}}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


@functools.lru_cache(maxsize=None)
def _corpus_of(vocab_size: int, seq_len: int):
    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=vocab_size, synth_tokens=max(2_000_000, BATCH * (seq_len + 1) * 50),
        seed=0)
    return ids


def _corpus(model: dict):
    return _corpus_of(model["vocab_size"], model["seq_len"])


def _batches(model: dict, shards: int, n: int) -> list:
    """The port CLI's global batches over ``shards`` row shards: each
    shard's block of the corpus (``sharding.stream_block``), its rows in
    shard order."""
    ids = _corpus(model)
    its = []
    for j in range(shards):
        block, rows = sharding.stream_block(ids, BATCH, j, shards)
        its.append(datasets.lm_batches(block, batch_size=rows, seq_len=model["seq_len"]))
    out = []
    for _ in range(n):
        parts = [next(it) for it in its]
        out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return out


def _jax_cfg(model: dict, attention: str):
    m = dict(model)
    return jax_tf.Config(**{k: v for k, v in m.items() if k != "seq_len"},
                         max_seq_len=m["seq_len"], compute_dtype="float32",
                         attention=attention, moe_experts=4)


@functools.lru_cache(maxsize=None)
def _init(model_items: tuple):
    """The port's ``init_numpy`` for ``model`` (JAX ``init``'s numbers,
    ``test_torch_moe.py``), as JAX arrays: the JAX runs start where the
    ranks start."""
    model = dict(model_items)
    cfg = torch_tf.Config(**{k: v for k, v in model.items() if k != "seq_len"},
                          max_seq_len=model["seq_len"], moe_experts=4)
    return jax.tree.map(jnp.asarray, torch_tf.init_numpy(cfg, 0))


def _jax_run(cfg, mesh_shape: dict, batches: list, state=None):
    """Each step's (loss, moe_aux), every leaf by path and (state,
    stepper, mesh) of the JAX step on the mesh over ``batches``."""
    mesh = local_mesh_for_testing(mesh_shape)
    spec = jax_tf.batch_spec(cfg)
    if state is None:
        model = {k: getattr(cfg, k) for k in ("vocab_size", "dim", "n_layers", "n_heads")}
        init = _init(tuple(sorted({**model, "seq_len": cfg.max_seq_len}.items())))
        opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
        st, shardings = jax_state.create_sharded_state(
            lambda r: init, opt, jax.random.key(0), mesh=mesh,
            rules=jax_tf.sharding_rules(cfg))
        stepper = jax_step.build_train_step(
            jax_tf.loss_fn(cfg, mesh=mesh), opt, mesh=mesh, state_shardings=shardings,
            batch_spec=spec)
    else:
        st, stepper, mesh = state
    seen = []
    for b in batches:
        st, m = stepper(st, as_global({k: jnp.asarray(v) for k, v in b.items()}, mesh,
                                      spec=spec))
        seen.append((float(m["loss"]), float(m["moe_aux"])))
    flat = {jax_sharding.path_of(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(st.params))[0]}
    return seen, flat, (st, stepper, mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results by run, beside the JAX runs', and the
    checkpoint directory."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    ranks = MultiProcessRunner(4, RANKS.format(runs=_rank_runs(tmp), out=str(tmp)),
                               prelude=False, timeout=300)
    ranks.start()
    try:
        want = {"data_expert": _jax_run(_jax_cfg(SMALL, "xla"), RUNS["data_expert"][1],
                                        _batches(SMALL, 4, STEPS))}
        want["ring"] = want["ulysses"] = want["model"] = _jax_run(
            _jax_cfg(WIDE, "xla"), RUNS["ring"][1], _batches(WIDE, 2, 1))
    finally:
        codes = ranks.join()
    assert codes == [0] * 4, "\n".join(ranks.output(i)[-3000:] for i in range(4))
    got = []
    for i in range(4):
        with open(tmp / f"rank{i}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want, tmp / "ckpt"


def _global_leaves(ranks: list, name: str) -> dict:
    """Each leaf's global array from the ranks of data, seq and model
    index 0 (blocks over ``expert``) and then over ``model``; every rank's
    block equal to the one it should hold."""
    out = {}
    for i, (path, spec, _a) in enumerate(ranks[0][name]["leaves"]):
        blocks = {r[name]["index"]: r[name]["leaves"][i][2] for r in ranks}
        experts = sorted({idx[1] for idx in blocks})
        models = sorted({idx[3] for idx in blocks})

        def at(x, m):
            return blocks[(0, x, 0, m)]

        def along(axis, items):
            return items[0] if axis not in spec else np.concatenate(items, spec.index(axis))

        out[path] = along("model", [along("expert", [at(x, m) for x in experts])
                                    for m in models])
        for (_d, x, _s, m), mine in blocks.items():
            np.testing.assert_array_equal(mine, at(x if "expert" in spec else 0,
                                                   m if "model" in spec else 0), err_msg=path)
    return out


def _check(ranks: list, want, name: str) -> tuple[float, float]:
    w_metrics, w_leaves, _st = want[name]
    for r in ranks:
        got = np.asarray(r[name]["metrics"])
        np.testing.assert_allclose(got[:, 0], [m[0] for m in w_metrics], rtol=0, atol=TOL_LOSS)
        np.testing.assert_allclose(got[:, 1], [m[1] for m in w_metrics], rtol=0, atol=TOL_AUX)
    got = _global_leaves(ranks, name)
    assert got.keys() == w_leaves.keys()
    gap = max(float(np.max(np.abs(got[p] - w_leaves[p]))) for p in w_leaves)
    loss_gap = max(abs(a[0] - b[0]) for a, b in zip(ranks[0][name]["metrics"], w_metrics))
    print(f"{name}: loss gap {loss_gap:.3e}, leaf gap {gap:.3e}")
    assert gap <= TOL_LEAF, (name, gap)
    return loss_gap, gap


def test_cli_on_a_data_expert_mesh_matches_the_jax_step(runs):
    ranks, want, _ckpt = runs
    _check(ranks, want, "data_expert")
    for r in ranks:
        traffic = r["data_expert"]["traffic"]
        assert traffic.get("expert_a2a_calls", 0) > 0 and traffic.get("expert_grads_calls", 0)
        assert not traffic.get("expert_gather_calls"), traffic  # whole groups route here
        w1 = dict((p, a) for p, _s, a in r["data_expert"]["leaves"])["block_0/moe/w1"]
        assert w1.shape[0] == 2  # 4 experts over expert=2


def test_cli_samples_on_the_expert_mesh_as_jax_generate(runs):
    ranks, want, _ckpt = runs
    st, _stepper, mesh = want["data_expert"][2]
    cfg = _jax_cfg(SMALL, "xla")
    prompt = np.tile(np.asarray(_corpus(SMALL)[:PROMPT], np.int32)[None], (4, 1))
    out = np.asarray(jax_tf.generate(cfg, st.params, prompt, max_new_tokens=SAMPLE, mesh=mesh))
    for r in ranks:
        (sampled,) = r["data_expert"]["sampled"]
        np.testing.assert_array_equal(np.asarray(sampled), out)


def test_checkpoint_of_four_ranks_resumes_at_one(runs, monkeypatch):
    ranks, want, ckpt = runs
    monkeypatch.setattr(runner, "MetricsWriter",
                        lambda log_dir: MetricsWriter(log_dir, tensorboard=False))
    base = cli.config_from_args
    monkeypatch.setattr(cli, "config_from_args",
                        lambda a: dataclasses.replace(base(a), compute_dtype="float32"))

    class Metrics(hooks.Hook):
        def __init__(self):
            self.seen = []

        def after_step(self, loop, metrics):
            self.seen.append((float(metrics["loss"]), float(metrics["moe_aux"])))

    rec = Metrics()
    exp = cli.run_training(cli.build_parser().parse_args(_args(
        SMALL, [f"--log_dir={ckpt}", f"--train_steps={RESUMED_TO}"])), extra_hooks=[rec])
    assert exp.session.records.get("resumed_at") == STEPS
    # JAX from its step-3 state on one device: the routing groups are one
    # device's (``_group`` over 1 shard), as at the port's one rank.
    cfg = _jax_cfg(SMALL, "xla")
    _m, _l, (_st1, stepper1, mesh1) = _jax_run(cfg, {"data": 1}, [])
    w_metrics, w_leaves, _st = _jax_run(cfg, {"data": 1}, _batches(SMALL, 1, RESUMED_TO - STEPS),
                                        state=(jax.device_get(want["data_expert"][2][0]),
                                               stepper1, mesh1))
    np.testing.assert_allclose([m[0] for m in rec.seen], [m[0] for m in w_metrics],
                               rtol=0, atol=TOL_LOSS)
    got = {p: t.detach().numpy() for p, t in bridge._leaves(exp.state.params)}
    assert max(float(np.max(np.abs(got[p] - w_leaves[p]))) for p in w_leaves) <= TOL_LEAF


@pytest.mark.parametrize("name", ["ring", "ulysses", "model"])
def test_moe_composes_with_seq_and_model_axes(runs, name):
    ranks, want, _ckpt = runs
    _check(ranks, want, name)
    traffic = ranks[0][name]["traffic"]
    tag = {"ring": "seq_ring_calls", "ulysses": "seq_a2a_calls",
           "model": "model_fwd_calls"}[name]
    assert traffic.get(tag, 0) > 0, traffic
    # A group straddles the seq halves (gathered); under model, whole
    # groups cross the expert group by all-to-all.
    moe_tag = "expert_a2a_calls" if name == "model" else "expert_gather_calls"
    assert traffic.get(moe_tag, 0) > 0, traffic
