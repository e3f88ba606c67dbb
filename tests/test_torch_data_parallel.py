"""The port's synchronous data parallelism on two real gloo ranks on the
CPU, against the JAX step on the 8-device CPU mesh over the global batch.

The ranks are processes of the port's ``utils.multiprocess.
MultiProcessRunner`` (``TF_CONFIG`` injected; nothing here joins a
process group in the pytest process).  One spawned script runs three
checks on each rank and saves what it saw:

- W1's sync path in float32: the MNIST CLI's ``run_training`` (hidden
  32/16, global batch 16, SGD 0.1, 3 steps), each rank on its strided
  share of the JAX pipeline's batches; against the JAX step on the global
  batch (rank 0's rows, then rank 1's);
- a tiny ResNet (stages (1, 1), width 8, 32 x 32, float32) with the fused
  BatchNorm path (SyncBN over the plain versions of B6/B7): one forward
  and backward on each rank's 4 rows of an 8-row batch, the gradients
  mean-all-reduced; against JAX's loss and gradients on the mesh with
  the Pallas kernels in interpret mode (``FORCE_PALLAS``);
- the PTB LSTM CLI in float32 (vocab 50, width 16, 2 layers, global
  batch 8 x 5, clip 0.05 so the clip engages, SGD 1.0), each rank a
  contiguous block of the stream and a carry of its 4 rows, 2 steps;
  against JAX's clipped steps over the global rows.

Then a rank killed while both run the watchdog: the survivor exits 83
(``EXIT_PEER_LOST``); crash-restart: the LSTM CLI on two ranks cut at
step 3 and run again to 5 resumes from the chief's checkpoint at step 3,
each rank with its own rows of the saved global carry; and a SIGTERM to
one rank only: both ranks save at the same step and stop there.

Tolerances (float32).  MLP: losses and parameters within 1e-5 (seen 0
and 6.0e-8).  ResNet: loss 1e-5 (seen 2.4e-7), each leaf's gradient 1e-4
relative to its norm, scale and bias included (seen 5.6e-6).  LSTM:
losses 1e-5 (seen 4.8e-7), parameters after the 2 clipped steps 1e-5
(seen 3.7e-9).
"""

import os
import pickle
import re
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributed_tensorflow_examples_tpu.data import pipeline as jax_pipeline
from distributed_tensorflow_examples_tpu.models import lstm as jax_lstm
from distributed_tensorflow_examples_tpu.models import mlp as jax_mlp
from distributed_tensorflow_examples_tpu.models import resnet as jax_resnet
from distributed_tensorflow_examples_tpu.ops import bn as jax_bn
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch.data import datasets
from distributed_tensorflow_examples_tpu_torch.parallel import dist
from distributed_tensorflow_examples_tpu_torch.utils.multiprocess import MultiProcessRunner

TINY = dict(stage_sizes=(1, 1), width=8, num_classes=10, compute_dtype="float32")
MLP_ARGS = ["--device=cpu", "--hidden_units=32,16", "--batch_size=16", "--train_steps=3",
            "--learning_rate=0.1", "--seed=3", "--log_every_steps=1"]
LSTM_SIZES = dict(vocab_size=50, dim=16, num_layers=2)
LSTM_ARGS = ["--device=cpu", "--vocab_size=50", "--hidden_dim=16", "--num_layers=2",
             "--batch_size=8", "--seq_len=5", "--learning_rate=1.0", "--clip_norm=0.05",
             "--seed=1", "--log_every_steps=1"]
RESNET_ROWS = 8

# Each rank: the three checks, its results pickled to <out>/rank<i>.pkl.
CHECKS = """
import functools, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.examples import mnist_mlp, ptb_lstm
from distributed_tensorflow_examples_tpu_torch.models import lstm, mlp, resnet
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.parallel import sharding
from distributed_tensorflow_examples_tpu_torch.train import hooks, state, step

out_dir = {out_dir!r}
rank = dist.process_index()
res = {{}}

class Losses(hooks.Hook):
    def __init__(self):
        self.losses = []
    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))

def leaves_of(tree):
    return [p.detach().numpy().copy() for p in state.leaves(tree)]

# W1's sync path, float32 (the CLI's Config with the dtype pinned).
mnist_mlp.mlp.Config = functools.partial(mlp.Config, compute_dtype="float32")
rec = Losses()
exp = mnist_mlp.run_training(mnist_mlp.build_parser().parse_args({mlp_args!r}),
                             extra_hooks=[rec])
res["mlp_losses"], res["mlp_params"] = rec.losses, leaves_of(exp.state.params)

# The tiny ResNet on the fused path: this rank's rows of the global batch.
with open(out_dir + "/resnet_init.pkl", "rb") as f:
    params0, mstate0, batch = pickle.load(f)
cfg = resnet.Config(**{tiny!r})
mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(""), "cpu")
params = state.as_param_leaves(params0, "cpu")
rows = sharding.rank_rows(len(batch["label"]))
local = {{k: torch.from_numpy(v[rows]) for k, v in batch.items()}}
loss, (_ms, _m) = resnet.loss_fn(cfg, mesh=mesh)(params, state.as_state_leaves(mstate0, "cpu"),
                                                local, None)
loss.backward()
step.sync_gradients(params, mesh.group)
res["resnet_loss"] = float(collectives.pmean(loss.detach()))
res["resnet_grads"] = [p.grad.numpy().copy() for p in state.leaves(params)]
res["resnet_paths"] = [path for path, _ in bridge._leaves(params)]

# The PTB LSTM CLI, float32.
ptb_lstm.config_from_args = lambda a: lstm.Config(
    vocab_size=a.vocab_size, dim=a.hidden_dim, num_layers=a.num_layers, compute_dtype="float32")
rec = Losses()
exp = ptb_lstm.run_training(ptb_lstm.build_parser().parse_args({lstm_args!r} + ["--train_steps=2"]),
                            extra_hooks=[rec])
res["lstm_losses"], res["lstm_params"] = rec.losses, leaves_of(exp.state.params)
with open(f"{{out_dir}}/rank{{rank}}.pkl", "wb") as f:
    pickle.dump(res, f)
print("CHECKS DONE", rank)
"""


def _jax_global_steps(mesh, init_fn, loss_fn, opt, batches, seed, rules=()):
    """Losses and final params of the JAX step on ``mesh`` over global
    numpy batches."""
    st, shardings = jax_state.create_sharded_state(init_fn, opt, jax.random.key(seed),
                                                   mesh=mesh, rules=rules)
    stepper = jax_step.build_train_step(loss_fn, opt, mesh=mesh, state_shardings=shardings)
    spec = NamedSharding(mesh, PartitionSpec("data"))
    losses = []
    for b in batches:
        st, m = stepper(st, {k: jax.device_put(jnp.asarray(v), spec) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, [np.asarray(x) for x in jax.tree.leaves(jax.device_get(st.params))]


def _global(batches_by_rank):
    """Rank 0's rows, then rank 1's, for each step."""
    return [{k: np.concatenate([b[k] for b in step]) for k in step[0]}
            for step in zip(*batches_by_rank)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_two_gloo_ranks_match_the_jax_step_on_the_global_batch(mesh8, tmp_path):
    out_dir = str(tmp_path)
    # The ResNet's weights: JAX's init, shared with both ranks.
    jcfg = jax_resnet.Config(**TINY)
    jparams, jmstate = jax.device_get(
        jax.jit(lambda k: jax_resnet.init(jcfg, k))(jax.random.key(0)))
    rng = np.random.default_rng(7)
    batch = {"image": rng.normal(size=(RESNET_ROWS, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, RESNET_ROWS).astype(np.int32)}
    with open(f"{out_dir}/resnet_init.pkl", "wb") as f:
        pickle.dump((jparams, jmstate, batch), f)
    runner = MultiProcessRunner(2, CHECKS.format(
        out_dir=out_dir, mlp_args=MLP_ARGS, tiny=TINY, lstm_args=LSTM_ARGS), timeout=120)
    runner.start()
    try:
        # The JAX references, while the ranks run.
        ds = datasets.mnist(None, seed=3)
        mcfg = jax_mlp.Config(hidden=(32, 16), compute_dtype="float32")
        pipes = [iter(jax_pipeline.InMemoryPipeline(ds.train, batch_size=16, seed=3,
                                                    process_index=r, process_count=2))
                 for r in range(2)]
        mlp_batches = _global([[next(p) for _ in range(3)] for p in pipes])
        mlp_losses, mlp_params = _jax_global_steps(
            mesh8, lambda k: jax_mlp.init(mcfg, k), jax_mlp.loss_fn(mcfg), optax.sgd(0.1),
            mlp_batches, seed=3)

        old = jax_bn.FORCE_PALLAS
        jax_bn.FORCE_PALLAS = True
        try:
            spec = NamedSharding(mesh8, PartitionSpec("data"))
            (rloss, _aux), rgrads = jax.jit(jax.value_and_grad(
                jax_resnet.loss_fn(jcfg, mesh=mesh8), has_aux=True))(
                jparams, jmstate, {k: jax.device_put(jnp.asarray(v), spec)
                                   for k, v in batch.items()}, None)
        finally:
            jax_bn.FORCE_PALLAS = old

        train_ids, _valid, _vocab, _src = datasets.ptb(None, vocab_size=50, seed=1)
        block = len(train_ids) // 2
        lstm_batches = _global([
            [next(it) for _ in range(2)] for it in (
                datasets.lm_batches(train_ids[r * block:(r + 1) * block], batch_size=4,
                                    seq_len=5) for r in range(2))])
        lcfg = jax_lstm.Config(**LSTM_SIZES, compute_dtype="float32")
        lstm_losses, lstm_params = _jax_global_steps(
            mesh8, lambda k: jax_lstm.init(lcfg, k, batch_size=8), jax_lstm.loss_fn(lcfg),
            optax.chain(optax.clip_by_global_norm(0.05), optax.sgd(1.0)), lstm_batches,
            seed=1, rules=jax_lstm.SHARDING_RULES)
    finally:
        codes = runner.join()
    assert codes == [0, 0], "\n".join(runner.output(i) for i in range(2))
    out = [runner.output(i) for i in range(2)]
    ranks = []
    for r in range(2):
        with open(f"{out_dir}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    runner.cleanup()

    # Only the chief prints FINAL; its throughput is the global batch's.
    assert re.search(r"^FINAL step=3 .* test_accuracy=", out[0], re.M), out[0]
    assert re.search(r"^FINAL step=2 .* valid_perplexity=", out[0], re.M), out[0]
    assert "FINAL" not in out[1], out[1]
    for res in ranks:
        np.testing.assert_allclose(res["mlp_losses"], mlp_losses, rtol=0, atol=1e-5)
        for got, want in zip(res["mlp_params"], mlp_params):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert abs(res["resnet_loss"] - float(rloss)) <= 1e-5
        paths = res["resnet_paths"]
        assert any(p.endswith("scale") for p in paths) and any(p.endswith("bias") for p in paths)
        for path, got, want in zip(paths, res["resnet_grads"], jax.tree.leaves(rgrads)):
            assert _rel(got, want) <= 1e-4, path
        np.testing.assert_allclose(res["lstm_losses"], lstm_losses, rtol=0, atol=1e-5)
        for got, want in zip(res["lstm_params"], lstm_params):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The replicas end bit for bit alike.
    for key in ("mlp_params", "lstm_params", "resnet_grads"):
        for a, b in zip(ranks[0][key], ranks[1][key]):
            np.testing.assert_array_equal(a, b)


WATCHDOG = """
import time
assert dist.start_watchdog(interval_s=0.2, grace_s=1.0)
print("BEATING", flush=True)
time.sleep(60)
"""


def test_a_killed_rank_makes_the_survivor_exit_83():
    runner = MultiProcessRunner(2, WATCHDOG, timeout=40)
    runner.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not all(
            "BEATING" in runner.output(i) for i in range(2)):
        time.sleep(0.1)
    time.sleep(0.5)
    runner.kill_task(1, signal.SIGKILL)
    codes = runner.join(timeout=30)
    assert codes[1] == -signal.SIGKILL
    assert codes[0] == dist.EXIT_PEER_LOST, runner.output(0)
    assert "peer heartbeat lost for rank(s) [1]" in runner.output(0)
    runner.cleanup()


RESTART = """
import hashlib, logging
import torch
torch.set_num_threads(1)
logging.basicConfig(level=logging.INFO, format="%(message)s")
from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm
from distributed_tensorflow_examples_tpu_torch.parallel import dist
from distributed_tensorflow_examples_tpu_torch.train import state
from distributed_tensorflow_examples_tpu_torch.train import runner
from distributed_tensorflow_examples_tpu_torch.train.hooks import Hook
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

# JSONL metrics only: the event-file mirror's import costs ~10 s a process.
runner.MetricsWriter = lambda log_dir: MetricsWriter(log_dir, tensorboard=False)

class Carry(Hook):
    def begin(self, loop):
        print("BEGIN_CARRY", dist.process_index(), carry_hash(loop.state), flush=True)

def carry_hash(st):
    return hashlib.sha256(b"".join(t.numpy().tobytes()
                                   for t in state.leaves(st.model_state))).hexdigest()[:16]

exp = ptb_lstm.run_training(ptb_lstm.build_parser().parse_args(
    {args!r} + ["--train_steps=" + {steps!r}]), extra_hooks=[Carry()])
print("RESUMED_AT", exp.session.records.get("resumed_at", 0), "END_CARRY",
      dist.process_index(), carry_hash(exp.state), flush=True)
"""


def test_crash_restart_resumes_every_rank_at_step_3(tmp_path):
    args = LSTM_ARGS + [f"--log_dir={tmp_path}", "--checkpoint_every_steps=3",
                        "--clip_norm=5"]
    first = MultiProcessRunner(2, RESTART.format(args=args, steps="3"), prelude=False).run()
    assert re.search(r"^FINAL step=3 ", first[0], re.M), first[0]
    assert "RESUMED_AT 0" in first[0]
    ends = [re.search(r"END_CARRY \d (\w+)", o).group(1) for o in first]
    assert ends[0] != ends[1]  # each rank carries its own rows
    second = MultiProcessRunner(2, RESTART.format(args=args, steps="5"), prelude=False).run()
    for r, o in enumerate(second):
        assert "RESUMED_AT 3" in o and "auto-resumed at step 3" in o, o
        # The restored carry is this rank's rows of the chief's global save.
        assert re.search(r"BEGIN_CARRY \d (\w+)", o).group(1) == ends[r]
    assert re.search(r"^FINAL step=5 ", second[0], re.M), second[0]
    assert "FINAL" not in second[1]


PREEMPT = """
import os, signal
import torch
torch.set_num_threads(1)
from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm
from distributed_tensorflow_examples_tpu_torch.parallel import dist
from distributed_tensorflow_examples_tpu_torch.train import runner
from distributed_tensorflow_examples_tpu_torch.train.hooks import Hook
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

runner.MetricsWriter = lambda log_dir: MetricsWriter(log_dir, tensorboard=False)

class SigtermToRank1(Hook):
    def after_step(self, loop, metrics):
        if dist.process_index() == 1 and loop.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

exp = ptb_lstm.run_training(ptb_lstm.build_parser().parse_args({args!r}),
                            extra_hooks=[SigtermToRank1()])
print("STOPPED_AT", dist.process_index(), exp.session.step, flush=True)
"""


def test_sigterm_to_one_rank_saves_and_stops_every_rank_at_one_step(tmp_path):
    # Rank 1 receives the signal after step 2; the ranks agree on it after
    # step 3, save together (a collective: the carry is gathered) and stop.
    args = LSTM_ARGS + [f"--log_dir={tmp_path}", "--train_steps=8",
                        "--checkpoint_every_steps=100"]
    outs = MultiProcessRunner(2, PREEMPT.format(args=args), prelude=False, timeout=90).run()
    for r, o in enumerate(outs):
        assert f"STOPPED_AT {r} 3" in o, o
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3"]
