"""The port's word2vec (W4) and PTB LSTM (W5) against the JAX package's.

At narrow widths on the CPU (word2vec vocab 500, dim 32, 16 sampled; LSTM
vocab 300, width 24, 2 layers, 4 rows x 8 steps): the port's
``init_numpy`` against the JAX ``init`` from one seed; word2vec's
sampled ids, both losses with their per-leaf gradients at one key, and
``similarity``; the LSTM's forward, loss, gradients and new carry, the
carry threaded across windows and detached at each edge, and dropout at
one key; per-step losses through both packages' ``build_train_step`` (the
train step's key drawing the negatives and the masks) from the same seed
on the same batches, 20 steps in float32 and 5 in bfloat16; the datasets
bit for bit; each CLI's FINAL line, its first steps and final metric
against the JAX ``Experiment`` wired as the JAX CLI wires it (the LSTM's
``valid_perplexity`` against the JAX CLI's own loop); and a run cut at
step 2 and resumed from its ``--log_dir`` (the LSTM's carry included).

Tolerances.  Initial weights: uniform leaves bit for bit, the nce weights
(truncated normal) within ``NORMAL_ULPS`` float32 ulps (seen 3).  The
sampled ids and the subtract-log-q correction are JAX's exactly: the
port evaluates XLA's float32 ``exp`` and ``log`` (``word2vec._exp32``,
``_log32``; bitwise on 1.5M and 500k inputs).  torch's own are an ulp off
XLA's in about one value in ten: that flipped one id in 128,000 draws at
V 10000, and through the cancelling ``log(k+2) - log(k+1)`` moved the
correction by up to 9.3e-3 at ids near V.  word2vec, float32: one step's
loss 1e-6 relative (seen 1.2e-7) and gradients 1e-5 relative per leaf
(seen 1e-6); 20 steps, loss 2e-6 relative (seen 1.9e-7) and parameters
2e-6 (seen 2.4e-7).  LSTM, float32: logits 1e-5 (seen 1e-6), gradients
1e-5 relative (seen 1e-6), carry 1e-6 (seen 1.2e-7); 20 steps, loss
1e-5 (seen 9.5e-7), parameters 1e-5 (seen 2.2e-7), carry 1e-5 (seen
1.0e-6).  bfloat16 (the LSTM's default): 5 steps, loss 2e-3 (seen
1.7e-4), parameters 2e-2 (seen 2.4e-3), carry 5e-3 (seen 3.3e-4);
word2vec in bf16: loss 1e-5 relative (seen 3.0e-6), parameters 5e-3
(seen 1.1e-3).  The CLIs against the JAX ``Experiment``: word2vec (f32)
loss and ``eval_loss`` 2e-6 relative; the LSTM (bf16) loss 2e-3,
``valid_perplexity`` 1e-2 relative.
"""

import functools
import itertools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data import datasets as jax_datasets
from distributed_tensorflow_examples_tpu.models import lstm as jax_lstm
from distributed_tensorflow_examples_tpu.models import word2vec as jax_w2v
from distributed_tensorflow_examples_tpu.parallel import mesh as jax_mesh
from distributed_tensorflow_examples_tpu.train import hooks as jax_hooks
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import datasets
from distributed_tensorflow_examples_tpu_torch.examples import ptb_lstm, word2vec as w2v_cli
from distributed_tensorflow_examples_tpu_torch.models import lstm, word2vec
from distributed_tensorflow_examples_tpu_torch.train import hooks, optim, state, step
from distributed_tensorflow_examples_tpu_torch.utils import threefry

torch.set_num_threads(1)

NORMAL_ULPS = 4
W2V = dict(vocab_size=500, dim=32, num_sampled=16)
LSTM = dict(vocab_size=300, dim=24, num_layers=2)
ROWS, T = 4, 8
SEED = 4


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _corpus():
    ids, _vocab, _src = datasets.text_corpus(None, vocab_size=W2V["vocab_size"],
                                             synth_tokens=20000, seed=0)
    return ids


def _pairs(n, batch=64):
    it = datasets.skipgram_batches(_corpus(), batch_size=batch, window=3, seed=0)
    return [next(it) for _ in range(n)]


def _windows(n, rows=ROWS):
    ids = datasets._synthetic_token_stream(20000, LSTM["vocab_size"], 0)
    it = datasets.lm_batches(ids, batch_size=rows, seq_len=T)
    return [next(it) for _ in range(n)]


def _same_tree(got, want, *, normal=lambda p: False):
    ours, theirs = list(bridge._leaves(got)), list(bridge._leaves(want))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == np.float32 and a.shape == b.shape, path
        if normal(path):
            assert _ulps(a, b) <= NORMAL_ULPS, path
        else:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=path)


# ----------------------------------------------------------------------------
# word2vec
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_word2vec_init_numpy_is_the_jax_init(seed):
    want = jax.jit(functools.partial(jax_w2v.init, jax_w2v.Config(**W2V)))(jax.random.key(seed))
    got = word2vec.init_numpy(word2vec.Config(**W2V), seed, device="cpu")
    _same_tree(got, _np(want), normal=lambda p: p == "nce/weights")


@pytest.mark.parametrize("vocab", [10000, 1000, 64])
def test_sampled_ids_are_jax_at_the_tested_keys(vocab):
    """The negatives of 200 train-step keys (two seeds x 100 steps), id for
    id, and XLA's exp to the bit over the inverse CDF's range."""
    sample = jax.jit(lambda k: jax_w2v.log_uniform_sample(k, 64, vocab))
    for seed in (0, 5):
        for s in range(100):
            key = threefry.fold_in(threefry.key(seed), s)
            np.testing.assert_array_equal(
                word2vec.log_uniform_sample(key, 64, vocab).numpy(),
                np.asarray(sample(jax.random.fold_in(jax.random.key(seed), s))),
                err_msg=f"seed {seed} step {s}")
    x = (np.random.default_rng(vocab).random(200_000) * np.log(vocab + 1.0)).astype(np.float32)
    np.testing.assert_array_equal(word2vec._exp32(torch.from_numpy(x)).numpy().view(np.int32),
                                  np.asarray(jax.jit(jnp.exp)(x)).view(np.int32))
    x = (1.0 + x * np.float32(vocab)).astype(np.float32)
    np.testing.assert_array_equal(word2vec._log32(torch.from_numpy(x)).numpy().view(np.int32),
                                  np.asarray(jax.jit(jnp.log)(x)).view(np.int32))
    ids = np.arange(vocab, dtype=np.int32)
    np.testing.assert_array_equal(
        word2vec._log_expected_count(torch.from_numpy(ids), vocab, 64).numpy().view(np.int32),
        np.asarray(jax.jit(lambda i: jax_w2v._log_expected_count(i, vocab, 64))(ids))
        .view(np.int32))


@pytest.mark.parametrize("loss", ["nce", "sampled_softmax"])
def test_word2vec_losses_gradients_and_similarity_match_jax(loss):
    jcfg, tcfg = jax_w2v.Config(loss=loss, **W2V), word2vec.Config(loss=loss, **W2V)
    jparams = _np(jax.jit(functools.partial(jax_w2v.init, jcfg))(jax.random.key(SEED)))
    batch = _pairs(1)[0]
    key = threefry.fold_in(threefry.key(SEED), 3)
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_w2v.loss_fn(jcfg), has_aux=True))(
        jparams, {}, batch, _jkey(key))
    params = state.as_param_leaves(jparams, "cpu")
    tl, (_, m) = word2vec.loss_fn(tcfg)(params, {}, _torch_batch(batch), key)
    tl.backward()
    assert float(m["loss"]) == pytest.approx(float(jl), rel=1e-6)
    for (path, p), (_, want) in zip(bridge._leaves(params), bridge._leaves(_np(jg))):
        assert _rel(p.grad.numpy(), want) <= 1e-5, path
    # Repeated ids scatter-add: the batch's centers repeat, and so do the
    # negatives of a small vocab.
    assert len(np.unique(batch["center"])) < len(batch["center"])
    q = np.array([1, 7, 7, 42], np.int32)
    with torch.no_grad():
        got = word2vec.similarity(tcfg, params, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_w2v.similarity(jcfg, jparams, q)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("loss,dtype,steps", [("nce", "float32", 20),
                                              ("sampled_softmax", "float32", 20),
                                              ("nce", "bfloat16", 5)])
def test_word2vec_train_steps_match_jax(loss, dtype, steps):
    kw = dict(W2V, loss=loss, compute_dtype=dtype)
    jcfg, tcfg = jax_w2v.Config(**kw), word2vec.Config(**kw)
    lr = 0.5
    js = jax_state.create_state(jax.jit(functools.partial(jax_w2v.init, jcfg)), optax.sgd(lr),
                                jax.random.key(SEED))
    jstep = jax_step.build_train_step(jax_w2v.loss_fn(jcfg), optax.sgd(lr))
    ts = state.create_state(lambda s: word2vec.init_numpy(tcfg, s, device="cpu"),
                            optim.SGD(lr), SEED, "cpu")
    tstep = step.build_train_step(word2vec.loss_fn(tcfg), optim.SGD(lr))
    jl, tl = [], []
    for b in _pairs(steps):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _torch_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    rel_tol, param_tol = (2e-6, 2e-6) if dtype == "float32" else (1e-5, 5e-3)
    np.testing.assert_allclose(tl, jl, rtol=rel_tol, atol=0)
    for (path, p), (_, want) in zip(bridge._leaves(ts.params), bridge._leaves(_np(js.params))):
        assert np.abs(p.detach().numpy() - want).max() <= param_tol, path


def test_skipgram_batches_are_bit_identical():
    ours = datasets.skipgram_batches(_corpus(), batch_size=33, window=4, seed=7)
    theirs = jax_datasets.skipgram_batches(_corpus(), batch_size=33, window=4, seed=7)
    for a, b in itertools.islice(zip(ours, theirs), 5):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------------------------
# LSTM
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_lstm_init_numpy_is_the_jax_init(seed):
    init = jax.jit(functools.partial(jax_lstm.init, jax_lstm.Config(**LSTM), batch_size=ROWS))
    jparams, jcarry = init(jax.random.key(seed))
    params, carry = lstm.init_numpy(lstm.Config(**LSTM), seed, batch_size=ROWS, device="cpu")
    _same_tree(params, _np(jparams))
    _same_tree(carry, _np(jcarry))


def _jax_two_windows(jcfg, jparams, windows, rng):
    """JAX: window 1's loss and new carry from a zero carry, then window
    2's loss and gradients from that carry."""
    loss_f = jax.jit(jax.value_and_grad(jax_lstm.loss_fn(jcfg), has_aux=True))
    _, carry = jax_lstm.init(jcfg, jax.random.key(0), batch_size=ROWS)
    (l1, (c1, _)), _ = loss_f(jparams, carry, windows[0], rng)
    (l2, (c2, _)), g2 = loss_f(jparams, c1, windows[1], rng)
    return float(l1), float(l2), _np(c1), _np(c2), _np(g2)


@pytest.mark.parametrize("keep_prob", [1.0, 0.5])
def test_lstm_forward_gradients_and_carry_match_jax(keep_prob):
    """Two windows, the carry threaded: each window's loss, the carry after
    each, and window 2's gradients (backprop stops at the window's edge in
    both: the JAX carry is stop_gradient'ed, the port's detached).  With
    keep_prob 0.5 the dropout mask is drawn from the key in both."""
    kw = dict(LSTM, compute_dtype="float32", keep_prob=keep_prob)
    jcfg, tcfg = jax_lstm.Config(**kw), lstm.Config(**kw)
    jparams, _ = jax.jit(functools.partial(jax_lstm.init, jcfg, batch_size=ROWS))(
        jax.random.key(SEED))
    jparams = _np(jparams)
    windows = _windows(2)
    key = threefry.fold_in(threefry.key(SEED), 1)
    jl1, jl2, jc1, jc2, jg2 = _jax_two_windows(jcfg, jparams, windows, _jkey(key))
    params = state.as_param_leaves(jparams, "cpu")
    carry = state.as_state_leaves(lstm.zero_carry(tcfg, ROWS), "cpu")
    loss_f = lstm.loss_fn(tcfg)
    l1, (c1, _) = loss_f(params, carry, _torch_batch(windows[0]), key)
    for leaf in state.leaves(c1):
        assert not leaf.requires_grad and leaf.grad_fn is None and leaf.dtype == torch.float32
    for p in state.leaves(params):
        p.grad = None
    l2, (c2, m2) = loss_f(params, c1, _torch_batch(windows[1]), key)
    l2.backward()
    assert float(l1.detach()) == pytest.approx(jl1, abs=1e-5)
    assert float(m2["loss"]) == pytest.approx(jl2, abs=1e-5)
    assert float(m2["perplexity"]) == pytest.approx(np.exp(jl2), rel=1e-5)
    for got, want in ((c1, jc1), (c2, jc2)):
        for (path, a), (_, b) in zip(bridge._leaves(got), bridge._leaves(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6, err_msg=path)
    for (path, p), (_, want) in zip(bridge._leaves(params), bridge._leaves(jg2)):
        assert _rel(p.grad.numpy(), want) <= 1e-5, path
    with torch.no_grad():
        logits, _ = lstm.apply(tcfg, params, carry, _torch_batch(windows[0])["x"], rng=key)
    jlogits, _ = jax.jit(functools.partial(jax_lstm.apply, jcfg))(
        jparams, jax.tree.map(jnp.zeros_like, _np(jc1)), windows[0]["x"], rng=_jkey(key))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert lstm.reset_carry(c2)["lstm_1"]["h"].abs().max() == 0


@pytest.mark.parametrize("dtype,steps", [("float32", 20), ("bfloat16", 5)])
def test_lstm_train_steps_match_jax(dtype, steps):
    """The carry threads through the train state in both packages."""
    kw = dict(LSTM, compute_dtype=dtype)
    jcfg, tcfg = jax_lstm.Config(**kw), lstm.Config(**kw)
    lr, clip = 1.0, 5.0
    jopt = optax.chain(optax.clip_by_global_norm(clip), optax.sgd(lr))
    js = jax_state.create_state(jax.jit(functools.partial(jax_lstm.init, jcfg, batch_size=ROWS)),
                                jopt, jax.random.key(SEED))
    jstep = jax_step.build_train_step(jax_lstm.loss_fn(jcfg), jopt)
    topt = optim.SGD(lr, clip_norm=clip)
    ts = state.create_state(lambda s: lstm.init_numpy(tcfg, s, batch_size=ROWS, device="cpu"),
                            topt, SEED, "cpu")
    tstep = step.build_train_step(lstm.loss_fn(tcfg), topt)
    jl, tl = [], []
    for b in _windows(steps):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _torch_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    loss_tol, param_tol, carry_tol = (1e-5, 1e-5, 1e-5) if dtype == "float32" else (2e-3, 2e-2,
                                                                                   5e-3)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=loss_tol)
    for (path, p), (_, want) in zip(bridge._leaves(ts.params), bridge._leaves(_np(js.params))):
        assert np.abs(p.detach().numpy() - want).max() <= param_tol, path
    for (path, c), (_, want) in zip(bridge._leaves(ts.model_state),
                                    bridge._leaves(_np(js.model_state))):
        assert np.abs(c.numpy() - want).max() <= carry_tol, path


def test_ptb_streams_are_bit_identical(tmp_path):
    ours, theirs = datasets.ptb(None, vocab_size=300, seed=2), jax_datasets.ptb(
        None, vocab_size=300, seed=2)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[2:] == theirs[2:]
    (tmp_path / "ptb.train.txt").write_text("the cat sat\non the mat\nthe end\n" * 10)
    (tmp_path / "ptb.valid.txt").write_text("the dog sat\non a mat\n" * 5)
    ours, theirs = datasets.ptb(str(tmp_path), vocab_size=6), jax_datasets.ptb(
        str(tmp_path), vocab_size=6)
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_array_equal(a, b)
    assert ours[2:] == theirs[2:] and ours[3].startswith("file:")


# ----------------------------------------------------------------------------
# The CLIs
# ----------------------------------------------------------------------------

#: Each CLI with a tiny CPU run's flags, and its FINAL metric.
CLIS = {
    "word2vec": (w2v_cli, ["--vocab_size=500", "--embedding_dim=32", "--num_sampled=16",
                           "--batch_size=32", "--learning_rate=0.5"], "eval_loss"),
    "ptb_lstm": (ptb_lstm, ["--vocab_size=300", "--hidden_dim=24", f"--batch_size={ROWS}",
                            f"--seq_len={T}", "--learning_rate=1.0"], "valid_perplexity"),
}


class _Losses(hooks.Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, loop, metrics):
        self.losses.append(float(metrics["loss"]))


def _args(name, *extra):
    cli, argv, _metric = CLIS[name]
    return cli.build_parser().parse_args(["--device=cpu", "--log_every_steps=1", *argv, *extra])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_prints_final_and_ps_task_exits(name, capsys):
    cli, argv, metric = CLIS[name]
    assert cli.main(["--device=cpu", "--train_steps=2", *argv]) == 0
    out = capsys.readouterr().out
    assert re.search(rf"^FINAL step=2 steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
                     rf"{metric}=[0-9.]+$", out, re.M), out
    assert cli.main(["--job_name=ps", "--worker_hosts=w:1,w:2"]) == 0
    assert "parameter servers are not needed" in capsys.readouterr().out
    # The JAX CLI has no PS branch: --ps_emulation trains as usual.
    assert cli.main(["--device=cpu", "--train_steps=2", "--ps_emulation", *argv]) == 0
    assert re.search(rf"^FINAL step=2 steps_per_sec=\S+ examples_per_sec_per_chip=\S+ "
                     rf"{metric}=[0-9.]+$", capsys.readouterr().out, re.M)
    with pytest.raises(NotImplementedError, match="A12"):
        cli.main(["--device=cpu", "--profile", *argv])
    # As in JAX: a data axis of 2 on a world of one process does not tile it.
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        cli.main(["--device=cpu", "--mesh=data=2", *argv])


def _jax_valid_perplexity(cfg, params, valid_ids, batch_size, seq_len):
    """The JAX CLI's validation loop (``examples/ptb_lstm.py``), as it is."""
    eval_rows = min(batch_size, max(1, len(valid_ids) // (seq_len + 1)))
    _, carry = jax_lstm.init(cfg, jax.random.key(0), batch_size=eval_rows)
    vit = jax_datasets.lm_batches(valid_ids, batch_size=eval_rows, seq_len=seq_len)
    n_eval = max(1, (len(valid_ids) // eval_rows - 1) // seq_len)
    total, count = 0.0, 0
    loss_f = jax_lstm.loss_fn(cfg)
    eval_step = jax.jit(lambda params, carry, b: loss_f(params, carry, b, jax.random.key(0)))
    for _ in range(min(n_eval, 50)):
        b = {k: jnp.asarray(v) for k, v in next(vit).items()}
        loss, (carry, _m) = eval_step(params, carry, b)
        total += float(loss)
        count += 1
    return float(jnp.exp(total / count))


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_steps_match_the_jax_experiment(name):
    """The CLI against the JAX ``Experiment`` wired as the JAX CLI wires
    it: init from ``key(--seed)``, the same optimizer and data, and the
    final metric computed as the JAX CLI computes it."""
    steps = 4
    args = _args(name, f"--train_steps={steps}", "--seed=2")
    clock = _Losses()
    exp = CLIS[name][0].run_training(args, extra_hooks=[clock])

    class JaxLosses(jax_hooks.Hook):
        def __init__(self):
            self.losses = []

        def after_step(self, loop, metrics):
            self.losses.append(float(metrics["loss"]))

    jclock = JaxLosses()
    jflags = types.SimpleNamespace(**{**vars(args), "watchdog": False, "log_dir": None})
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec.parse("data=1"), devices=jax.devices()[:1])
    if name == "word2vec":
        cfg = jax_w2v.Config(vocab_size=500, dim=32, num_sampled=16)
        ids, _v, _s = jax_datasets.text_corpus(None, vocab_size=500, seed=2)
        jexp = jax_train.Experiment(
            init_fn=lambda r: jax_w2v.init(cfg, r), loss_fn=jax_w2v.loss_fn(cfg),
            optimizer=optax.sgd(args.learning_rate), flags=jflags, mesh=mesh,
            extra_hooks=[jclock])
        jexp.run(jax_datasets.skipgram_batches(ids, batch_size=args.batch_size,
                                               window=args.window, seed=2))
        pairs = next(jax_datasets.skipgram_batches(ids, batch_size=4096, window=args.window,
                                                   seed=2 + 999))
        want = jexp.evaluate(pairs, batch_size=1024)["loss"]
        assert exp.eval_metrics["loss"] == pytest.approx(want, rel=2e-6)
        np.testing.assert_allclose(clock.losses, jclock.losses, rtol=2e-6, atol=0)
    else:
        cfg = jax_lstm.Config(vocab_size=300, dim=24, num_layers=2)
        train_ids, valid_ids, _v, _s = jax_datasets.ptb(None, vocab_size=300, seed=2)
        jexp = jax_train.Experiment(
            init_fn=lambda r: jax_lstm.init(cfg, r, batch_size=ROWS),
            loss_fn=jax_lstm.loss_fn(cfg),
            optimizer=optax.chain(optax.clip_by_global_norm(args.clip_norm),
                                  optax.sgd(args.learning_rate)),
            flags=jflags, mesh=mesh, extra_hooks=[jclock])
        jexp.run(jax_datasets.lm_batches(train_ids, batch_size=ROWS, seq_len=T))
        want = _jax_valid_perplexity(cfg, jexp.state.params, valid_ids, ROWS, T)
        assert exp.valid_perplexity == pytest.approx(want, rel=1e-2)
        np.testing.assert_allclose(clock.losses, jclock.losses, rtol=0, atol=2e-3)
    jexp.writer.close()
    assert len(clock.losses) == steps


def _restarting(factory, k):
    """The stream of ``factory``'s first ``k`` items, then its whole stream
    again: what a run cut at step k and resumed reads (each run starts its
    data from the beginning, in both packages)."""

    def make(*a, **kw):
        return itertools.chain(itertools.islice(iter(factory(*a, **kw)), k),
                               iter(factory(*a, **kw)))

    return make


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_resumes_from_its_checkpoint(name, tmp_path, monkeypatch):
    """A run cut at step 2 and rerun to step 4 from its --log_dir takes the
    uninterrupted run's steps 3 and 4 bit for bit (that run reading the
    first two batches again, as the resumed run does): the parameters, the
    SGD state, the step (word2vec's negatives fold it in) and the LSTM's
    carry all come back."""
    cli = CLIS[name][0]
    cut = _Losses()
    cli.run_training(_args(name, "--train_steps=2", f"--log_dir={tmp_path}"), extra_hooks=[cut])
    resumed = _Losses()
    rexp = cli.run_training(_args(name, "--train_steps=4", f"--log_dir={tmp_path}"),
                            extra_hooks=[resumed])
    assert rexp.session.records["resumed_at"] == 2
    source = "skipgram_batches" if name == "word2vec" else "lm_batches"
    monkeypatch.setattr(datasets, source, _restarting(getattr(datasets, source), 2))
    straight = _Losses()
    sexp = cli.run_training(_args(name, "--train_steps=4"), extra_hooks=[straight])
    assert cut.losses + resumed.losses == straight.losses
    for (path, a), b in zip(bridge._leaves(rexp.state.params), state.leaves(sexp.state.params)):
        assert torch.equal(a, b), path
    for (path, a), b in zip(bridge._leaves(rexp.state.model_state),
                            state.leaves(sexp.state.model_state)):
        assert torch.equal(a, b), path
    if name == "ptb_lstm":
        assert len(state.leaves(rexp.state.model_state)) == 2 * LSTM["num_layers"]
