"""The port's training slice against the JAX package's, at tiny size.

JAX ``init`` draws the weights; they cross to the port through the flat
registry vector, and both packages take three steps of
``clip_by_global_norm(1.0) + adamw(1e-3)`` (optax there, ``train.optim``
here) on the same numpy batches, from ``build_train_step`` on each side.
Held against each other: the loss of every step, the first step's
gradients (per leaf, ||port - jax|| / ||jax||), and the parameters after
the last step.

Tolerances.  float32: loss 1e-5 (seen 1e-6), gradients 5e-6 relative
(seen 5e-7), parameters 3e-5 absolute (seen 8e-6: Adam divides by the
root of the second moment, so a gradient element near zero that the two
frameworks round differently moves its parameter by a visible fraction
of the 1e-3 step).  bfloat16: loss 2e-3 (seen 4e-4); gradients 2.5e-2
relative (seen 1.05e-2, and JAX's own bf16 gradients are 1.1e-2 from the
f32 ones while the port's are 0.6e-2: the frameworks round the bf16
activations and reductions at different places); parameters 6e-3
absolute, two Adam steps of 1e-3 each way (seen 2.9e-3), and 1e-4 in
mean absolute difference (seen 1.3e-5).
"""

import dataclasses
import functools
import itertools
import re
import types

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data import datasets as jax_datasets
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu.train.checkpoint import (
    flat_params_of as jax_flat_params_of,
)
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.data import datasets, pipeline
from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as torch_flash_ops
from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry
from distributed_tensorflow_examples_tpu_torch.train import (
    Experiment, checkpoint, hooks, loop, optim, preemption, state, step,
)
from distributed_tensorflow_examples_tpu_torch.utils import threefry
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, max_seq_len=64)
LR = 1e-3
STEPS = 3
TOL = {
    "float32": dict(loss=1e-5, grad=5e-6, param=3e-5, param_mean=3e-5),
    "bfloat16": dict(loss=2e-3, grad=2.5e-2, param=6e-3, param_mean=1e-4),
}


@pytest.fixture(autouse=True)
def _no_tensorboard_events(monkeypatch):
    """No test here reads an event file: the runs write metrics.jsonl only
    (a TensorBoard writer's first import pulls in TensorFlow, seconds a
    process)."""
    monkeypatch.setattr(MetricsWriter, "__init__",
                        functools.partialmethod(MetricsWriter.__init__, tensorboard=False))


def _batches(n, batch=4, seq_len=TINY["max_seq_len"]):
    ids, _vocab, _src = datasets.text_corpus(None, vocab_size=64, synth_tokens=20000, seed=0)
    it = datasets.lm_batches(ids, batch_size=batch, seq_len=seq_len)
    return [next(it) for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _configs(**kw):
    kw = dict(TINY, **kw)
    return jax_tf.Config(**kw), torch_tf.Config(**kw)


def _port_state(tcfg, jparams, optimizer):
    _total, unflatten = bridge.flat_param_spec(torch_tf.param_shapes(tcfg))
    views = unflatten(jax_flat_params_of(jparams), "cpu")
    return state.create_state(lambda seed: views, optimizer, 0, "cpu")


def _optimizers(clip=1.0, lr=LR):
    return (
        optax.chain(optax.clip_by_global_norm(clip), optax.adamw(lr)),
        optim.ClippedAdamW(lr, clip),
    )


@functools.lru_cache(maxsize=None)
def _jax_run(attention, dtype, loss_chunks, grad_accum, seq_len):
    """JAX: init params, first-step gradients, per-step losses, final params."""
    jcfg, _ = _configs(attention=attention, compute_dtype=dtype, loss_chunks=loss_chunks,
                       max_seq_len=seq_len)
    jopt, _ = _optimizers()
    js = jax_state.create_state(lambda r: jax_tf.init(jcfg, r), jopt, jax.random.key(0))
    jparams = jax.device_get(js.params)
    batches = _batches(STEPS, seq_len=seq_len)
    jloss_fn = jax_tf.loss_fn(jcfg)
    grads = None
    if grad_accum == 1:
        (_, _), g = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
            js.params, {}, batches[0], jax.random.key(1)
        )
        grads = [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]
    train_step = jax_step.build_train_step(jloss_fn, jopt, grad_accum=grad_accum)
    losses = []
    for b in batches:
        js, m = train_step(js, b)
        losses.append(float(m["loss"]))
    final = [np.asarray(x, np.float32) for x in jax.tree.leaves(jax.device_get(js.params))]
    return jparams, grads, losses, final


def _case(attention, dtype, loss_chunks, grad_accum, fused=False):
    """One case, under the id the four-field cases had."""
    ident = f"{attention}-{dtype}-{loss_chunks}-{grad_accum}" + ("-fused-t512" if fused else "")
    return pytest.param(attention, dtype, loss_chunks, grad_accum, fused, id=ident)


@pytest.mark.parametrize(
    "attention,dtype,loss_chunks,grad_accum,fused",
    [
        _case("xla", "float32", 0, 1),
        _case("flash", "float32", 0, 1),
        _case("xla", "bfloat16", 0, 1),
        _case("flash", "bfloat16", 0, 1),
        _case("flash", "float32", 2, 1),
        _case("xla", "float32", 0, 2),
        # DTX_FLASH_BQ/BK = 128 at T 512: nq = nk = 4, so DTX_FUSED_BWD=1
        # sends every attention backward of both packages to the fused kernel.
        _case("flash", "float32", 0, 1, fused=True),
    ],
)
def test_train_steps_match_jax(attention, dtype, loss_chunks, grad_accum, fused, monkeypatch):
    seq_len = TINY["max_seq_len"]
    fused_calls = []
    if fused:
        seq_len = 512
        for name, value in (("DTX_FLASH_BQ", "128"), ("DTX_FLASH_BK", "128"),
                            ("DTX_FUSED_BWD", "1")):
            monkeypatch.setenv(name, value)
        real = torch_flash_ops.fused_bwd_plain
        monkeypatch.setattr(torch_flash_ops, "fused_bwd_plain",
                            lambda *a, **kw: fused_calls.append(1) or real(*a, **kw))
    jparams, jgrads, jlosses, jfinal = _jax_run(attention, dtype, loss_chunks, grad_accum, seq_len)
    _, tcfg = _configs(attention=attention, compute_dtype=dtype, loss_chunks=loss_chunks,
                       max_seq_len=seq_len)
    _, topt = _optimizers()
    tol = TOL[dtype]
    ts = _port_state(tcfg, jparams, topt)
    loss_fn = torch_tf.loss_fn(tcfg)
    batches = _batches(STEPS, seq_len=seq_len)

    if jgrads is not None:
        loss, _ = loss_fn(ts.params, {}, _torch_batch(batches[0]), None)
        loss.backward()
        for (path, p), want in zip(bridge._leaves(ts.params), jgrads):
            got = p.grad.numpy()
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= tol["grad"], f"{path}: grad rel err {rel:.3e}"
            p.grad = None

    train_step = step.build_train_step(loss_fn, topt, grad_accum=grad_accum)
    losses = []
    for b in batches:
        ts, m = train_step(ts, _torch_batch(b))
        losses.append(float(m["loss"]))
        if grad_accum == 1:  # else the mean of the microbatches' perplexities
            assert float(m["perplexity"]) == pytest.approx(np.exp(losses[-1]), rel=1e-5)
    assert ts.step == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=tol["loss"])
    assert losses[-1] < losses[0]
    for (path, p), want in zip(bridge._leaves(ts.params), jfinal):
        diff = np.abs(p.detach().numpy() - want)
        assert diff.max() <= tol["param"], f"{path}: max |Δparam| {diff.max():.3e}"
        assert diff.mean() <= tol["param_mean"], f"{path}: mean |Δparam| {diff.mean():.3e}"
    # The fused path ran: each layer's backward, for the gradients and the steps.
    assert len(fused_calls) == (tcfg.n_layers * (1 + STEPS) if fused else 0)


@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clip_active", "clip_idle"])
def test_optimizer_matches_optax(clip):
    rng = np.random.default_rng(5)
    params = {"a": {"kernel": rng.standard_normal((5, 7)).astype(np.float32)},
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [
        {"a": {"kernel": rng.standard_normal((5, 7)).astype(np.float32)},
         "b": rng.standard_normal((3,)).astype(np.float32)}
        for _ in range(6)
    ]
    jopt, topt = _optimizers(clip=clip, lr=1e-2)
    jp, js = params, jopt.init(params)
    tp = state.as_param_leaves(params, "cpu")
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(state.leaves(tp), state.leaves(g)):
            p.grad = torch.from_numpy(x)
        topt.update(ts, tp)
    assert all(s["step"] == len(grads) for s in ts.state.values())
    for (path, got), want in zip(bridge._leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=path)


def test_adamw_defaults_are_optax_defaults():
    """weight decay 1e-4 on every leaf (torch's AdamW would use 1e-2),
    a zero gradient included."""
    p = state.as_param_leaves({"w": np.ones(4, np.float32)}, "cpu")
    opt = optim.ClippedAdamW(1.0, 1.0)
    opt.update(opt.init(p), p)
    np.testing.assert_allclose(p["w"].detach().numpy(), (1 - 1e-4) * np.ones(4), rtol=1e-6)


def test_text_corpus_and_lm_batches_are_bit_identical(tmp_path):
    ids, vocab, src = datasets.text_corpus(None, vocab_size=50, synth_tokens=5000, seed=3)
    jids, jvocab, jsrc = jax_datasets.text_corpus(None, vocab_size=50, synth_tokens=5000, seed=3)
    assert src == jsrc == "synthetic" and vocab == jvocab
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == jids.dtype == np.int32
    (tmp_path / "corpus.txt").write_text("the cat sat on the mat the end " * 20)
    fids, fvocab, fsrc = datasets.text_corpus(str(tmp_path), vocab_size=5)
    jfids, jfvocab, jfsrc = jax_datasets.text_corpus(str(tmp_path), vocab_size=5)
    np.testing.assert_array_equal(fids, jfids)
    assert fvocab == jfvocab and fsrc == jfsrc
    ours = datasets.lm_batches(ids, batch_size=3, seq_len=40)
    theirs = jax_datasets.lm_batches(jids, batch_size=3, seq_len=40)
    for _ in range(50):  # past the wrap-around of each row's stream
        a, b = next(ours), next(theirs)
        for k in ("x", "y"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def _fresh_state(tcfg, seed=0, lr=LR):
    _, topt = _optimizers(lr=lr)
    return state.create_state(lambda s: torch_tf.init_numpy(tcfg, s), topt, seed, "cpu"), topt


def test_remat_and_unroll_match_the_plain_step():
    """remat recomputes blocks in the backward (same numbers); unroll=2
    over a stacked super-batch is two single steps."""
    _, tcfg = _configs(attention="flash", compute_dtype="float32")
    batches = [_torch_batch(b) for b in _batches(2)]
    base, topt = _fresh_state(tcfg)
    single = step.build_train_step(torch_tf.loss_fn(tcfg), topt)
    for b in batches:
        base, m_single = single(base, b)
    remat, _ = _fresh_state(tcfg)
    rstep = step.build_train_step(
        torch_tf.loss_fn(dataclasses.replace(tcfg, remat=True)), topt
    )
    for b in batches:
        remat, _ = rstep(remat, b)
    unrolled, _ = _fresh_state(tcfg)
    ustep = step.build_train_step(torch_tf.loss_fn(tcfg), topt, unroll=2)
    super_batch = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    unrolled, m_unrolled = ustep(unrolled, super_batch)
    assert base.step == remat.step == unrolled.step == 2
    assert float(m_unrolled["loss"]) == float(m_single["loss"])
    for (path, a), b, c in zip(bridge._leaves(base.params), state.leaves(remat.params),
                               state.leaves(unrolled.params)):
        assert torch.equal(a, b), path
        assert torch.equal(a, c), path


def test_eval_step_reports_metrics_without_autograd():
    _, tcfg = _configs()
    s, _ = _fresh_state(tcfg)
    loss_fn = torch_tf.loss_fn(tcfg)
    evaluate = step.build_eval_step(lambda p, ms, b: loss_fn(p, ms, b, None)[1][1])
    batch = _torch_batch(_batches(1)[0])
    metrics = evaluate(s, batch)
    want, _ = loss_fn(s.params, {}, batch, None)
    assert float(metrics["loss"]) == float(want.detach())
    assert not metrics["loss"].requires_grad
    assert all(p.grad is None for p in state.leaves(s.params))


def test_params_are_separate_leaves():
    _, tcfg = _configs()
    _total, unflatten = bridge.flat_param_spec(torch_tf.param_shapes(tcfg))
    views = unflatten(bridge.flat_params_of(torch_tf.init_numpy(tcfg, 1)), "cpu")
    s, _ = _fresh_state(tcfg)
    s2 = state.create_state(lambda seed: views, optim.ClippedAdamW(LR, 1.0), 0, "cpu")
    ptrs = [p.untyped_storage().data_ptr() for p in state.leaves(s2.params)]
    assert len(set(ptrs)) == len(ptrs)
    assert all(p.requires_grad and p.is_leaf for p in state.leaves(s2.params))
    assert s.seed == 0 and s.step == 0


def _flags(tmp, steps, **kw):
    args = cli.build_parser().parse_args([
        "--device=cpu", "--vocab_size=64", "--dim=64", "--n_layers=2",
        "--n_heads=4", "--seq_len=64", "--batch_size=4", f"--train_steps={steps}",
        "--log_every_steps=1", "--checkpoint_every_steps=1000",
        f"--log_dir={tmp}", "--learning_rate=1e-3", "--attention=flash",
    ])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _experiment(args):
    cfg = cli.config_from_args(args)
    return Experiment(
        init_fn=lambda seed: torch_tf.init_numpy(cfg, seed),
        loss_fn=torch_tf.loss_fn(cfg),
        optimizer=optim.ClippedAdamW(LR, 1.0),
        flags=args,
    )


def test_checkpoint_auto_resume_equals_a_straight_run(tmp_path):
    """2 steps, then a rerun of the same log_dir to 4, against 4 straight
    steps on the same (constant) batch: the whole state round-trips."""
    batch = _batches(1)[0]
    first = _experiment(_flags(tmp_path / "resumed", 2))
    first.run(itertools.repeat(batch))
    first.finish()
    assert checkpoint.CheckpointManager(str(tmp_path / "resumed" / "ckpt")).latest_step() == 2
    second = _experiment(_flags(tmp_path / "resumed", 4))
    second.run(itertools.repeat(batch))
    assert second.session.records["resumed_at"] == 2
    straight = _experiment(_flags(tmp_path / "straight", 4))
    straight.run(itertools.repeat(batch))
    assert second.state.step == straight.state.step == 4
    for (path, a), b in zip(bridge._leaves(second.state.params),
                            state.leaves(straight.state.params)):
        assert torch.equal(a, b), path
    assert all(s["step"] == 4 for s in second.state.opt_state.state.values())
    # A rerun at the target stops before any step (StopAtStepHook.begin).
    third = _experiment(_flags(tmp_path / "resumed", 4))
    third.run(itertools.repeat(batch))
    assert third.session.step == 4


def test_checkpoint_torn_newest_step_resumes_from_the_one_before(tmp_path):
    """A newest step whose file does not load (torn by a disk fault) is
    moved aside and the run resumes from the step before it; when no step
    loads, the restore raises instead of starting over."""
    batch = _batches(1)[0]
    first = _experiment(_flags(tmp_path, 2, checkpoint_every_steps=1))
    first.run(itertools.repeat(batch))
    first.finish()
    ckpt = tmp_path / "ckpt"
    newest = ckpt / "2" / checkpoint._FILE
    newest.write_bytes(newest.read_bytes()[: newest.stat().st_size // 2])
    second = _experiment(_flags(tmp_path, 3, checkpoint_every_steps=1))
    second.run(itertools.repeat(batch))
    assert second.session.records["resumed_at"] == 1
    assert second.state.step == 3
    assert (ckpt / ".unreadable-2").is_dir()
    mgr = checkpoint.CheckpointManager(str(ckpt))
    assert mgr.all_steps() == [1, 2, 3]
    for step_no in mgr.all_steps():
        (ckpt / str(step_no) / checkpoint._FILE).write_bytes(b"")
    with pytest.raises(RuntimeError, match="no checkpoint"):
        mgr.restore_latest(second.state)


def test_cli_trains_prints_final_and_publishes(tmp_path, capsys):
    registry = tmp_path / "registry"
    args = _flags(tmp_path / "run", 3, registry_dir=str(registry))
    exp = cli.run_training(args)
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("FINAL ")]
    assert line and re.search(r"FINAL step=3 steps_per_sec=\S+ "
                              r"examples_per_sec_per_chip=\S+ final_perplexity=\S+", line[0])
    reg = ModelRegistry(str(registry))
    got_step, flat, _manifest = reg.load("transformer_lm", exp.published_version)
    assert got_step == 3
    _total, unflatten = bridge.flat_param_spec(torch_tf.param_shapes(cli.config_from_args(args)))
    for (path, want), got in zip(bridge._leaves(exp.state.params),
                                 state.leaves(unflatten(flat))):
        assert torch.equal(want.detach(), got), path
    # The same step published again, from the checkpoint the run left.
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run" / "ckpt"))
    v2 = reg.publish_from_checkpoint(mgr, exp.state, "transformer_lm")
    np.testing.assert_array_equal(reg.load("transformer_lm", v2)[1], flat)


@pytest.mark.parametrize(
    "extra,error,match",
    [
        (["--pipeline_stages=2"], ValueError, "n_layers=1 not divisible by pipeline_stages=2"),
        (["--moe_experts=4", "--pipeline_stages=2", "--n_layers=2"], ValueError, "compose"),
        (["--mesh=data=2"], ValueError, "needs 2 devices, have 1"),
    ],
    # Stable case ids: the data=2 case raised NotImplementedError (A5)
    # while the port ran on one device only, and the stages case (A8b-2b)
    # until the pipeline came; it now meets JAX init's refusal of stages
    # that do not divide the layers.
    ids=["extra0-model-parallel", "extra1-model-parallel", "extra2-A5"],
)
def test_cli_refuses_what_later_slices_bring(extra, error, match, tmp_path, capsys):
    with pytest.raises(error, match=match):
        cli.main(["--device=cpu", "--vocab_size=64", "--dim=64", "--n_layers=1",
                  "--n_heads=4", "--seq_len=16", "--train_steps=1", *extra])
    # A PS task has nothing to do: it prints and exits 0, as the JAX CLI does.
    assert cli.main(["--job_name=ps", "--device=cpu"]) == 0
    assert "parameter servers are not needed" in capsys.readouterr().out


def test_preemption_hook_saves_and_stops(tmp_path):
    _, tcfg = _configs()
    s, topt = _fresh_state(tcfg)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    hook = preemption.PreemptionCheckpointHook(mgr)
    session = loop.TrainSession(
        step.build_train_step(torch_tf.loss_fn(tcfg), topt), s,
        hooks=[hooks.StopAtStepHook(100), hook], checkpoint_manager=mgr,
    )
    batch = _torch_batch(_batches(1)[0])

    def batches():
        for i in itertools.count():
            if i == 1:
                hook.trigger()
            yield batch

    session.run(batches())
    assert session.step == 2 and mgr.latest_step() == 2
    restored = mgr.restore_latest(s)
    assert restored.step == 2
    # The JAX hook's window (steps 10-15): outside it the hook records and
    # writes nothing.
    prof = hooks.ProfilerHook(str(tmp_path / "prof"))
    assert (prof.start, prof.stop) == (10, 15)
    prof.before_step(session)
    prof.end(session)
    assert not prof._active and prof.trace_path is None
    assert not (tmp_path / "prof").exists()


def test_pipeline_stacks_and_prefetches():
    it = iter(_batches(4, batch=2, seq_len=8))
    stacked = pipeline.stack_for_unroll(it, 2)
    got = list(pipeline.prefetch_to_device(itertools.islice(stacked, 2), "cpu"))
    assert len(got) == 2 and tuple(got[0]["x"].shape) == (2, 2, 8)
    assert got[0]["x"].dtype == torch.int32


def _noisy_losses():
    """A loss that draws ``uniform(rng, (4,))``, in each package: the
    loss, and the draw's first value as a metric."""

    def jloss(params, mstate, batch, rng):
        u = jax.random.uniform(rng, (4,))
        loss = jax.numpy.sum(params["w"] * u) * jax.numpy.mean(batch["x"])
        return loss, (mstate, {"loss": loss, "u0": u[0]})

    def tloss(params, mstate, batch, rng):
        u = threefry.uniform(rng, (4,))
        loss = (params["w"] * u).sum() * batch["x"].mean()
        return loss, (mstate, {"loss": loss.detach(), "u0": u[0]})

    return jloss, tloss


@pytest.mark.parametrize("grad_accum,unroll", [(1, 1), (2, 1), (1, 2)])
def test_the_step_hands_the_loss_the_jax_key(grad_accum, unroll):
    """The C4 repair: a loss that draws noise from ``rng`` sees the JAX
    step's key (``fold_in(key(seed), step)``; under accumulation the
    ``split`` chain; under unroll each sub-step's own fold), so the
    per-step losses, draws and parameters agree."""
    jloss, tloss = _noisy_losses()
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(4).astype(np.float32)
    batches = [{"x": rng.standard_normal((4, 3)).astype(np.float32)} for _ in range(4)]
    if unroll > 1:
        batches = [{"x": np.stack([batches[i]["x"], batches[i + 1]["x"]])} for i in (0, 2)]
    jopt = optax.sgd(0.1)
    js = jax_state.create_state(lambda r: {"w": jax.numpy.asarray(w0)}, jopt, jax.random.key(5))
    jstep = jax_step.build_train_step(jloss, jopt, grad_accum=grad_accum, unroll=unroll)
    ts = state.create_state(lambda seed: {"w": w0}, optim.SGD(0.1), 5, "cpu")
    tstep = step.build_train_step(tloss, optim.SGD(0.1), grad_accum=grad_accum, unroll=unroll)
    for b in batches:
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _torch_batch(b))
        assert float(tm["u0"]) == float(jm["u0"])
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(ts.params["w"].detach().numpy(), np.asarray(js.params["w"]),
                               rtol=0, atol=1e-6)


def test_evaluate_hands_the_loss_the_jax_key():
    """``Experiment.evaluate``'s default eval hands the loss ``key(0)``, as
    the JAX ``Experiment.evaluate`` does."""
    jloss, tloss = _noisy_losses()
    w0 = np.arange(1, 5, dtype=np.float32)
    x = np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32)
    flags = types.SimpleNamespace(
        seed=3, mesh="", unroll=1, grad_accum=1, log_dir=None, train_steps=1,
        log_every_steps=1, checkpoint_every_steps=100, batch_size=8, watchdog=False,
        device="cpu",
    )  # one batch of 8 rows: the JAX eval rounds its batch to the 8-device test mesh
    jexp = jax_train.Experiment(init_fn=lambda r: {"w": jax.numpy.asarray(w0)}, loss_fn=jloss,
                                optimizer=optax.sgd(0.1), flags=flags)
    texp = Experiment(init_fn=lambda seed: {"w": w0}, loss_fn=tloss,
                      optimizer=optim.SGD(0.1), flags=flags)
    want, got = jexp.evaluate({"x": x}), texp.evaluate({"x": x})
    assert got.keys() == want.keys() == {"loss", "u0"}
    assert got["u0"] == want["u0"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    jexp.writer.close()
    texp.writer.close()
