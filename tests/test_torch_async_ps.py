"""The port's PS emulation (``native/``, ``parallel/async_ps.py``) against the
JAX package's.

The native services first: the JAX suite's behaviour table run against the
port's own library, and one sequence of every blocking and gating call run
on both bindings with the results compared bit for bit (the two libraries
compile one source).  Then the trainer, in float32 on the CPU (the JAX
trainer's MLP at hidden 16 on its synthetic blobs, the same initial
parameters carried across as numpy): sync mode on a constant batch is plain
SGD, bit for bit in the port and within the tolerance below of the JAX
trainer; the fixed interleave reproduces the JAX schedule (``apply_log``
and the ``(worker, step)`` of every gradient equal, losses and parameters
within the tolerance); the staleness gate, worker failures and the
starvation guard behave as in JAX; a cut-and-resumed run restores its state
bit for bit and, under the fixed interleave, matches the JAX trainer cut
at the same step.

Tolerances (float32): losses 1e-5 relative and parameters rtol 1e-5, atol
1e-7 — the two frameworks' matmuls sum in other orders (~1e-7 relative a
gradient), and 20 applies at learning rate 0.1 carry that forward.
"""

import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu import native as jax_native
from distributed_tensorflow_examples_tpu.parallel import async_ps as jax_async_ps
from distributed_tensorflow_examples_tpu_torch import bridge, native
from distributed_tensorflow_examples_tpu_torch.models import mlp
from distributed_tensorflow_examples_tpu_torch.parallel.async_ps import (
    AsyncPSConfig,
    AsyncPSTrainer,
)
from distributed_tensorflow_examples_tpu_torch.train import optim

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 1e-5, 1e-7, 1e-5
JCFG = jax_models.mlp.Config(hidden=(16,), compute_dtype="float32")
PCFG = mlp.Config(hidden=(16,), compute_dtype="float32")


# ----------------------------------------------------------------------------
# Native services
# ----------------------------------------------------------------------------


def _taker(acc, n, out):
    t = threading.Thread(target=lambda: out.setdefault("v", acc.take(n)), daemon=True)
    t.start()
    return t


def _acc_averages_and_resets():
    acc = native.GradientAccumulator(3)
    acc.apply(0, np.array([1.0, 2.0, 3.0]))
    acc.apply(0, np.array([3.0, 2.0, 1.0]))
    np.testing.assert_allclose(acc.take(2), [2.0, 2.0, 2.0])
    assert acc.pending == 0 and acc.last_count == 2  # reset after take


def _acc_drops_stale():
    acc = native.GradientAccumulator(2)
    acc.set_global_step(5)
    assert not acc.apply(4, np.ones(2))  # local_step < global_step -> dropped
    assert acc.dropped == 1
    assert acc.apply(5, np.ones(2))  # equal is fresh (ref semantics)


def _acc_take_blocks_until_enough():
    acc = native.GradientAccumulator(1)
    acc.apply(0, np.array([1.0]))
    out = {}
    t = _taker(acc, 2, out)
    time.sleep(0.05)
    assert "v" not in out  # still blocked on the second grad
    acc.apply(0, np.array([3.0]))
    t.join(2)
    assert not t.is_alive()
    np.testing.assert_allclose(out["v"], [2.0])


def _acc_take_averages_extras():
    acc = native.GradientAccumulator(1)
    for v in (1.0, 2.0, 6.0):
        acc.apply(0, np.array([v]))
    np.testing.assert_allclose(acc.take(2), [3.0])
    assert acc.last_count == 3


def _token_queue_fifo_and_cancel():
    tq = native.TokenQueue()
    tq.push(1, 2)
    tq.push(2, 1)
    assert [tq.pop(), tq.pop(), tq.pop()] == [1, 1, 2]
    tq.cancel()
    assert tq.pop() is None


def _cancel_unblocks_take():
    acc = native.GradientAccumulator(1)
    out = {}
    t = _taker(acc, 1, out)
    time.sleep(0.05)
    acc.cancel()
    t.join(2)
    assert not t.is_alive()
    assert out["v"] is None


def _gradient_queue_fifo_no_coalescing():
    gq = native.GradientQueue(2)
    gq.push(0, np.array([1.0, 1.0]))
    gq.push(1, np.array([2.0, 2.0]))
    (s0, g0), (s1, g1) = gq.pop(), gq.pop()
    assert (s0, s1) == (0, 1)
    np.testing.assert_allclose(g0, [1.0, 1.0])
    np.testing.assert_allclose(g1, [2.0, 2.0])
    gq.set_min_step(5)
    assert not gq.push(4, np.ones(2))  # stale
    assert gq.dropped == 1
    assert gq.push(5, np.ones(2))
    assert len(gq) == 1
    gq.cancel()
    gq.pop()  # drains the remaining item
    assert gq.pop() is None


@pytest.mark.parametrize("case", [
    _acc_averages_and_resets, _acc_drops_stale, _acc_take_blocks_until_enough,
    _acc_take_averages_extras, _token_queue_fifo_and_cancel, _cancel_unblocks_take,
    _gradient_queue_fifo_no_coalescing,
], ids=lambda f: f.__name__.strip("_"))
def test_native_service(case):
    """The JAX suite's service table (``tests/test_async_ps.py``) on the
    port's library."""
    case()


def _service_sequence(lib):
    """apply, take, push, pop, set_min_step and cancel on ``lib``'s
    wrappers; every result as bytes or numbers."""
    rng = np.random.default_rng(7)
    g = [rng.normal(size=1000).astype(np.float32) for _ in range(5)]
    out = []
    acc = lib.GradientAccumulator(1000)
    acc.set_global_step(2)
    out += [acc.apply(1, g[0]), acc.apply(2, g[1]), acc.apply(3, g[2]), acc.apply(2, g[3])]
    out += [acc.take(3).tobytes(), acc.dropped, acc.pending]
    out.append(acc.take(1, timeout_s=0.01) is lib.TIMED_OUT)
    out += [acc.apply_tagged(2, 1, 0, g[4]), acc.apply_tagged(2, 1, 0, g[4]), acc.deduped]
    acc.cancel()
    out.append(acc.take(1))
    gq = lib.GradientQueue(1000, capacity=4)
    out += [gq.push(0, g[0]), gq.push(3, g[1])]
    gq.set_min_step(2)
    out += [gq.push(1, g[2]), gq.push(2, g[3]), gq.dropped, len(gq)]
    out += [(s, a.tobytes()) for s, a in (gq.pop(), gq.pop(), gq.pop())]
    out.append(gq.pop(timeout_s=0.01) is lib.TIMED_OUT)
    gq.cancel()
    out += [gq.pop(), gq.push(5, g[4])]
    tq = lib.TokenQueue()
    tq.push(4, 2)
    out += [tq.pop(), len(tq), tq.pop(), tq.pop(timeout_s=0.01) is lib.TIMED_OUT]
    tq.cancel()
    out += [tq.pop(), lib._tag(3, 9)]
    return out


def test_native_services_agree_with_the_jax_binding_bitwise():
    assert _service_sequence(native) == _service_sequence(jax_native)


# ----------------------------------------------------------------------------
# The trainer against the JAX trainer (MLP on the JAX suite's blobs, f32)
# ----------------------------------------------------------------------------


def _blob_batches(seed, batch=32):
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(0).normal(size=(10, 784)).astype(np.float32)
    while True:
        y = rng.integers(0, 10, size=batch).astype(np.int32)
        x = protos[y] + 0.1 * rng.normal(size=(batch, 784)).astype(np.float32)
        yield {"image": x, "label": y}


def _init():
    return jax.tree.map(np.asarray, jax_models.mlp.init(JCFG, jax.random.key(0)))


def _port(mode, steps=30, workers=2, lr=0.1, optimizer=None, **kw):
    cfg = AsyncPSConfig(num_workers=workers, mode=mode, train_steps=steps, **kw)
    return AsyncPSTrainer(cfg, mlp.loss_fn(PCFG), optimizer or optim.SGD(lr), _init(),
                          seed=0, device="cpu")


def _jax(mode, steps=30, workers=2, lr=0.1, optimizer=None, **kw):
    cfg = jax_async_ps.AsyncPSConfig(num_workers=workers, mode=mode, train_steps=steps, **kw)
    return jax_async_ps.AsyncPSTrainer(
        cfg, jax_models.mlp.loss_fn(JCFG), optimizer or optax.sgd(lr), _init(),
        rng=jax.random.key(0),
    )


def _leaves(params):
    return [np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
            for _path, leaf in bridge._leaves(params)]


def _leaves_t(params):
    return [leaf for _path, leaf in bridge._leaves(params)]


def _assert_params_close(port_params, jax_params):
    for a, b in zip(_leaves(port_params), _leaves(jax_params), strict=True):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_sync_replicas_matches_sequential_sgd_and_jax():
    """Every worker fed the SAME constant batch: any mix of contributions
    averages to grad(batch), so sync-replicas is sequential SGD bit for bit
    whichever worker each token lands on (token assignment is racy by
    design), and the JAX trainer on the same setup agrees."""
    steps = 6
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(10, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)
    batch = {"image": protos[y] + 0.1 * rng.normal(size=(16, 784)).astype(np.float32),
             "label": y}

    def repeat_batch():
        while True:
            yield batch

    tr = _port("sync_replicas", steps=steps)
    tr.run([repeat_batch(), repeat_batch()])
    assert tr.global_step == steps

    params = bridge.params_from_numpy(_init())
    leaves = [p.requires_grad_() for p in _leaves_t(params)]
    sgd = optim.SGD(0.1)
    opt_state = sgd.init(params)
    loss_fn = mlp.loss_fn(PCFG)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(steps):
        loss_fn(params, {}, tb, None)[0].backward()
        sgd.update(opt_state, params, i)
        for p in leaves:
            p.grad = None
    for a, b in zip(_leaves(tr.params), _leaves(params), strict=True):
        assert np.array_equal(a, b)

    jt = _jax("sync_replicas", steps=steps)
    jt.run([repeat_batch(), repeat_batch()])
    _assert_params_close(tr.params, jt.params)


@pytest.mark.parametrize("variant", ["plain", "max_staleness", "warmup"])
def test_fixed_interleave_matches_jax(variant):
    """2 workers, 20 applies on the fixed round-robin schedule: the same
    schedule, the same gradients' steps, losses and parameters within the
    tolerance.  Also with ``max_staleness = n - 1`` and with the CIFAR
    CLI's warmup ``linear_schedule``."""
    kw = {"fixed_interleave": True}
    port_opt = jax_opt = None
    if variant == "max_staleness":
        kw["max_staleness"] = 1
    if variant == "warmup":
        port_opt = optim.SGD(optim.linear_schedule(0.01, 0.1, 5))
        jax_opt = optax.sgd(optax.linear_schedule(0.01, 0.1, 5))
    tr = _port("async", steps=20, optimizer=port_opt, **kw)
    tr.run([_blob_batches(1), _blob_batches(2)])
    jt = _jax("async", steps=20, optimizer=jax_opt, **kw)
    jt.run([_blob_batches(1), _blob_batches(2)])
    assert tr.global_step == jt.global_step == 20
    assert tr.apply_log == jt.apply_log
    assert [h[:2] for h in tr.history] == [h[:2] for h in jt.history]
    np.testing.assert_allclose([h[2] for h in tr.history], [h[2] for h in jt.history],
                               rtol=LOSS_RTOL)
    _assert_params_close(tr.params, jt.params)
    # Genuinely stale applies, as in JAX: all but the first gradient.
    assert sum(applied - computed >= 1 for _w, computed, applied, _d in tr.apply_log) >= 19


def test_fixed_interleave_is_bitwise_reproducible():
    runs = []
    for _ in range(2):
        tr = _port("async", steps=12, lr=0.02, fixed_interleave=True)
        tr.run([_blob_batches(1), _blob_batches(2)])
        runs.append(tr)
    a, b = runs
    assert [h[2] for h in a.history] == [h[2] for h in b.history]
    for x, y in zip(_leaves(a.params), _leaves(b.params), strict=True):
        assert np.array_equal(x, y)


def test_threaded_modes_train():
    """Free-running threads, both modes: every applied step lands, and the
    loss falls (W1 and W2 semantics on the blobs)."""
    for mode, lr in (("async", 0.02), ("sync_replicas", 0.1)):
        tr = _port(mode, steps=25, lr=lr)
        tr.run([_blob_batches(1), _blob_batches(2)])
        assert tr.global_step == 25
        losses = [l for (_w, _s, l) in tr.history]
        assert losses[-1] < losses[0], (mode, losses[0], losses[-1])


def test_async_staleness_bound_drops_deterministically():
    """max_staleness=0: one chief iteration by hand (pop -> apply ->
    set_min_step, ``_chief_async``'s body), then a gradient computed
    against the pre-apply snapshot MUST drop."""
    tr = _port("async", steps=3, max_staleness=0, lr=0.02)
    g = np.zeros(tr.num_elems, np.float32)
    assert tr._gq.push(0, g)  # fresh: snapshot step == global step == 0
    _, flat = tr._gq.pop()
    tr._apply_update(flat)  # global_step -> 1
    tr._gq.set_min_step(tr.global_step - tr.cfg.max_staleness)
    assert not tr._gq.push(0, g)  # stale snapshot: deterministically dropped
    assert tr._gq.dropped == 1
    assert tr._gq.push(1, g)  # fresh snapshot passes the gate


@pytest.mark.parametrize("mode", ["async", "sync_replicas"])
def test_worker_exception_propagates(mode):
    """A worker crash must not strand the chief in a blocking take/pop:
    run() raises instead of hanging."""

    def poison():
        raise RuntimeError("boom")
        yield  # pragma: no cover

    tr = _port(mode, steps=50, lr=0.02)
    done = {}

    def run():
        try:
            tr.run([_blob_batches(1), poison()])
        except RuntimeError as e:
            done["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert "worker 1" in str(done["exc"]) and "boom" in str(done["exc"].__cause__)


def test_fixed_interleave_rejects_starving_staleness():
    tr = _port("async", steps=10, workers=3, fixed_interleave=True, max_staleness=1)
    with pytest.raises(ValueError, match="starve"):
        tr.run([_blob_batches(1), _blob_batches(2), _blob_batches(3)])


def test_checkpoint_resume_restores_bitwise(tmp_path):
    """A threaded run cut at step 6 and resumed: params, the momentum
    buffers, the step (the schedule's count) come back bit for bit, and
    the run reaches its new target; a finished target returns at once."""
    d = str(tmp_path / "ps_ckpt")
    sched = optim.linear_schedule(0.002, 0.02, 8)

    def trainer(steps):
        return _port("async", steps=steps, optimizer=optim.SGD(sched, momentum=0.9),
                     ckpt_dir=d, checkpoint_every=3)

    tr = trainer(6)
    tr.run([_blob_batches(1), _blob_batches(2)])
    assert tr.global_step == 6
    tr2 = trainer(10)
    assert tr2.restore_latest() and tr2.global_step == 6
    for a, b in zip(_leaves(tr.params), _leaves(tr2.params), strict=True):
        assert np.array_equal(a, b)
    s1, s2 = tr.opt_state.state_dict(), tr2.opt_state.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for k in s1["state"]:
        assert torch.equal(s1["state"][k]["momentum_buffer"], s2["state"][k]["momentum_buffer"])
    _w, _b, snap_step = tr2._snapshot()
    assert snap_step == 6
    snap = tr2._snapshot()[0]
    for a, b in zip(_leaves(snap), _leaves(tr2.params), strict=True):
        assert np.array_equal(a, b)  # the published snapshot is the restored state
    tr2.run([_blob_batches(3), _blob_batches(4)])
    assert tr2.global_step == 10
    tr3 = trainer(10)
    tr3.run([_blob_batches(5), _blob_batches(6)])
    assert tr3.global_step == 10 and not tr3.history


def test_fixed_interleave_cut_and_resumed_matches_jax(tmp_path):
    """Both trainers cut at step 7 and resumed to 16: each recomputes its
    pending gradients at the restored params, and the two agree."""
    out = {}
    for name, make in (("port", _port), ("jax", _jax)):
        d = str(tmp_path / name)
        for steps in (7, 16):
            tr = make("async", steps=steps, lr=0.05, fixed_interleave=True, ckpt_dir=d,
                      checkpoint_every=100)
            tr.run([_blob_batches(1), _blob_batches(2)])
        out[name] = tr
    port, jt = out["port"], out["jax"]
    assert port.global_step == jt.global_step == 16
    assert port.apply_log == jt.apply_log and port.apply_log[0][1:3] == (7, 7)
    np.testing.assert_allclose([h[2] for h in port.history], [h[2] for h in jt.history],
                               rtol=LOSS_RTOL)
    _assert_params_close(port.params, jt.params)


def test_linear_schedule_is_optax_bitwise():
    for init, end, steps in ((0.005, 0.05, 20), (0.01, 0.1, 7), (1e-3, 0.3, 13), (0.2, 0.0, 9)):
        ours, ref = optim.linear_schedule(init, end, steps), optax.linear_schedule(init, end, steps)
        for count in range(41):
            assert np.float32(ours(count)).tobytes() == np.asarray(ref(count), np.float32).tobytes()
    assert optim.linear_schedule(0.3, 0.1, 0)(5) == 0.3  # optax: constant


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s own message, leaves
    no library (nor a temporary file) behind, and nothing falls back."""
    broken = tmp_path / "accumulator.cc"
    broken.write_text('extern "C" int acc_new( {\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"native build failed[\s\S]*error"):
        native.build()
    assert not list((tmp_path / "build").iterdir())
