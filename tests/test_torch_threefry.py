"""The port's threefry generator and initial weights against JAX's.

``utils/threefry.py`` copies ``jax.random``'s default generator in its
partitionable mode.  Held to JAX here: the key of a seed, the random bits,
``split``, ``fold_in``, ``uniform`` and ``bernoulli`` bit for bit;
``normal`` and ``truncated_normal`` within ``NORMAL_ULPS`` float32 ulps
(XLA evaluates the same erf_inv polynomial and its log1p in its own
order: seen 3 for each; the truncated draw's bounds ``erf(+-2/sqrt(2))``
are JAX's to the bit); ``gumbel`` within ``GUMBEL_ATOL`` (torch's log
against XLA's: seen 4.8e-7 at |g| up to 15) and ``categorical`` equal.
Then the port's transformer and ResNet ``init_numpy(cfg, seed)`` against
the JAX ``init(cfg, jax.random.key(seed))`` leaf by leaf (uniform leaves
bitwise, normal leaves within ``NORMAL_ULPS``), and the port's
``Experiment`` against the JAX ``Experiment`` at the same ``--seed``.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.models import resnet as jax_resnet
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import resnet as torch_resnet
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.train import Experiment, optim
from distributed_tensorflow_examples_tpu_torch.utils import threefry
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

torch.set_num_threads(1)

NORMAL_ULPS = 4
GUMBEL_ATOL = 2e-6
SEEDS = [0, 42, -3, 2**33 + 5]
SHAPES = [(7,), (3, 5), (2, 3, 4)]


@pytest.fixture(autouse=True)
def _no_tensorboard_events(monkeypatch):
    """No test here reads an event file: the runs write metrics.jsonl only
    (a TensorBoard writer's first import pulls in TensorFlow, seconds a
    process)."""
    monkeypatch.setattr(MetricsWriter, "__init__",
                        functools.partialmethod(MetricsWriter.__init__, tensorboard=False))


def _ulps(a, b) -> int:
    """The largest distance in float32 steps between two arrays of one
    sign pattern (normal draws here never straddle zero apart)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_and_uniform_are_jax_bit_for_bit(seed):
    jkey = jax.random.key(seed)
    key = threefry.key(seed)
    assert key == tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))
    want = [tuple(int(w) for w in row)
            for row in np.asarray(jax.random.key_data(jax.random.split(jkey, 5)))]
    assert threefry.split(key, 5) == want
    for shape in SHAPES:
        bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(threefry.random_bits(key, shape).numpy(), bits)
        for lo, hi in [(-0.3, 0.7), (-0.21650635, 0.21650635)]:
            got = threefry.uniform(key, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_normal_gumbel_and_categorical_follow_jax(seed):
    jkey, key = jax.random.key(seed), threefry.key(seed)
    shape = (300, 117)  # two chunks of the CPU draw, the second ragged
    assert _ulps(threefry.normal(key, shape).numpy(), jax.random.normal(jkey, shape)) \
        <= NORMAL_ULPS
    np.testing.assert_allclose(threefry.gumbel(key, shape).numpy(),
                               np.asarray(jax.random.gumbel(jkey, shape)),
                               rtol=0, atol=GUMBEL_ATOL)
    logits = np.random.default_rng(seed % 2**32).standard_normal((40, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        threefry.categorical(key, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(jkey, logits)),
    )


def _same_tree(port, jax_tree, *, normal_paths):
    """Leaf by leaf in ``jax.tree`` order: bitwise, or within NORMAL_ULPS
    for the paths drawn from a normal."""
    ours, theirs = list(bridge._leaves(port)), list(bridge._leaves(jax_tree))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        b = np.asarray(b)
        assert a.dtype == np.float32 and a.shape == b.shape, path
        if normal_paths(path):
            assert _ulps(a, b) <= NORMAL_ULPS, path
        else:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=path)


@pytest.mark.parametrize("seed", [0, 11])
def test_transformer_init_numpy_is_the_jax_init(seed):
    kw = dict(vocab_size=96, dim=48, n_layers=3, n_heads=4, max_seq_len=40)
    jinit = jax.jit(functools.partial(jax_tf.init, jax_tf.Config(**kw)))
    want = jax.device_get(jinit(jax.random.key(seed)))
    got = torch_tf.init_numpy(torch_tf.Config(**kw), seed, device="cpu")
    _same_tree(got, want, normal_paths=lambda p: p == "pos/table")


def test_resnet_init_numpy_is_the_jax_init():
    kw = dict(stage_sizes=(1, 1), width=8, num_classes=10)
    jinit = jax.jit(functools.partial(jax_resnet.init, jax_resnet.Config(**kw)))
    jparams, jstate = jax.device_get(jinit(jax.random.key(3)))
    params, state = torch_resnet.init_numpy(torch_resnet.Config(**kw), 3, device="cpu")
    _same_tree(params, jparams, normal_paths=lambda p: p != "head/kernel"
               and p.endswith("kernel"))
    _same_tree(state, jstate, normal_paths=lambda p: False)


def test_experiments_start_from_the_same_weights_at_one_seed():
    """The JAX ``Experiment`` hands ``jax.random.key(flags.seed)`` to the
    init unchanged (its state equals ``init(cfg, key(seed))``; the jitted
    init rounds the normal leaf apart from the eager one by up to an ulp),
    and the port's ``Experiment`` with ``init_numpy`` starts from those
    weights."""
    kw = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_seq_len=16)
    jcfg, tcfg = jax_tf.Config(**kw), torch_tf.Config(**kw)
    flags = types.SimpleNamespace(
        seed=7, mesh="", unroll=1, grad_accum=1, log_dir=None, train_steps=1,
        log_every_steps=1, checkpoint_every_steps=100, batch_size=2,
        watchdog=False, device="cpu",
    )
    jexp = jax_train.Experiment(
        init_fn=lambda rng: jax_tf.init(jcfg, rng), loss_fn=jax_tf.loss_fn(jcfg),
        optimizer=optax.adamw(1e-3), flags=flags,
    )
    jparams = jax.tree.map(np.asarray, jax.device_get(jexp.state.params))
    jinit = jax.jit(functools.partial(jax_tf.init, jcfg))
    direct = jax.device_get(jinit(jax.random.key(flags.seed)))
    _same_tree(jparams, direct, normal_paths=lambda p: p == "pos/table")
    texp = Experiment(
        init_fn=lambda seed: torch_tf.init_numpy(tcfg, seed),
        loss_fn=torch_tf.loss_fn(tcfg), optimizer=optim.ClippedAdamW(1e-3, 1.0),
        flags=flags,
    )
    got = jax.tree.map(lambda t: t.detach().numpy(), texp.state.params)
    _same_tree(got, jparams, normal_paths=lambda p: p == "pos/table")
    texp.writer.close()
    jexp.writer.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_bernoulli_are_jax_bit_for_bit(seed):
    jkey, key = jax.random.key(seed), threefry.key(seed)
    fold = jax.jit(jax.random.fold_in)  # as the train step folds its int32 step
    for data in (0, 1, 7, 12345, 2**31 - 1):
        want = tuple(int(w) for w in np.asarray(jax.random.key_data(fold(jkey, data))))
        assert threefry.fold_in(key, data) == want
    top = tuple(int(w) for w in np.asarray(jax.random.key_data(jax.random.fold_in(jkey, 2**32 - 1))))
    assert threefry.fold_in(key, 2**32 - 1) == top
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(threefry.bernoulli(key, p, (40, 50)).numpy(),
                                      np.asarray(jax.random.bernoulli(jkey, p, (40, 50))))


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0), (0.5, 1.5)])
def test_truncated_normal_follows_jax(seed, bounds):
    lo, hi = bounds
    shape = (300, 117)
    want = np.asarray(jax.jit(lambda k: jax.random.truncated_normal(k, lo, hi, shape))(
        jax.random.key(seed)))
    got = threefry.truncated_normal(threefry.key(seed), lo, hi, shape).numpy()
    assert _ulps(got, want) <= NORMAL_ULPS
    assert got.min() > lo and got.max() < hi
