"""The port's KV-cache decode and decode serving against the JAX package's.

A tiny transformer drawn by JAX ``init``; the same weights reach the port
through ``bridge``.  Held against JAX: ``decode_step`` and
``decode_step_batch`` logits (float32 within ``ATOL_F32``, seen 1.2e-6;
bf16 within ``ATOL_BF16``, one or two bf16 steps at |logit| < 4, seen
2e-2), and ``generate`` token for token, greedy and sampled at
temperature 0.8 from the same key (float32 compute).  Within the port:
``decode_step_batch`` at one shared position is bitwise ``decode_step``,
and a row's logits do not depend on the other rows.  Served: a port
replica's decode sessions are byte-identical to the same session run
alone through it, with concurrent sessions and one queued behind them,
and a JAX client decodes the same tokens from it.  Last, the CLI's
``--sample_tokens``.
"""

import functools
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu import serve as jax_serve
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.train.checkpoint import flat_params_of
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch import serve as torch_serve
from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.utils import threefry

torch.set_num_threads(1)

TINY = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_seq_len=24)
ATOL_F32 = 1e-5
ATOL_BF16 = 5e-2
STEP = 77


@functools.lru_cache(maxsize=None)
def _weights(dtype):
    jcfg = jax_tf.Config(**TINY, compute_dtype=dtype)
    jparams = jax.device_get(jax_tf.init(jcfg, jax.random.key(3)))
    return jcfg, jparams


def _port(dtype):
    jcfg, jparams = _weights(dtype)
    return torch_tf.Config(**TINY, compute_dtype=dtype), bridge.params_from_numpy(jparams)


def _prompts(rows=2, length=5, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (rows, length)).astype(np.int32)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32), ("bfloat16", ATOL_BF16)])
def test_decode_steps_match_jax(dtype, atol):
    """Shared-position and per-row-position steps against JAX's, the
    cache carried through every position."""
    jcfg, jparams = _weights(dtype)
    tcfg, tparams = _port(dtype)
    ids = _prompts(rows=3, length=8)
    jcache, tcache = jax_tf.init_cache(jcfg, 3, 12), torch_tf.init_cache(tcfg, 3, 12)
    bcache_j, bcache_t = jax_tf.init_cache(jcfg, 3, 12), torch_tf.init_cache(tcfg, 3, 12)
    offsets = np.array([0, 2, 4], np.int32)  # rows at their own depths
    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jstep_batch = jax.jit(functools.partial(jax_tf.decode_step_batch, jcfg))
    with torch.inference_mode():
        for p in range(8):
            jl, jcache = jstep(jparams, jcache, jnp.asarray(ids[:, p]), p)
            tl, tcache = torch_tf.decode_step(tcfg, tparams, tcache, torch.from_numpy(ids[:, p]), p)
            np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                       rtol=0, atol=atol)
            pos = np.minimum(offsets + p, 11).astype(np.int32)
            jl, bcache_j = jstep_batch(jparams, bcache_j, jnp.asarray(ids[:, p]),
                                       jnp.asarray(pos))
            tl, bcache_t = torch_tf.decode_step_batch(
                tcfg, tparams, bcache_t, torch.from_numpy(ids[:, p]), torch.from_numpy(pos))
            np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_step_is_the_shared_step_and_rows_are_independent(dtype):
    tcfg, tparams = _port(dtype)
    ids = _prompts(rows=4, length=6, seed=1)
    shared, batch = torch_tf.init_cache(tcfg, 4, 10), torch_tf.init_cache(tcfg, 4, 10)
    with torch.inference_mode():
        for p in range(6):
            tok = torch.from_numpy(ids[:, p])
            a, shared = torch_tf.decode_step(tcfg, tparams, shared, tok, p)
            b, batch = torch_tf.decode_step_batch(
                tcfg, tparams, batch, tok, torch.full((4,), p, dtype=torch.int32))
            assert torch.equal(a, b), p
        for i in range(tcfg.n_layers):
            for kv in ("k", "v"):
                assert torch.equal(shared[f"block_{i}"][kv], batch[f"block_{i}"][kv])
        # Row 0 alone (other rows zero tokens at other depths) gives the
        # same numbers as row 0 of the full batch above.
        solo = torch_tf.init_cache(tcfg, 4, 10)
        for p in range(6):
            tok = torch.tensor([ids[0, p], 0, 5, 9], dtype=torch.int32)
            pos = torch.tensor([p, 9, 0, 3], dtype=torch.int32)
            c, solo = torch_tf.decode_step_batch(tcfg, tparams, solo, tok, pos)
        assert torch.equal(c[0], a[0])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_jax_token_for_token(temperature):
    jcfg, jparams = _weights("float32")
    tcfg, tparams = _port("float32")
    prompt = _prompts(rows=2, length=4, seed=2)
    want = np.asarray(jax_tf.generate(jcfg, jparams, prompt, max_new_tokens=10,
                                      temperature=temperature, rng=jax.random.key(9)))
    got = torch_tf.generate(tcfg, tparams, prompt, max_new_tokens=10,
                            temperature=temperature, rng=threefry.key(9))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="max_seq_len"):
        torch_tf.generate(tcfg, tparams, prompt, max_new_tokens=21)


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    """A port replica of a JAX-published bf16 version, serving decode in
    4 slots of 24 positions."""
    root = str(tmp_path_factory.mktemp("registry"))
    _jcfg, jparams = _weights("bfloat16")
    version = jax_serve.ModelRegistry(root).publish(
        "transformer_lm", flat_params_of(jparams), step=STEP, source="test"
    )
    tcfg = torch_tf.Config(**TINY)
    server = torch_serve.ModelReplicaServer(
        torch_tf.param_shapes(tcfg), lambda p, b: torch_tf.apply(tcfg, p, b["x"]), [],
        device="cpu", registry_dir=root, model_name="transformer_lm",
        model_version=version, decode_fns=torch_tf.serve_decode_fns(tcfg),
        decode_slots=4, decode_max_len=24, session_idle_s=1.0,
    )
    yield server, version
    server.stop()


PROMPTS = [np.array([3, 17, 55, 42], np.int32), np.array([9], np.int32),
           np.array([1, 2, 3, 4, 5, 6, 7], np.int32), np.array([60, 61], np.int32),
           np.array([8, 8, 8], np.int32)]


def test_served_decode_is_byte_identical_to_the_solo_session(replica):
    server, version = replica
    client = torch_serve.ServeClient("127.0.0.1", server.port)
    solo = [client.generate(p, 10) for p in PROMPTS]
    for p, toks in zip(PROMPTS, solo):
        assert toks.dtype == np.int32 and toks.shape == (10,)
        assert np.array_equal(client.generate(p, 10), toks)  # a second solo run
    # Five at once: four take the slots, the fifth queues behind them.
    outs: list = [None] * len(PROMPTS)

    def body(i):
        c = torch_serve.ServeClient("127.0.0.1", server.port)
        outs[i] = c.generate(PROMPTS[i], 10)
        c.close()

    threads = [threading.Thread(target=body, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(outs, solo):
        assert np.array_equal(got, want)
    stats = client.stats()
    assert stats["model_version"] == version and stats["decode_slots"] == 4
    assert stats["decode_sessions"] >= 15 and stats["decode_emitted"] >= 150
    assert stats["decode_max_len"] == 24 and stats["decode_step_errors"] == 0
    # A greedy session equals the model's own generate on these weights.
    tcfg, tparams = _port("bfloat16")
    ref = torch_tf.generate(tcfg, tparams, PROMPTS[0][None], max_new_tokens=10)
    assert np.array_equal(solo[0], ref[0, len(PROMPTS[0]):].numpy())
    # Budgets the cache cannot hold are refused.
    with pytest.raises(torch_serve.ServeRejectedError):
        client.decode_open(PROMPTS[2], 18)
    client.close()


def test_jax_client_decodes_from_a_port_replica(replica):
    server, _version = replica
    jclient = jax_serve.ServeClient("127.0.0.1", server.port)
    client = torch_serve.ServeClient("127.0.0.1", server.port)
    for p in PROMPTS[:2]:
        np.testing.assert_array_equal(jclient.generate(p, 8), client.generate(p, 8))
    jclient.close()
    client.close()


def test_unpolled_session_is_swept_and_close_is_idempotent(replica):
    server, _version = replica
    client = torch_serve.ServeClient("127.0.0.1", server.port)
    sid = client.decode_open(PROMPTS[0], 4)
    for _ in range(100):  # the refresher sweeps it after 1 s unpolled
        if client.stats()["decode_sessions_open"] == 0:
            break
        time.sleep(0.1)
    assert client.stats()["decode_sessions_open"] == 0
    with pytest.raises(torch_serve.ServeSessionError):
        client.decode_next(sid)
    client.decode_close(sid)
    client.close()


def _cli(*extra):
    return ["--device=cpu", "--vocab_size=64", "--dim=32", "--n_layers=1", "--n_heads=2",
            "--seq_len=24", "--batch_size=2", "--train_steps=1", *extra]


def test_cli_samples_after_training_and_refuses_too_long_first(capsys, caplog):
    caplog.set_level("INFO")
    with pytest.raises(SystemExit, match="exceeds --seq_len=24"):
        cli.main(_cli("--sample_tokens=9"))
    assert "corpus source" not in caplog.text  # refused before training
    assert cli.main(_cli("--sample_tokens=8")) == 0
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("sampled token ids: ")]
    assert line and re.fullmatch(r"sampled token ids: \[(\d+, ){7}\d+\]", line[0])
    assert any(l.startswith("FINAL step=1 ") for l in capsys.readouterr().out.splitlines())
