"""The port's serving plane against the JAX package's, on the CPU.

A tiny transformer is drawn by JAX ``init`` and published with the JAX
``ModelRegistry``; a port replica (``device="cpu"``) pins that version and
answers predicts from both packages' clients over the shared wire.  Logits
are held to JAX ``apply`` of the same weights (atol 5e-2, the bf16 logits
tolerance of tests/test_torch_transformer.py); stamps are exact."""

import threading

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu import serve as jax_serve
from distributed_tensorflow_examples_tpu.models import transformer as jax_tf
from distributed_tensorflow_examples_tpu.parallel import wire as jax_wire
from distributed_tensorflow_examples_tpu.train.checkpoint import flat_params_of
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch import serve as torch_serve
from distributed_tensorflow_examples_tpu_torch.examples import (
    transformer_lm as torch_cli,
)
from distributed_tensorflow_examples_tpu_torch.models import transformer as torch_tf
from distributed_tensorflow_examples_tpu_torch.parallel import wire as torch_wire
from distributed_tensorflow_examples_tpu_torch.serve import model_server

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, max_seq_len=32)
STEP = 1234
ATOL = 5e-2


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A JAX-published registry version of the tiny transformer."""
    root = str(tmp_path_factory.mktemp("registry"))
    jcfg = jax_tf.Config(**TINY)
    jparams = jax.device_get(jax_tf.init(jcfg, jax.random.key(11)))
    version = jax_serve.ModelRegistry(root).publish(
        "transformer_lm", flat_params_of(jparams), step=STEP, source="test"
    )
    return root, version, jcfg, jparams


def _replica(root, version, **kw):
    tcfg = torch_tf.Config(**TINY)
    return torch_serve.ModelReplicaServer(
        torch_tf.param_shapes(tcfg),
        lambda p, b: torch_tf.apply(tcfg, p, b["x"]),
        [], device="cpu", registry_dir=root, model_name="transformer_lm",
        model_version=version, max_batch=2, max_wait_ms=20.0, **kw,
    )


def _ids(rows, seed):
    return np.random.default_rng(seed).integers(0, 64, (rows, 32), dtype=np.int32)


def test_port_replica_serves_jax_published_version(published):
    root, version, jcfg, jparams = published
    server = _replica(root, version)
    try:
        client = torch_serve.ServeClient("127.0.0.1", server.port)
        assert client.server_model_version == version
        ids = _ids(1, seed=1)
        step, out = client.predict({"x": ids})
        assert step == STEP and client.last_model_version == version
        logits = out["output"]
        assert isinstance(logits, torch.Tensor) and logits.dtype == torch.bfloat16
        assert tuple(logits.shape) == (1, 32, 64)
        want = np.asarray(jax_tf.apply(jcfg, jparams, ids).astype(np.float32))
        np.testing.assert_allclose(logits.float().numpy(), want, rtol=0, atol=ATOL)

        # Two concurrent requests coalesce into padded applies; each row
        # still equals its own apply.
        ids2 = _ids(1, seed=2)
        got = {}

        def one(key, x):
            c = torch_serve.ServeClient("127.0.0.1", server.port)
            got[key] = c.predict({"x": x})
            c.close()

        threads = [threading.Thread(target=one, args=(k, x))
                   for k, x in (("a", ids), ("b", ids2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert got["a"][0] == got["b"][0] == STEP
        torch.testing.assert_close(got["a"][1]["output"], logits, rtol=0, atol=0)
        want2 = np.asarray(jax_tf.apply(jcfg, jparams, ids2).astype(np.float32))
        np.testing.assert_allclose(
            got["b"][1]["output"].float().numpy(), want2, rtol=0, atol=ATOL
        )
        stats = client.stats()
        assert stats["model_step"] == STEP and stats["model_version"] == version
        assert stats["pinned"] and stats["device"] == "cpu"
        assert stats["predict_rows"] == 3
        client.close()
    finally:
        server.stop()


def test_jax_client_against_port_replica(published):
    """Wire parity: the JAX ServeClient decodes the port's bf16 logits with
    ml_dtypes, byte for byte."""
    root, version, jcfg, jparams = published
    server = _replica(root, version)
    try:
        client = jax_serve.ServeClient("127.0.0.1", server.port)
        assert client.server_model_version == version
        ids = _ids(2, seed=3)
        step, out = client.predict({"x": ids})
        assert step == STEP and client.last_model_version == version
        logits = out["output"]
        assert logits.dtype.name == "bfloat16" and logits.shape == (2, 32, 64)
        want = np.asarray(jax_tf.apply(jcfg, jparams, ids).astype(np.float32))
        np.testing.assert_allclose(
            logits.astype(np.float32), want, rtol=0, atol=ATOL
        )
        port_client = torch_serve.ServeClient("127.0.0.1", server.port)
        _, port_out = port_client.predict({"x": ids})
        np.testing.assert_array_equal(
            port_out["output"].view(torch.int16).numpy(), logits.view(np.int16)
        )
        assert client.stats()["model_version"] == version
        port_client.close()
        client.close()
    finally:
        server.stop()


def test_decode_open_answers_no_decoder(published):
    root, version, _jcfg, _jparams = published
    server = _replica(root, version)
    try:
        client = torch_serve.ServeClient("127.0.0.1", server.port)
        status, _ = client.call(
            model_server.SRV_DECODE_OPEN, a=4,
            payload_bufs=torch_wire.encode_batch(
                {"prompt": np.arange(3, dtype=np.int32)}
            ),
        )
        assert status == model_server.NO_DECODER
        with pytest.raises(torch_serve.ServeRejectedError, match="no decode"):
            client.decode_open(np.arange(3, dtype=np.int32), 4)
        jclient = jax_serve.ServeClient("127.0.0.1", server.port)
        with pytest.raises(jax_serve.ServeRejectedError, match="no decode"):
            jclient.generate(np.arange(3, dtype=np.int32), 4)
        jclient.close()
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize(
    "kw",
    [
        dict(ps_addrs=[("127.0.0.1", 1)]),
        dict(membership=True),
        dict(follow_reshard=True),
    ],
)
def test_later_slice_features_raise_not_implemented(published, kw):
    root, version, _jcfg, _jparams = published
    tcfg = torch_tf.Config(**TINY)
    kw = dict(kw)
    ps_addrs = kw.pop("ps_addrs", [])
    with pytest.raises(NotImplementedError, match="slice"):
        torch_serve.ModelReplicaServer(
            torch_tf.param_shapes(tcfg), lambda p, b: None, ps_addrs,
            device="cpu", registry_dir=root, model_name="transformer_lm",
            model_version=version, **kw,
        )


def test_replica_without_cpu_request_raises_when_no_gpu(published, monkeypatch):
    root, version, _jcfg, _jparams = published
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = torch_tf.Config(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_serve.ModelReplicaServer(
            torch_tf.param_shapes(tcfg), lambda p, b: None, [],
            registry_dir=root, model_name="transformer_lm",
            model_version=version,
        )


def test_registries_read_each_other(tmp_path):
    """Same on-disk format both ways: a port-published version loads in the
    JAX registry and a JAX-published one in the port's."""
    flat = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    v = torch_serve.ModelRegistry(str(tmp_path)).publish("m", flat, step=7)
    step, got, manifest = jax_serve.ModelRegistry(str(tmp_path)).load("m", v)
    assert step == 7 and manifest["version"] == v
    np.testing.assert_array_equal(got, flat)
    v2 = jax_serve.ModelRegistry(str(tmp_path)).publish("m", flat * 2, step=8)
    step, got, _ = torch_serve.ModelRegistry(str(tmp_path)).load("m", v2)
    assert step == 8 and v2 == v + 1
    np.testing.assert_array_equal(got, flat * 2)


def test_wire_bf16_fields_are_byte_identical_to_the_jax_codec():
    import ml_dtypes

    x = torch.randn(3, 5).to(torch.bfloat16)
    ids = np.arange(6, dtype=np.int32).reshape(3, 2)
    mine = torch_wire.encode_batch({"logits": x, "ids": ids})
    theirs = jax_wire.encode_batch({
        "logits": x.view(torch.int16).numpy().view(ml_dtypes.bfloat16),
        "ids": ids,
    })
    flat = lambda bufs: b"".join(
        b.reshape(-1).view(np.uint8).tobytes() if isinstance(b, np.ndarray)
        else bytes(b) for b in bufs
    )
    assert flat(mine) == flat(theirs)
    back = torch_wire.decode_batch_bytes(flat(theirs))
    assert back["logits"].dtype == torch.bfloat16
    torch.testing.assert_close(back["logits"], x, rtol=0, atol=0)
    np.testing.assert_array_equal(back["ids"], ids)
    jback = jax_wire.decode_batch_bytes(flat(mine))
    np.testing.assert_array_equal(
        jback["logits"].view(np.int16), x.view(torch.int16).numpy()
    )


def test_flat_param_spec_rejects_a_wrong_size_vector():
    total, unflatten = bridge.flat_param_spec({"a": (2, 3), "b": (4,)})
    assert total == 10
    with pytest.raises(ValueError, match="needs 10"):
        unflatten(np.zeros(9, np.float32))
    tree = unflatten(np.arange(10, dtype=np.float32))
    np.testing.assert_array_equal(tree["a"].numpy(), np.arange(6).reshape(2, 3))


def test_serve_cli_hosts_a_replica_until_shutdown(published):
    """The port's serve CLI under the JAX flag names, driven end to end."""
    root, version, jcfg, jparams = published
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [
        "--job_name=serve", f"--registry_dir={root}",
        f"--serve_model_version={version}",
        f"--serve_hosts=127.0.0.1:{port}", "--vocab_size=64", "--dim=64",
        "--n_layers=2", "--n_heads=4", "--seq_len=32", "--attention=flash",
        "--max_batch=2", "--device=cpu",
    ]
    rc = []
    host = threading.Thread(target=lambda: rc.append(torch_cli.main(argv)))
    host.start()
    try:
        client = torch_serve.ServeClient(
            "127.0.0.1", port, reconnect_deadline_s=60.0
        )
        ids = _ids(1, seed=4)
        step, out = client.predict({"x": ids})
        assert step == STEP and client.last_model_version == version
        want = np.asarray(jax_tf.apply(jcfg, jparams, ids).astype(np.float32))
        np.testing.assert_allclose(
            out["output"].float().numpy(), want, rtol=0, atol=ATOL
        )
        client.shutdown_server()
        client.close()
    finally:
        host.join(timeout=60)
    assert not host.is_alive() and rc == [0]


def test_serve_cli_rejects_missing_version():
    with pytest.raises(SystemExit):
        torch_cli.main(["--job_name=serve", "--device=cpu"])
    with pytest.raises(ValueError, match="host:port"):
        torch_cli.serve_port("nohost", 0)
