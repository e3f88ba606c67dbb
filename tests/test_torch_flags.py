"""The port's legacy cluster flags against the JAX package's.

Both example CLIs of the port accept the reference's TF-1 launch flags
(``--ps_hosts``, ``--worker_hosts``, ``--job_name``, ``--task_index``): a
``--job_name=ps`` task prints and exits 0, PS hosts are logged and
ignored, and training runs, under the PS-emulation flags too (neither
JAX CLI has a PS branch).  The info dict of the port's
``resolve_legacy_cluster`` is held against the reference's on the same
flags (the reference reads them from any namespace).  The cross-process
PS launch's flags and the serving replicas' limits parse, through every
port CLI's parser, to the values the JAX parser (absl, over a private
``FlagValues``) gives the same argv; the JAX serve command line parses
through the port's transformer CLI, whose replica serves at the JAX
replica's defaults (fault C7)."""

import copy
import functools
import types

import inspect

import pytest
import torch
from absl import flags as absl_flags

from distributed_tensorflow_examples_tpu.serve import model_server as jax_model_server
from distributed_tensorflow_examples_tpu.utils import flags as jax_flags
from distributed_tensorflow_examples_tpu_torch.examples import (
    cifar10_cnn, mnist_mlp, ptb_lstm, resnet50, transformer_lm, word2vec,
)
from distributed_tensorflow_examples_tpu_torch.models import resnet as resnet_model
from distributed_tensorflow_examples_tpu_torch.serve import model_server
from distributed_tensorflow_examples_tpu_torch.utils import flags

_resnet_init_numpy = resnet_model.init_numpy

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_resnet_init(monkeypatch):
    """ResNet-50's initial weights drawn once for the module's one-step
    runs (the same config and seed each time; ~3.4 s a draw on one
    thread): the runs copy them into their own tensors."""
    monkeypatch.setattr(resnet_model, "init_numpy", _cached_resnet_init)


@functools.lru_cache(maxsize=None)
def _cached_resnet_init(cfg, seed, **kw):
    return _resnet_init_numpy(cfg, seed, **kw)


#: Each CLI with the smallest CPU training it takes (one step).
CLIS = {
    "transformer_lm": (transformer_lm, [
        "--device=cpu", "--vocab_size=64", "--dim=32", "--n_layers=1", "--n_heads=2",
        "--seq_len=16", "--batch_size=2", "--train_steps=1"]),
    "resnet50": (resnet50, [
        "--device=cpu", "--image_size=32", "--num_classes=10", "--batch_size=64",
        "--train_steps=1", "--synthetic_examples=64"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_ps_task_with_legacy_hosts_exits_zero(name, capsys):
    cli, _args = CLIS[name]
    argv = ["--job_name=ps", "--ps_hosts=h:1", "--worker_hosts=w:2", "--task_index=0"]
    assert cli.main(argv) == 0
    assert "parameter servers are not needed" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(CLIS))
def test_ps_hosts_are_logged_and_training_runs(name, capsys, caplog):
    cli, args = CLIS[name]
    caplog.set_level("INFO", logger="dtx.flags")
    assert cli.main([*args, "--ps_hosts=h:1", "--worker_hosts=w:2,w:3"]) == 0
    assert any(line.startswith("FINAL step=1 ") for line in capsys.readouterr().out.splitlines())
    assert "Ignoring 1 PS hosts" in caplog.text
    assert "--worker_hosts given (2 workers)" in caplog.text


@pytest.mark.parametrize(
    "argv",
    [
        ["--job_name=ps", "--ps_hosts=h:1", "--worker_hosts=w:2"],
        ["--job_name=worker", "--ps_hosts=h:1,h:2", "--task_index=1"],
        ["--worker_hosts=w:2,w:3,w:4"],
        [],
    ],
)
@pytest.mark.parametrize("name", sorted(CLIS))
def test_info_matches_the_reference(name, argv):
    args = CLIS[name][0].build_parser().parse_args(argv)
    ref = jax_flags.resolve_legacy_cluster(types.SimpleNamespace(
        job_name=args.job_name, ps_hosts=args.ps_hosts, worker_hosts=args.worker_hosts,
        task_index=args.task_index, sync_replicas=True, ps_emulation=False,
    ))
    assert flags.resolve_legacy_cluster(args) == ref


@pytest.mark.parametrize(
    "argv",
    [["--ps_emulation"], ["--sync_replicas=false"], ["--job_name=ps", "--ps_hosts=h:1",
                                                     "--ps_emulation=true"]],
)
def test_ps_emulation_waits_for_the_ps_plane(argv, capsys):
    """The JAX LM and ResNet CLIs have no PS branch: under
    ``--ps_emulation`` or ``--sync_replicas=false`` they train as usual, and
    so do the port's, a cross-process PS task role among the flags too
    (``--job_name=ps`` with ``--ps_hosts`` under PS emulation is no legacy
    PS process in JAX, so its CLIs train).  The transformer's serve role
    serves its pinned registry version whatever ``--ps_hosts`` says, as
    JAX's does, and so refuses a command line without one.  The PS CLIs'
    cluster roles (sharded, replicated, a serve replica over the PS) and
    what still waits for an item (the data service, A10) are tested in
    ``test_torch_ps_cli.py``."""
    for cli, args in CLIS.values():
        parsed = cli.build_parser().parse_args([*args, *argv])
        assert flags.resolve_legacy_cluster(parsed) == jax_flags.resolve_legacy_cluster(parsed)
        assert cli.main([*args, *argv]) == 0
        out = capsys.readouterr().out.splitlines()
        assert any(line.startswith("FINAL step=1 ") for line in out)
    serve_argv = ["--job_name=serve", "--serve_hosts=127.0.0.1:1", "--ps_hosts=h:1"]
    serve = transformer_lm.build_parser().parse_args(serve_argv)
    assert jax_flags.is_cross_process_ps(serve) and flags.is_cross_process_ps(serve)
    assert flags.resolve_legacy_cluster(serve) == jax_flags.resolve_legacy_cluster(serve)
    with pytest.raises(SystemExit, match="--registry_dir"):
        transformer_lm.main(serve_argv)


#: The flags of the cross-process PS launch and of the serving replicas.
PS_CLUSTER_FLAGS = (
    "ps_tasks", "ps_listen_all", "ps_restarts", "ps_wire_dtype", "ps_prefetch",
    "membership_leases", "lease_ttl_s", "serve_max_batch", "serve_max_wait_ms",
    "serve_queue_depth", "serve_queue_deadline_ms", "serve_hosts", "data_service_hosts",
    "serve_refresh_ms", "registry_dir", "serve_model_version", "ps_shards", "ps_replicas",
    "ps_layout_version", "ps_reshard_to", "tenant", "tenant_quotas",
)
ALL_CLIS = (cifar10_cnn, mnist_mlp, ptb_lstm, resnet50, transformer_lm, word2vec)


def _jax_parse(argv: list[str], names=PS_CLUSTER_FLAGS) -> dict:
    """``argv`` through the JAX CLIs' own flag definitions (absl), into a
    private ``FlagValues`` so the process's flags stay unparsed."""
    jax_flags.define_legacy_cluster_flags()
    fv = absl_flags.FlagValues()
    for name in names:
        fv[name] = copy.deepcopy(absl_flags.FLAGS[name])
    fv(["prog", *argv])
    return {name: fv[name].value for name in names}


@pytest.mark.parametrize("argv", [
    [],
    ["--ps_tasks=0", "--ps_listen_all=true", "--ps_restarts=0", "--ps_wire_dtype=bf16",
     "--ps_prefetch=false", "--membership_leases=false", "--lease_ttl_s=2.5",
     "--serve_max_batch=2", "--serve_max_wait_ms=1.5", "--serve_queue_depth=7",
     "--serve_queue_deadline_ms=40", "--serve_hosts=127.0.0.1:7200",
     "--data_service_hosts=127.0.0.1:7300"],
    ["--ps_tasks=2", "--ps_prefetch=true", "--membership_leases=true", "--ps_listen_all=false"],
    ["--ps_shards=2", "--ps_replicas=2", "--ps_layout_version=1",
     "--ps_reshard_to=2:127.0.0.1:1,127.0.0.1:2,127.0.0.1:3", "--serve_refresh_ms=20",
     "--registry_dir=/models", "--serve_model_version=3", "--tenant=runa",
     "--tenant_quotas=runa=3,runb=1:64:8"],
], ids=["defaults", "every-flag", "booleans", "sharded-replicated"])
@pytest.mark.parametrize("cli", ALL_CLIS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_ps_cluster_flags_parse_to_the_jax_values(cli, argv):
    args = cli.build_parser().parse_args(argv)
    assert {name: getattr(args, name) for name in PS_CLUSTER_FLAGS} == _jax_parse(argv)


def test_jax_serve_command_line_serves_at_the_jax_defaults(monkeypatch, tmp_path):
    """C7: the JAX transformer's serve command line, ``--serve_*`` limits
    included, parses through the port's CLI to the JAX values; the JAX
    transformer's serve task passes none of them to its replica, which
    serves at ``host_serve_task``'s defaults, and so does the port's
    (with the same defaults).  ``--max_batch`` is gone, as in JAX."""
    argv = ["--job_name=serve", f"--registry_dir={tmp_path}", "--serve_model_version=1",
            "--serve_hosts=127.0.0.1:7200", "--vocab_size=64", "--dim=64", "--n_layers=2",
            "--n_heads=4", "--seq_len=32", "--serve_max_batch=2", "--serve_max_wait_ms=1.0",
            "--serve_queue_depth=8", "--serve_queue_deadline_ms=50"]
    names = ("serve_max_batch", "serve_max_wait_ms", "serve_queue_depth",
             "serve_queue_deadline_ms", "serve_hosts")
    args = transformer_lm.build_parser().parse_args(argv)
    assert {n: getattr(args, n) for n in names} == _jax_parse(
        [a for a in argv if a.split("=")[0][2:] in names], names)
    calls = []
    monkeypatch.setattr(transformer_lm, "host_serve_task", lambda **kw: calls.append(kw))
    assert transformer_lm.main([*argv, "--device=cpu"]) == 0
    (kw,) = calls
    assert kw["port"] == 7200 and kw["model_version"] == 1
    limits = ("max_batch", "max_wait_ms", "queue_depth", "queue_deadline_ms")
    assert not set(limits) & set(kw)
    ours = inspect.signature(model_server.host_serve_task).parameters
    ref = inspect.signature(jax_model_server.host_serve_task).parameters
    assert [ours[n].default for n in limits] == [ref[n].default for n in limits] == [
        32, 5.0, 128, 0.0]
    with pytest.raises(SystemExit) as exc:
        transformer_lm.build_parser().parse_args([*argv, "--max_batch=2"])
    assert exc.value.code == 2
