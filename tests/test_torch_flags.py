"""The port's legacy cluster flags against the JAX package's.

Both example CLIs of the port accept the reference's TF-1 launch flags
(``--ps_hosts``, ``--worker_hosts``, ``--job_name``, ``--task_index``): a
``--job_name=ps`` task prints and exits 0, PS hosts are logged and
ignored, and training runs.  The info dict of the port's
``resolve_legacy_cluster`` is held against the reference's on the same
flags (the reference reads them from any namespace)."""

import types

import pytest
import torch

from distributed_tensorflow_examples_tpu.utils import flags as jax_flags
from distributed_tensorflow_examples_tpu_torch.examples import resnet50, transformer_lm
from distributed_tensorflow_examples_tpu_torch.utils import flags

torch.set_num_threads(1)

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
def test_ps_emulation_waits_for_the_ps_plane(argv):
    """Where the reference would run its PS emulation, the port raises."""
    for cli, _args in CLIS.values():
        with pytest.raises(NotImplementedError, match="A9"):
            cli.main(argv)
    serve = transformer_lm.build_parser().parse_args(
        ["--job_name=serve", "--serve_hosts=127.0.0.1:1", "--ps_hosts=h:1"])
    assert jax_flags.is_cross_process_ps(serve)
    with pytest.raises(NotImplementedError, match="A9"):
        flags.resolve_legacy_cluster(serve)
