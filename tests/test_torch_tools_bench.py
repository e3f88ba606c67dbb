"""The port's twins of the root host tools (``loader_bench``,
``data_service_bench``, ``serving_bench``, ``ps_transport_bench``) and of
``ulysses_ab``, at tiny sizes on the CPU: each yields the root tool's row,
and each rule flags a broken row and passes a healthy one.

Where the root tool runs in seconds, it runs here beside its twin and the
rows' key sets are compared; the twin adds only ``gates`` and ``checks``
(its verdicts), and ``serving_bench`` also the apply's ``device`` and the
served prediction's error.  ``ulysses_ab``'s gradients are held against
``jax.grad`` of the JAX package's ``flash_attention`` (interpret mode on
the CPU, as the JAX package's own tests run it) under the same loss, at
``tests/test_torch_flash_backward.py``'s bf16 tolerance: 8e-3 of the
largest entry, two bf16 steps.
"""

import contextlib
import io
import json
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu.ops import flash_attention as jax_flash
from distributed_tensorflow_examples_tpu_torch.tools import (
    _hostbench,
    data_service_bench,
    loader_bench,
    ps_transport_bench,
    serving_bench,
    ulysses_ab,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: What a twin's row adds to the root's.
VERDICTS = {"gates", "checks"}
RTOL_BF16 = 8e-3


def _keys(row: dict, depth: int = 2) -> set:
    """Dotted key paths of ``row`` down to ``depth`` levels."""
    out = set()
    for k, v in row.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict):
            out |= {f"{k}.{kk}" for kk in _keys(v, depth - 1)}
    return out


def _twin_keys(row: dict) -> set:
    """``_keys`` of a twin's row without its verdicts."""
    return {k for k in _keys(row) if k.split(".")[0] not in VERDICTS}


def _main_stdout(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_hostbench_helpers(tmp_path, capsys):
    assert _hostbench.memcpy_mbs(1 << 16, reps=2) > 0
    rows = iter([{"qps": 1.0, "n": 1}, {"qps": 3.0, "n": 2}, {"qps": 2.0, "n": 3}])
    assert _hostbench.best_of(3, lambda: next(rows), "qps")["n"] == 2
    assert _hostbench.rounded({"a": [1.23456, {"b": 2.0001}], "c": 3}, 2) == {
        "a": [1.23, {"b": 2.0}], "c": 3}
    path = tmp_path / "rec.json"
    _hostbench.emit({"metric": "m", "value": 1.5}, str(path))
    assert json.loads(capsys.readouterr().out) == json.loads(path.read_text()) == {
        "metric": "m", "value": 1.5}


def test_loader_bench_prints_the_root_lines_and_a_json_row(monkeypatch):
    argv = ["--records", "1024", "--batch", "32", "--shard-records", "256", "--batches", "8"]
    rc, out = _main_stdout(loader_bench.main, argv)
    assert rc == 0
    lines = out.strip().splitlines()
    rec = json.loads(lines[-1])
    d = rec["detail"]
    assert rec["metric"] == "loader_batches_per_s" and rec["unit"] == "batches/s"
    for path in ("native", "python"):
        assert d[path]["batches_per_s"] > 0 and d[path]["mbs"] > 0
    assert d["native_over_python"] > 0 and all(d["checks"].values())
    # The root tool's three lines, label for label.
    from tools import loader_bench as root

    monkeypatch.setattr(sys, "argv", ["loader_bench.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root.main()
    labels = lambda text: [l.split(":")[0] for l in text.strip().splitlines()[:3]]  # noqa: E731
    assert labels(out) == labels(buf.getvalue())


def test_loader_batch_check_flags_a_wrong_batch():
    good = {"image": np.zeros((4, 32, 32, 3), np.uint8), "label": np.arange(4, dtype=np.int32)}
    assert loader_bench.batch_ok(good, 4)
    assert not loader_bench.batch_ok(good, 8)
    assert not loader_bench.batch_ok(dict(good, image=good["image"].astype(np.float32)), 4)
    assert not loader_bench.batch_ok(dict(good, label=np.full(4, 1000, np.int32)), 4)


def _dsvc_args(**kw):
    base = dict(batch_rows=32, hw=8, rows_per_shard=128, shards=2, n_batches=4, seed=0)
    return SimpleNamespace(**{**base, **kw})


def test_data_service_bench_row_has_the_root_keys():
    d = data_service_bench.run(_dsvc_args())
    assert d["local"]["stream_mbs"] > 0 and d["remote"]["stream_mbs"] > 0
    assert d["remote"]["heartbeat_rtt_us"] > 0
    assert d["checks"] == {"remote_batch_layout": True}
    assert d["gates"] == {"remote_ge_half_local": None}  # 0.006 MB batches: no rule
    from tools import data_service_bench as root

    assert _twin_keys(d) == _keys(root.run(_dsvc_args()))


def test_data_service_rule_flags_a_halved_remote():
    healthy = {"raw_batch_mb": 1.5, "local": {"stream_mbs": 100.0},
               "remote": {"stream_mbs": 60.0}}
    assert data_service_bench.gates(healthy) == {"remote_ge_half_local": True}
    halved = dict(healthy, remote={"stream_mbs": 30.0})
    assert data_service_bench.gates(halved) == {"remote_ge_half_local": False}
    small = dict(halved, raw_batch_mb=0.5)
    assert data_service_bench.gates(small) == {"remote_ge_half_local": None}


def _serving_args(**kw):
    base = dict(max_batch=32, max_wait_ms=5.0, rows=1, ps_shards=2, client_sweep=[2, 4],
                clients=[4, 8], concurrency_rate=20.0, concurrency_secs=0.5, n_single=8,
                n_batched=32, trials=1, seconds_cap=5.0)
    return SimpleNamespace(**{**base, **kw})


def test_serving_bench_serves_the_plain_apply_on_the_cpu():
    d = serving_bench.run(_serving_args(device="cpu"))
    assert d["device"] == "cpu"
    assert d["checks"] == {"predict_equals_plain_apply": True}
    assert d["predict_max_rel_err"] <= serving_bench.TOL_PREDICT
    for row in ("single", "batched"):
        assert d[row]["qps"] > 0 and d[row]["requests"] > 0 and d[row]["p99_ms"] > 0
    assert set(d["concurrency"]["clients"]) == {"4", "8"} and d["concurrency"]["p99_ratio"] > 0
    assert set(d["gates"]) == {"batched_speedup_ge_3", "concurrent_p99_ratio_le_3"}
    assert d["server_stats"]["predict_rows"] >= d["single"]["requests"]
    from tools import serving_bench as root

    assert _twin_keys(d) - {"device", "predict_max_rel_err"} == _keys(root.run(_serving_args()))


def test_serving_bench_prediction_check_catches_a_wrong_apply():
    flat = serving_bench.published_flat()
    x = np.random.default_rng(1).normal(size=(3, serving_bench.D_IN)).astype(np.float32)
    params = {k: torch.from_numpy(v) for k, v in {
        "b1": flat[:512], "w1": flat[512 : 512 + 512 * 512].reshape(512, 512),
        "w2": flat[512 + 512 * 512 :].reshape(512, 128)}.items()}
    got = serving_bench.predict_fn(params, {"x": torch.from_numpy(x)}).numpy()
    want = serving_bench.plain_apply(flat, x)
    assert np.abs(got - want).max() <= serving_bench.TOL_PREDICT * np.abs(want).max()
    wrong = serving_bench.plain_apply(flat[::-1].copy(), x)
    assert np.abs(wrong - want).max() > serving_bench.TOL_PREDICT * np.abs(want).max()


def test_serving_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_bench.run(_serving_args(device=None))


def test_serving_rules_flag_a_broken_batcher_and_connection_cost():
    healthy = {"max_batch": 32, "batched_speedup": 5.0, "concurrency": {"p99_ratio": 1.5}}
    assert serving_bench.gates(healthy) == {
        "batched_speedup_ge_3": True, "concurrent_p99_ratio_le_3": True}
    assert serving_bench.gates(dict(healthy, batched_speedup=1.0))["batched_speedup_ge_3"] is False
    assert serving_bench.gates(dict(healthy, concurrency={"p99_ratio": 4.0}))[
        "concurrent_p99_ratio_le_3"] is False
    assert serving_bench.gates({"max_batch": 16, "batched_speedup": 1.0}) == {
        "batched_speedup_ge_3": None, "concurrent_p99_ratio_le_3": None}


def _ptb_args(large_mb: float):
    return SimpleNamespace(large_mb=large_mb, small_kb=4.0, clients=2, reps_large=3,
                           reps_small=30, dtypes=["f32", "bf16"])


def test_ps_transport_bench_16mb_passes_the_if_newer_rule():
    """The counterpart of ``tests/test_ps_transport.py``'s quick-bench
    tripwire: at 16 MB a full pull takes milliseconds, so an O(params)
    if-newer pull cannot pass the 10x rule."""
    d = ps_transport_bench.run(_ptb_args(16.0))
    assert d["f32"]["set_get_mbs_large"] > 0 and d["bf16"]["set_get_mbs_large"] > 0
    assert d["gates"] == {"f32_if_newer_ge_10x": True, "bf16_if_newer_ge_10x": True}
    assert d["checks"] == {"f32_pull_equals_published": True,
                           "bf16_pull_equals_published": True}
    assert set(d["shards"]) == {"1", "2"} and set(d["replicas"]) == {"1", "2"}


def test_ps_transport_bench_row_has_the_root_keys():
    from tools import ps_transport_bench as root

    assert _twin_keys(ps_transport_bench.run(_ptb_args(1.0))) == _keys(root.run(_ptb_args(1.0)))


def test_ps_transport_rule_flags_an_o_params_if_newer_pull():
    # 16 MB at 2000 MB/s: an 8 ms full pull.
    healthy = {"large_mb": 16.0, "f32": {"get_mbs_large": 2000.0, "if_newer_rtt_us": 30.0}}
    assert ps_transport_bench.gates(healthy) == {"f32_if_newer_ge_10x": True}
    broken = dict(healthy, f32={"get_mbs_large": 2000.0, "if_newer_rtt_us": 4000.0})
    assert ps_transport_bench.gates(broken) == {"f32_if_newer_ge_10x": False}


#: The least row each host twin's ``main`` prints, with one rule false.
_FAILED_RULE_ROWS = {
    "serving_bench": {"batched": {"qps": 1.0}, "predict_max_rel_err": 0.0,
                      "gates": {"batched_speedup_ge_3": False}},
    "data_service_bench": {"remote": {"stream_mbs": 1.0},
                           "gates": {"remote_ge_half_local": False}},
    "ps_transport_bench": {"f32": {"set_get_mbs_large": 1.0},
                           "gates": {"full_pull_ge_10x_if_newer": False}},
}


@pytest.mark.parametrize("name", sorted(_FAILED_RULE_ROWS))
@pytest.mark.parametrize("check_ok", [True, False])
def test_host_twin_exits_non_zero_only_on_a_failed_check(monkeypatch, name, check_ok):
    """A rule that fails on this host is printed in ``gates``, as the root
    tool prints it; only a failed correctness check fails the command."""
    tool = {"serving_bench": serving_bench, "data_service_bench": data_service_bench,
            "ps_transport_bench": ps_transport_bench}[name]
    row = dict(_FAILED_RULE_ROWS[name], checks={"ok": check_ok})
    monkeypatch.setattr(tool, "run", lambda args: row)
    rc, out = _main_stdout(tool.main, ["--device=cpu"] if name == "serving_bench" else [])
    assert json.loads(out.strip().splitlines()[-1])["detail"]["gates"] == row["gates"]
    assert rc == (0 if check_ok else 1)


def test_ulysses_ab_times_and_matches_the_jax_gradients():
    assert ulysses_ab.grad_time(1, 2, 128, 16, steps=1, device="cpu") > 0
    rng = np.random.default_rng(86)
    q, k, v = [(rng.standard_normal((1, 2, 128, 16)) * 0.5).astype(np.float32) for _ in range(3)]

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash.flash_attention(q_, k_, v_, causal=False).astype(jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *[jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)])
    got = ulysses_ab.grads(*[torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (1, 2, 128, 16)
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= RTOL_BF16 * np.abs(w).max()


def test_ulysses_ab_row_has_the_root_keys():
    rec = ulysses_ab.run(ulysses_ab.parse_args(
        ["--b", "1", "--h", "4", "--t", "64", "--d", "32", "--sp", "2,3,4", "--steps", "1",
         "--device", "cpu"]))
    assert set(rec) == {"tool", "platform", "fused_env", "shape", "note", "rows"}
    assert rec["platform"] == "cpu" and [r["sp"] for r in rec["rows"]] == [2, 4]  # 3 divides neither
    for r in rec["rows"]:
        assert set(r) == {"sp", "t_ulysses_ms", "t_ring_hop_ms", "t_ring_ms", "ring_over_ulysses"}
        assert r["t_ring_ms"] == pytest.approx(r["sp"] * r["t_ring_hop_ms"], abs=1e-2)
