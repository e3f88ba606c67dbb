"""The port's profiler window and its tools, on the CPU: the twins of
``tests/test_hooks.py``'s ``ProfilerHook`` tests, ``--profile`` through
a CLI, ``tools/profile_step.py`` (the entry point at a tiny size, and the
trace reader on a synthetic trace with device rows, which a CPU run
cannot record), ``tools/flash_bench.py``'s flop and bound arithmetic
against the JAX tool's and its rows of the plain versions, and
``tools/comms_scaling.py``'s per-step account at 2 and 4 simulated
ranks.  No TensorBoard events are written: no test here reads one.
"""

import functools
import glob
import io
import json
import math
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

from distributed_tensorflow_examples_tpu_torch.examples import mnist_mlp
from distributed_tensorflow_examples_tpu_torch.tools import comms_scaling, flash_bench, profile_step
from distributed_tensorflow_examples_tpu_torch.train import hooks
from distributed_tensorflow_examples_tpu_torch.utils.metrics import MetricsWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools.flash_bench import attn_tflops  # noqa: E402  (the JAX tool's)


@pytest.fixture(autouse=True)
def _no_tensorboard_events(monkeypatch):
    monkeypatch.setattr(MetricsWriter, "__init__",
                        functools.partialmethod(MetricsWriter.__init__, tensorboard=False))


class _FakeLoop:
    """The JAX tests' minimal loop: a step counter and steps_per_call."""

    def __init__(self, steps_per_call=1):
        self.step = 0
        self.steps_per_call = steps_per_call


def _window_files(root) -> tuple[list, list]:
    base = os.path.join(str(root), "plugins", "profile", "*")
    return (glob.glob(os.path.join(base, "rank0.pt.trace.json")),
            glob.glob(os.path.join(base, "rank0.summary.json")))


# ----------------------------------------------------------------------------
# ProfilerHook
# ----------------------------------------------------------------------------


def test_profiler_hook_writes_trace(tmp_path):
    """A real torch.profiler window produces a trace and a summary under
    log_dir (the twin of the JAX test); the summary reads the window's
    host ops, and a CPU window has no device rows."""
    hook = hooks.ProfilerHook(str(tmp_path), start_step=2, num_steps=2)
    loop = _FakeLoop()
    x = torch.ones(64, 64)
    for _ in range(6):
        hook.before_step(loop)
        x @ x
        loop.step += 1
        hook.after_step(loop, {})
    hook.end(loop)
    assert not hook._active
    traces, summaries = _window_files(tmp_path)
    assert traces and summaries, list(tmp_path.rglob("*"))
    with open(summaries[0]) as f:
        s = json.load(f)
    assert s["busy_ms"] == 0 and s["kernels"] == 0 and s["window_ms"] > 0, s
    assert "aten::mm" in [name for name, _ms, _n in s["host_ops"]], s["host_ops"]
    saved = profile_step.summary(traces[0])
    assert [r[0] for r in saved["host_ops"]][:1] == [r[0] for r in s["host_ops"]][:1]


@pytest.mark.parametrize(
    "steps_per_call,expect_windows",
    [
        (1, [(10, True), (15, False)]),  # plain: active inside [10, 15)
        (4, [(8, True), (16, False)]),  # unroll=4 straddles the window
        (32, [(0, True), (32, False)]),  # one call jumps clean over [10,15)
    ],
)
def test_profiler_hook_straddle_arithmetic(steps_per_call, expect_windows, monkeypatch):
    """The unroll-straddle check, as the JAX test: the window activates for
    any call that OVERLAPS [start, stop), even when step jumps over it."""
    events = []
    monkeypatch.setattr(hooks.ProfilerHook, "_start", lambda self, loop: events.append("start"))
    monkeypatch.setattr(hooks.ProfilerHook, "_stop", lambda self: events.append("stop"))
    hook = hooks.ProfilerHook("/tmp/unused", start_step=10, num_steps=5)
    loop = _FakeLoop(steps_per_call=steps_per_call)
    states = {}
    for _ in range(0, 64, steps_per_call):
        hook.before_step(loop)
        states.setdefault(loop.step, hook._active)
        loop.step += steps_per_call
        hook.after_step(loop, {})
    hook.end(loop)
    assert events == ["start", "stop"], events  # exactly one window
    for step, expected in expect_windows:
        assert states.get(step, None) == expected, (step, states)


def test_profile_flag_writes_trace_under_log_dir(tmp_path, capsys):
    """``--profile`` with ``--log_dir`` adds the JAX runner's window (steps
    10-15): a trace and a summary under ``log_dir/plugins/profile``;
    without a log dir nothing is profiled, as in JAX."""
    argv = ["--device=cpu", "--hidden_units=16", "--batch_size=8", "--train_steps=12",
            "--profile"]
    assert mnist_mlp.main([*argv, f"--log_dir={tmp_path}"]) == 0
    assert "FINAL step=12" in capsys.readouterr().out
    traces, summaries = _window_files(tmp_path)
    assert len(traces) == 1 and len(summaries) == 1, list(tmp_path.rglob("*"))
    with open(summaries[0]) as f:
        assert json.load(f)["host_ops"]
    cwd = os.getcwd()
    os.chdir(tmp_path / "plugins")
    try:
        assert mnist_mlp.main(argv) == 0
    finally:
        os.chdir(cwd)
    assert len(glob.glob(str(tmp_path / "**" / "*.pt.trace.json"), recursive=True)) == 1


# ----------------------------------------------------------------------------
# tools/profile_step.py
# ----------------------------------------------------------------------------


def test_profile_step_tool_on_the_cpu(tmp_path):
    """The entry point at a tiny transformer on the CPU: the CLI runs with
    ``--profile``, the window is the last ``--steps`` steps, the tables
    print and the last line is the JSON summary of the saved trace."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = profile_step.main([
            "--model", "transformer", "--steps", "2", "--warmup", "1", "--top", "5",
            "--log-dir", str(tmp_path), "--", "--device=cpu", "--vocab_size=64", "--dim=32",
            "--n_layers=2", "--n_heads=2", "--seq_len=16", "--batch_size=2"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    result = json.loads(lines[-1])
    assert result["model"] == "transformer" and result["card"] == "cpu"
    assert result["steps"] == 2 and result["busy_ms_per_step"] == 0 and result["step_ms"] > 0
    assert os.path.exists(result["trace"]) and result["trace"].startswith(str(tmp_path))
    assert any(line.startswith("host, most self time") and "aten::" in line for line in lines)


def _synthetic_trace() -> dict:
    """A Chrome trace of one window: two host ops on one thread, a launch
    inside each, three kernels (two overlapping), a copy and a CUPTI
    marker."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
                "tid": 7 if cat != "kernel" else 9, "args": args}

    return {"traceEvents": [
        x("aten::mm", "cpu_op", 0, 100, **{"External id": 1}),
        x("cudaLaunchKernel", "cuda_runtime", 10, 5, correlation=11),
        x("aten::add", "cpu_op", 150, 300, **{"External id": 2}),
        x("cudaLaunchKernel", "cuda_runtime", 160, 5, correlation=12),
        x("void flash_fwd_tc_kernel<128>(...)", "kernel", 20, 40, **{"External id": 1}),
        x("ampere_sgemm_128x64", "kernel", 50, 30, **{"External id": 1}),
        x("elementwise_kernel<add>", "kernel", 300, 50, **{"External id": 2}),
        {"ph": "X", "name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "ts": 400, "dur": 10, "pid": 1, "tid": 9, "args": {}},
        {"ph": "X", "name": "Command Buffer Full", "cat": "kernel", "ts": 0, "dur": 450,
         "pid": 1, "tid": 9, "args": {}},
    ]}


def test_trace_reader_on_device_rows(tmp_path):
    """The reader's arithmetic where a window has device rows: busy is the
    union of the intervals (20-80, 300-350, 400-410 us: 120 us), families
    and launches by kernel name, the marker dropped, self time of the host
    ops, device time by the op that launched it, and the idle gaps with
    the host op open across each."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_synthetic_trace()))
    tr = profile_step.load(str(path))
    assert math.isclose(profile_step.busy_ms(tr), 0.120)
    fam = profile_step.by_family(tr)
    assert fam["flash_fwd"] == {"ms": 0.04, "launches": 1}
    assert fam["matmul"]["launches"] == 1 and fam["elementwise"]["launches"] == 1
    assert fam["copy/cast"]["launches"] == 1
    assert "Command Buffer Full" not in profile_step.launches_by_kernel(tr)
    ops = {name: (ms, n) for name, ms, n in profile_step.host_ops(tr, 10)}
    assert math.isclose(ops["aten::mm"][0], 0.095) and math.isclose(ops["aten::add"][0], 0.295)
    assert {k: round(v, 6) for k, v in profile_step.device_ms_by_op(tr).items()} == \
        {"aten::mm": 0.07, "aten::add": 0.05}
    gaps = profile_step.idle_gaps(tr, 3)
    assert [(round(ms, 6), round(at, 6), op) for ms, at, op in gaps] == [
        (0.22, 0.08, "aten::add"), (0.05, 0.35, "aten::add"), (0.04, 0.41, "aten::add")]
    s = profile_step.summary(tr, wall_ms=0.5, families=profile_step.LM_FAMILIES)
    assert s["kernels"] == 3 and s["copies"] == 1 and math.isclose(s["idle_share"], 0.76)
    assert any("flash_fwd" in line for line in profile_step.tables(s))


# ----------------------------------------------------------------------------
# tools/flash_bench.py
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,t,d", [(2, 8, 2048, 128), (1, 8, 8192, 64), (4, 4, 1000, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bench_flops_match_the_jax_tool(b, h, t, d, causal):
    """The forward's two products and the fused backward's five against
    the JAX tool's ``attn_tflops`` (whose backward row counts forward and
    backward, 2 + 5 products): equal without the mask; with it the port
    counts the T(T+1)/2 visible pairs, the JAX tool T^2/2: within
    (T+1)/T."""
    fwd = flash_bench.flash_flops(b * h, t, d, causal) / 1e12
    bwd = flash_bench.flash_flops(b * h, t, d, causal, products=5) / 1e12
    want_fwd = attn_tflops(b, h, t, d, causal=causal, bwd=False)
    want_bwd = attn_tflops(b, h, t, d, causal=causal, bwd=True) - want_fwd
    ratio = (t + 1) / t if causal else 1.0
    assert math.isclose(fwd, want_fwd * ratio, rel_tol=1e-12), (fwd, want_fwd)
    assert math.isclose(bwd, want_bwd * ratio, rel_tol=1e-12), (bwd, want_bwd)


def test_flash_bench_bounds():
    """The bounds: the forward at [16, 2048, 128] bf16 causal is bound by
    its operations at the tensor cores' peak; a float32 output moves
    twice the bytes of a bf16 one; a BN statistics pass is bound by its
    bytes."""
    ms, by = flash_bench.flash_bound_ms(16, 2048, 128, torch.bfloat16, True)
    assert by == "operations"
    assert math.isclose(ms, flash_bench.flash_flops(16, 2048, 128, True)
                        / flash_bench.H100_BF16_FLOPS * 1e3)
    small = dict(products=0, tiles_in=0, rows_out=0)
    b16, _ = flash_bench.flash_bound_ms(4, 64, 32, torch.bfloat16, False, **small)
    b32, _ = flash_bench.flash_bound_ms(4, 64, 32, torch.bfloat16, False, out_dtype=torch.float32,
                                        **small)
    assert math.isclose(b32, 2 * b16)
    shapes = flash_bench.resnet50_bn_shapes(256, 224)
    assert len(shapes) == 53 and shapes[0] == ((256, 112, 112, 64), True)
    ms, by = flash_bench.bn_bound_ms(shapes[0][0], torch.bfloat16, backward=True, relu=True)
    assert by == "bytes" and math.isclose(
        ms, (2 * 256 * 112 * 112 * 64 * 2 + 6 * 64 * 4) / flash_bench.H100_BYTES_PER_S * 1e3)


def test_flash_bench_plain_rows_on_the_cpu():
    """``--device=cpu`` prints a row for every kernel and shape, each with
    its plain version's host time and no device number."""
    out = io.StringIO()
    with redirect_stdout(out):
        assert flash_bench.main(["--device=cpu", "--shrink=64", "--markdown"]) == 0
    lines = out.getvalue().splitlines()
    rows = json.loads(lines[-1])["rows"]
    assert [r["kernel"] for r in rows].count("flash_fwd") == 6 and len(rows) == 19
    assert all(r["ms"] is None and r["library_ms"] is None and r["plain_ms"] > 0 for r in rows)
    assert sum(line.startswith("| ") for line in lines) == 1 + len(rows)
    assert all("cpu (plain versions, host clock)" in line for line in lines[2:-1])


# ----------------------------------------------------------------------------
# tools/comms_scaling.py
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_comms_scaling_step_account(n):
    """One step of every workload on ``n`` thread ranks: the kinds each
    mesh must issue (the seq ring's permutes, Ulysses' and the experts'
    all-to-alls, the pipeline's handoffs) and, where only data
    parallelism shards, a gradient bucket of every parameter's bytes."""
    res = comms_scaling.account(n)["workloads"]
    kinds = {name: set(r["collectives"]) - {"total"} for name, r in res.items()}
    assert kinds["mlp"] == kinds["lstm"] == kinds["resnet50"] == {"all-reduce"}, kinds
    assert "collective-permute" in kinds["transformer"]
    assert "all-to-all" in kinds["transformer_ulysses"] and "all-to-all" in kinds["transformer_moe"]
    assert res["transformer_pp"]["by_tag"]["pipe"] == {
        "collective-permute": res["transformer_pp"]["by_tag"]["pipe"]["collective-permute"]}
    assert "bn" in res["resnet50"]["by_tag"]
    cfg = comms_scaling.workloads(n)["mlp"]["cfg"]
    params = sum(a * b + b for a, b in zip((cfg.input_dim, *cfg.hidden),
                                           (*cfg.hidden, cfg.num_classes)))
    assert res["mlp"]["by_tag"]["grads"] == {"all-reduce": {"count": 1, "bytes": 4 * params}}
    w2v = res["word2vec"]["by_tag"]
    assert "model_fwd" in w2v and ("grads" in w2v) == (n >= 4), w2v
