"""The port's fused flash-attention backward and its dispatch against the
JAX package's.

Same inputs, made with numpy from a seed, go through the JAX Pallas
``fused_bwd_call`` (interpret mode on the CPU, as
tests/test_flash_attention.py runs it, at the JAX blocks of each case) and
the port's plain ``fused_bwd_plain``, which is what a CPU tensor takes; lse
and delta come from the JAX forward, so both sides see the same saved
state.  Then the port's differentiable ``flash_attention`` with the fused
backward forced against ``jax.grad`` of the JAX one, the segmented regime
(the reference past its accumulator cap) against the port's one uncapped
fused call, the dispatch (``_fused_bwd_policy``, ``_use_fused_bwd``,
``_fused_segment_rows``, ``_pick_block`` and the env validation) case by
case against the JAX functions, and the parity twin of
``tools/flash_parity.py`` on the CPU.

Tolerances, relative to the largest entry.  float32: 2e-6 for the kernel
outputs (the same algorithm with other tiles and another dq summation
order, so only f32 rounding differs; seen: 3.3e-7), 1e-5 for gradients
through the whole function (the forward's o and lse also differ in f32
order; seen: 9.7e-7), and 3e-5 for the segmented regime (the bound
tests/test_flash_attention.py holds the reference's segmented path to
against its split one; seen: 8.2e-7).  bfloat16: 8e-3, two bf16 steps at
the largest entry (outputs round to bf16, and p and ds round to bf16
inside the products, where a value on the other side of a rounding
boundary moves one term by 2^-8 of itself; seen: 7.9e-5 on the kernel
outputs, 2.0e-5 on the gradients); bf16 in, f32 out: 5e-3, the unrounded
sums of those bf16 products (seen: 4.4e-4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu.ops import flash_attention as jax_flash
from distributed_tensorflow_examples_tpu_torch import ops as torch_ops
from distributed_tensorflow_examples_tpu_torch.ops import common as torch_common
from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as torch_flash
from distributed_tensorflow_examples_tpu_torch.tools import flash_parity

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

RTOL = {"float32": 2e-6, "bfloat16": 8e-3}
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _arrays(shape, seed, n=4, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
            for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what} max |port - jax| = {err:.3e} vs {rtol * scale:.3e}"


@pytest.fixture
def fused_spy(monkeypatch):
    """Counts the port's fused backward calls (the plain version on the CPU)."""
    calls = []
    real = torch_flash.fused_bwd_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(torch_flash, "fused_bwd_plain", spy)
    return calls


# The corner sweep of tests/test_flash_attention.py::
# test_fused_bwd_regime_shape_sweep (uneven nq != nk, rectangular and
# non-power-of-two JAX blocks, both dtypes), plus the ring-partial form.
SWEEP = [
    # (t, d, bq, bk, causal, dtype, out_dtype)
    (128, 8, 32, 16, True, "float32", None),
    (128, 8, 16, 32, False, "float32", None),
    (256, 16, 32, 32, True, "float32", None),
    (192, 8, 48, 16, True, "float32", None),
    (128, 16, 16, 16, True, "bfloat16", None),
    (200, 32, 40, 40, False, "bfloat16", "float32"),
    # The last 128-row k group of the port's walk half-empty (T 320: 64 of
    # its 128 rows; T 192 likewise), causal and not.
    (320, 16, 64, 64, True, "bfloat16", None),
    (192, 16, 64, 32, False, "float32", None),
]


@pytest.mark.parametrize("t,d,bq,bk,causal,dtype,out_dtype", SWEEP)
def test_fused_plain_matches_jax_fused_bwd_call(t, d, bq, bk, causal, dtype, out_dtype):
    arrays = _arrays((2, t, d), seed=t + d + bq + causal, scale=0.5)
    jq, jk, jv, jdo = _jax(arrays, dtype)
    jo, jlse = jax_flash.fwd_call(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    jdelta = jax_flash.compute_delta(jdo, jo)
    jout = jnp.float32 if out_dtype else None
    want = jax_flash.fused_bwd_call(jq, jk, jv, jdo, jlse, jdelta, causal=causal,
                                    block_q=bq, block_k=bk, out_dtype=jout)
    targs = _torch(arrays, dtype) + [torch.from_numpy(np.array(jlse)),
                                     torch.from_numpy(np.array(jdelta))]
    tout = getattr(torch, out_dtype) if out_dtype else None
    got = torch_flash.fused_bwd_call(*targs, causal=causal, out_dtype=tout)
    rtol = 5e-3 if out_dtype else RTOL[dtype]  # unrounded f32 of bf16 products
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == (tout or getattr(torch, dtype)) and tuple(g.shape) == (2, t, d)
        _close(g, w, rtol, name)


def _loss_grads_jax(q, k, v, causal, bq, bk):
    def f(q_, k_, v_):
        o = jax_flash.flash_attention(q_, k_, v_, causal=causal, block_q=bq, block_k=bk)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _loss_grads_torch(arrays, dtype, causal, bq=None, bk=None):
    leaves = [x.requires_grad_() for x in _torch(arrays, dtype)]
    o = torch_flash.flash_attention(*leaves, causal=causal, block_q=bq, block_k=bk)
    (o.float() ** 2).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize(
    "dtype,t,d,causal,block",
    [("float32", 256, 16, True, 32), ("float32", 200, 32, False, 40),
     ("bfloat16", 256, 32, True, 64)],
)
def test_forced_fused_grads_match_jax_and_the_split_path(dtype, t, d, causal, block,
                                                         monkeypatch, fused_spy):
    """``_FUSED_BWD_OVERRIDE = True`` in both packages (JAX at ``block``-row
    tiles), and the port's split path from the same inputs."""
    arrays = _arrays((1, 2, t, d), seed=60 + t + d, n=3, scale=0.5)
    monkeypatch.setattr(jax_flash, "_FUSED_BWD_OVERRIDE", True)
    want = _loss_grads_jax(*_jax(arrays, dtype), causal, block, block)
    monkeypatch.setattr(torch_flash, "_FUSED_BWD_OVERRIDE", True)
    fused = _loss_grads_torch(arrays, dtype, causal)
    assert len(fused_spy) == 1
    monkeypatch.setattr(torch_flash, "_FUSED_BWD_OVERRIDE", False)
    split = _loss_grads_torch(arrays, dtype, causal)
    assert len(fused_spy) == 1
    for name, f, w, s in zip(("dq", "dk", "dv"), fused, want, split):
        assert f.dtype == getattr(torch, dtype)
        _close(f, w, GRAD_RTOL[dtype], f"{name} vs jax")
        _close(f, s, RTOL[dtype], f"{name} vs split")


@pytest.mark.parametrize("causal", [False, True])
def test_segmented_regime_matches_the_uncapped_fused_call(causal, monkeypatch, fused_spy):
    """The cap shrunk as tests/test_flash_attention.py shrinks it: JAX
    segments T 256 into 4 x 64 rows (``fused_bwd_segmented``); the port,
    under the same cap, takes the fused mechanism in one call."""
    for mod in (jax_flash, torch_flash):
        monkeypatch.setattr(mod, "_FUSED_BWD_OVERRIDE", True)
        monkeypatch.setattr(mod, "_FUSED_MAX_ACC_BYTES", 64 * 8 * 4)
    assert jax_flash._fused_segment_rows(256, 8, 16, 16) == 64
    assert torch_flash._fused_segment_rows(256, 8, 16, 16) == 64
    assert not torch_flash._use_fused_bwd(16, 16, 256, 8)
    arrays = _arrays((1, 2, 256, 8), seed=5, n=3, scale=0.5)
    want = _loss_grads_jax(*_jax(arrays, "float32"), causal, 16, 16)
    got = _loss_grads_torch(arrays, "float32", causal, 16, 16)
    assert fused_spy == [(2, 256, 8)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 3e-5, name)


# The cases of tests/test_flash_attention.py's dispatch-gate and latch
# tests, under every setting of the latch, the override and the env.
DISPATCH_SHAPES = [(4, 4, 4096, 128), (16, 16, 16384, 128), (2, 2, 2048, 128),
                   (8, 2, 8192, 128), (32, 32, 32768, 128), (8, 8, 8192, 128)]


@pytest.mark.parametrize("latch", [False, True])
@pytest.mark.parametrize("override", [None, True, False])
@pytest.mark.parametrize("env", [None, "", "0", "1"])
def test_dispatch_table_matches_jax(latch, override, env, monkeypatch):
    for mod in (jax_flash, torch_flash):
        monkeypatch.setattr(mod, "_FUSED_BWD_VALIDATED", latch)
        monkeypatch.setattr(mod, "_FUSED_BWD_OVERRIDE", override)
    if env is None:
        monkeypatch.delenv("DTX_FUSED_BWD", raising=False)
    else:
        monkeypatch.setenv("DTX_FUSED_BWD", env)
    for nq, nk, tq, d in DISPATCH_SHAPES:
        assert torch_flash._fused_bwd_policy(nq, nk) == jax_flash._fused_bwd_policy(nq, nk)
        assert torch_flash._use_fused_bwd(nq, nk, tq, d) == jax_flash._use_fused_bwd(nq, nk, tq, d)


def test_segment_rows_and_blocks_match_jax():
    for tq, d, bq, bk in [(32768, 128, 1024, 1024), (65536, 128, 1024, 1024),
                          (3 * 1024, 4096, 1024, 1024), (8192, 128, 1024, 1024),
                          (256, 8, 16, 16), (640, 64, 128, 128)]:
        assert torch_flash._fused_segment_rows(tq, d, bq, bk) == jax_flash._fused_segment_rows(tq, d, bq, bk)
    for t in (1, 7, 64, 640, 1000, 2048, 8192, 12289):
        for want in (128, 512, 1024):
            assert torch_flash._pick_block(t, want) == jax_flash._pick_block(t, want)
            assert torch_common.largest_divisor(t, want) == jax_flash._pick_block(t, want)


@pytest.mark.parametrize(
    "name,value",
    [("DTX_FUSED_BWD", "yes"), ("DTX_FUSED_BWD", "true"), ("DTX_FLASH_BQ", "2k"),
     ("DTX_FLASH_BQ", "64"), ("DTX_FLASH_BK", "0"), ("DTX_FLASH_BK", "abc")],
)
def test_env_validation_matches_jax(name, value, monkeypatch):
    """A sweep typo raises ValueError in both packages rather than running
    under a label it does not deserve."""
    monkeypatch.setenv(name, value)
    arrays = _arrays((1, 1, 64, 8), seed=1, n=3)
    with pytest.raises(ValueError, match=name):
        _loss_grads_jax(*_jax(arrays, "float32"), True, None, None)
    with pytest.raises(ValueError, match=name):
        _loss_grads_torch(arrays, "float32", True)


def test_env_blocks_set_the_dispatch_as_in_jax(monkeypatch, fused_spy):
    """DTX_FLASH_BQ/BK = 128 at T 512 gives nq = nk = 4, so DTX_FUSED_BWD=1
    takes the fused backward in both packages; at the default 1024 blocks
    (nq = nk = 1) both stay split."""
    monkeypatch.setenv("DTX_FUSED_BWD", "1")
    arrays = _arrays((1, 1, 512, 16), seed=2, n=3, scale=0.5)
    _loss_grads_torch(arrays, "float32", True)
    assert fused_spy == []
    monkeypatch.setenv("DTX_FLASH_BQ", "128")
    monkeypatch.setenv("DTX_FLASH_BK", "128")
    assert torch_flash._takes_fused(512, 16, 128, 128)
    assert jax_flash._use_fused_bwd(4, 4, 512, 16)
    _loss_grads_torch(arrays, "float32", True)
    assert fused_spy == [(1, 512, 16)]


def test_cpu_fused_backward_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(torch_flash, "_FUSED_BWD_OVERRIDE", True)
    torch_ops.reset_launches()
    grads = _loss_grads_torch(_arrays((1, 2, 128, 32), 3, 3), "float32", True)
    assert all(g is not None for g in grads)
    assert sum(torch_ops.LAUNCHES.values()) == 0


def test_fused_wrapper_refuses_other_devices():
    meta = torch.zeros(2, 64, 32, device="meta")
    lse = torch.zeros(2, 64, 1, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_flash.fused_bwd_call(meta, meta, meta, meta, lse, lse, causal=True)
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="delta"):
        torch_flash.fused_bwd_call(q, q, q, q, torch.zeros(2, 64, 1), torch.zeros(2, 64),
                                   causal=False)


@pytest.mark.parametrize("bh,t", [(16, 8192), (64, 2048), (1, 32768), (2, 100), (200, 640)])
def test_k_tiles_split_over_slices_once_each_and_balanced(bh, t):
    """The fused backward's k groups (``FUSED_GROUP_K`` rows) over its
    ``fused_slices`` blocks: each group owned once, the causal work (group
    j meets nq - 2j q tiles) balanced to within one round."""
    slices = torch_flash.fused_slices(bh, t)
    ng = -(-t // torch_flash.FUSED_GROUP_K)
    nq = -(-t // torch_flash.FUSED_BLOCK_Q)
    assert 1 <= slices <= ng and bh * slices <= max(torch_flash.SMS, bh)
    owned = [torch_flash.owned_k_groups(s, slices, ng) for s in range(slices)]
    assert sorted(g for groups in owned for g in groups) == list(range(ng))
    assert [groups[0] for groups in owned] == list(range(slices))  # first groups store
    causal_work = [sum(nq - 2 * g for g in groups) for groups in owned]
    assert max(causal_work) - min(causal_work) <= nq  # within one round
    if (bh, t) == (16, 8192):
        assert slices == 8 and len(set(causal_work)) == 1


def _ws_bytes_by_visit(bh, t, d, causal):
    """The workspace bytes of one fused call counted visit by visit in the
    kernel's terms: group g (``FUSED_GROUP_K`` = G keys) is a slice's first
    exactly when g < S (round 0), every visit of a ``FUSED_BLOCK_Q``-row q
    tile to a first group stores and every other one reads and writes; the
    reduction reads row r from every slice s with G s <= r (causal) or
    from all."""
    g_rows, q_rows = torch_flash.FUSED_GROUP_K, torch_flash.FUSED_BLOCK_Q
    slices = torch_flash.fused_slices(bh, t)
    ng = -(-t // g_rows)
    walk = 0
    for g in range(ng):
        for q0 in range(g_rows * g if causal else 0, t, q_rows):
            walk += min(q_rows, t - q0) * d * 4 * (1 if g < slices else 2)
    held = [sum(1 for s in range(slices) if not causal or g_rows * s <= r) for r in range(t)]
    return bh * walk, bh * sum(held) * d * 4


@pytest.mark.parametrize("bh,t,d,causal", [(16, 8192, 128, True), (16, 8192, 128, False),
                                           (64, 2048, 128, True), (3, 200, 32, True),
                                           (200, 640, 64, False)])
def test_dq_workspace_bytes_match_the_walk(bh, t, d, causal):
    """``fused_dq_workspace_bytes``, which ``chip_smoke.py`` prints on the
    card, against a count made visit by visit; at the T 8192 path's
    shape the walk moves at most half of what one read-modify-write of
    64 KB per (64-row q tile, 64-row k tile) pair would (8.66 GB)."""
    got = torch_flash.fused_dq_workspace_bytes(bh, t, d, causal=causal)
    assert got == _ws_bytes_by_visit(bh, t, d, causal)
    if (bh, t, d, causal) == (16, 8192, 128, True):
        per_64_tile = 16 * (128 * 129 // 2) * 64 * 128 * 4 * 2
        assert got == (3_854_565_376, 507_510_784)
        assert got[0] <= per_64_tile / 2


def test_parity_twin_passes_on_the_cpu(capsys):
    assert flash_parity.main(["--quick", "--device=cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["parity_ok"] and out["device"] == "cpu" and len(out["cases"]) == 2
    assert all(c["bitwise_deterministic"] for c in out["cases"])


def test_parity_twin_fails_a_wrong_fused_backward(monkeypatch):
    real = torch_flash.fused_bwd_plain

    def wrong(*a, **kw):
        dq, dk, dv = real(*a, **kw)
        return dq * 1.1, dk, dv  # a scale fault in dq

    monkeypatch.setattr(torch_flash, "fused_bwd_plain", wrong)
    rec = flash_parity.run_case(1, 2, 256, 32, torch.float32, True, check_ref=True,
                                device="cpu")
    assert not rec["ok"] and rec["dq_vs_split_rel"] > 0.05
    assert rec["dk_vs_split_rel"] <= 2e-4 and rec["bitwise_deterministic"]
