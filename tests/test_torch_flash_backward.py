"""The port's flash-attention backward against the JAX package's.

Same inputs, made with numpy from a seed, go through the JAX Pallas
kernels ``dq_call``/``dkv_call`` (interpret mode on the CPU, as
tests/test_flash_attention.py runs them, with the JAX package's own
``_pick_block`` tiles) and the port's plain PyTorch versions, which is
what a CPU tensor takes; lse and delta come from the JAX forward, so both
sides see the same saved state.  Then the port's differentiable
``flash_attention`` against ``jax.grad`` of the JAX one.

Tolerances.  float32: 2e-6 relative to the largest entry (the same
algorithm with other tiles, so only the f32 summation order differs;
seen: 4e-7).  bfloat16: 8e-3 relative to the largest entry, two bf16
steps there (the outputs are bf16, spacing 2^-8 relative, and p and ds
round to bf16 inside the products, where a value on the other side of a
rounding boundary moves one product term by 2^-8 of itself; seen: 1.2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_examples_tpu.ops import flash_attention as jax_flash
from distributed_tensorflow_examples_tpu_torch import ops as torch_ops
from distributed_tensorflow_examples_tpu_torch.ops import attention as torch_attention
from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as torch_flash

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

RTOL = {"float32": 2e-6, "bfloat16": 8e-3}
CASES = [
    (dtype, t, d, causal)
    for dtype in ("float32", "bfloat16")
    for t in (128, 200)
    for d in (32, 64)
    for causal in (False, True)
]


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
            for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max |port - jax| = {err:.3e} vs {rtol * scale:.3e}"


def _saved_state(arrays, dtype, causal, block):
    """q, k, v, do in both frameworks plus the JAX forward's lse and
    delta (as float32 numpy)."""
    jq, jk, jv, jdo = _jax(arrays, dtype)
    jo, jlse = jax_flash.fwd_call(jq, jk, jv, causal=causal, block_q=block, block_k=block)
    jdelta = jax_flash.compute_delta(jdo, jo)
    return (jq, jk, jv, jdo, jlse, jdelta), np.array(jlse), np.array(jdelta)


@pytest.mark.parametrize("dtype,t,d,causal", CASES)
def test_dq_and_dkv_match_jax(dtype, t, d, causal):
    arrays = _arrays((2, t, d), seed=t + d + causal)
    block = jax_flash._pick_block(t, 64)
    jargs, lse, delta = _saved_state(arrays, dtype, causal, block)
    jdq = jax_flash.dq_call(*jargs, causal=causal, block_q=block, block_k=block)
    jdk, jdv = jax_flash.dkv_call(*jargs, causal=causal, block_q=block, block_k=block)
    targs = _torch(arrays, dtype) + [torch.from_numpy(lse), torch.from_numpy(delta)]
    tdq = torch_flash.dq_call(*targs, causal=causal)
    tdk, tdv = torch_flash.dkv_call(*targs, causal=causal)
    for x in (tdq, tdk, tdv):
        assert x.dtype == getattr(torch, dtype) and tuple(x.shape) == (2, t, d)
    _close(tdq, jdq, RTOL[dtype])
    _close(tdk, jdk, RTOL[dtype])
    _close(tdv, jdv, RTOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_f32_out_dtype_matches_jax(causal):
    """bf16 inputs with ``out_dtype=float32``: the ring partials' form."""
    arrays = _arrays((2, 128, 64), seed=9)
    jargs, lse, delta = _saved_state(arrays, "bfloat16", causal, 64)
    kw = dict(causal=causal, block_q=64, block_k=64, out_dtype=jnp.float32)
    jdq = jax_flash.dq_call(*jargs, **kw)
    jdk, jdv = jax_flash.dkv_call(*jargs, **kw)
    targs = _torch(arrays, "bfloat16") + [torch.from_numpy(lse), torch.from_numpy(delta)]
    tdq = torch_flash.dq_call(*targs, causal=causal, out_dtype=torch.float32)
    tdk, tdv = torch_flash.dkv_call(*targs, causal=causal, out_dtype=torch.float32)
    assert tdq.dtype == tdk.dtype == tdv.dtype == torch.float32
    # Unrounded f32 outputs: only p/ds values landing on the other side of
    # a bf16 rounding boundary differ (2^-8 of one term each).
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        _close(got, want, 5e-3)


@pytest.mark.parametrize(
    "dtype,t,causal",
    [("float32", 128, True), ("float32", 200, False), ("bfloat16", 128, True),
     ("bfloat16", 200, True)],
)
def test_flash_attention_grads_match_jax_grad(dtype, t, causal):
    """The autograd Function end to end: d(sum(o * w))/d(q, k, v)."""
    q, k, v, w = _arrays((2, 2, t, 32), seed=50 + t)
    jq, jk, jv = _jax([q, k, v], dtype)
    jw = jnp.asarray(w)

    def f(q_, k_, v_):
        o = jax_flash.flash_attention(q_, k_, v_, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jw)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (x.requires_grad_() for x in _torch([q, k, v], dtype))
    o = torch_flash.flash_attention(tq, tk, tv, causal=causal)
    (o.float() * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, RTOL[dtype])


def test_flash_grads_match_mha_autograd_in_f32():
    """The Function's grads against autograd through plain mha."""
    q, k, v, w = _arrays((1, 2, 130, 64), seed=77)
    leaves = [x.requires_grad_() for x in _torch([q, k, v], "float32")]
    (torch_flash.flash_attention(*leaves, causal=True) * torch.from_numpy(w)).sum().backward()
    ref = [x.detach().clone().requires_grad_() for x in leaves]
    (torch_attention.mha(*ref, causal=True) * torch.from_numpy(w)).sum().backward()
    for got, want in zip(leaves, ref):
        _close(got.grad, want.grad, 1e-5)


def test_cpu_backward_launches_no_kernel():
    torch_ops.reset_launches()
    q, k, v = (x.requires_grad_() for x in _torch(_arrays((1, 2, 64, 32), 3, 3), "float32"))
    torch_flash.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None
    assert sum(torch_ops.LAUNCHES.values()) == 0


def test_fused_backward_env(monkeypatch):
    """``DTX_FUSED_BWD=1`` at T 64 (one 64-row block: nq = nk = 1, under the
    fused regime) runs the split backward, as the JAX ``_bwd`` does; a
    value other than ''/0/1 raises."""
    q, k, v = (x.requires_grad_() for x in _torch(_arrays((1, 1, 64, 32), 4, 3), "float32"))
    monkeypatch.setenv("DTX_FUSED_BWD", "1")
    calls = []
    monkeypatch.setattr(torch_flash, "fused_bwd_call", lambda *a, **kw: calls.append(a))
    torch_flash.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and not calls
    assert not jax_flash._use_fused_bwd(1, 1, 64, 32)
    q.grad = None
    monkeypatch.setenv("DTX_FUSED_BWD", "yes")
    with pytest.raises(ValueError, match="DTX_FUSED_BWD"):
        torch_flash.flash_attention(q, k, v, causal=True).sum().backward()
    monkeypatch.setenv("DTX_FUSED_BWD", "0")
    torch_flash.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None


@pytest.mark.parametrize("d,causal", [(32, True), (64, False)])
def test_tensor_core_tiles_and_block_tiles_agree(d, causal):
    """The plain bf16 walk on the tensor-core tiles (dq: 128-row q blocks,
    64-row k tiles; dk/dv: 128-key groups, 64-row q tiles), which the plain
    versions take, against the ``BLOCK`` walk of the CUDA-core kernels
    (any f32 side), at T 200: it crosses a
    128-row tile and ends on a ragged one.  They visit the same key tiles
    per row in the same order (the larger tiles add only fully masked,
    exactly zero, contributions), so they agree to f32 rounding."""
    q, k, v, do = _torch(_arrays((2, 200, d), seed=d + causal), "bfloat16")
    o, lse = torch_flash.fwd_plain(q, k, v, causal=causal)
    args = (q, k, v, do, lse, torch_flash.compute_delta(do, o), causal)
    blk = torch_flash.BLOCK
    tc = (torch_flash._dq_walk(*args, torch_flash.DQ_BLOCK_Q, torch_flash.DQ_BLOCK_K),
          *torch_flash._dkv_walk(*args, torch_flash.DKV_BLOCK_Q, torch_flash.DKV_GROUP_K))
    plain = (torch_flash._dq_walk(*args, blk, blk), *torch_flash._dkv_walk(*args, blk, blk))
    for got, want in zip(tc, plain):
        assert got.dtype == torch.float32
        _close(got, want, 1e-6)


def test_bad_backward_inputs_raise():
    q = torch.zeros(2, 64, 32)
    lse = torch.zeros(2, 64, 1)
    with pytest.raises(ValueError, match="do"):
        torch_flash.dq_call(q, q, q, q.bfloat16(), lse, lse, causal=True)
    with pytest.raises(ValueError, match="lse"):
        torch_flash.dkv_call(q, q, q, q, lse.double(), lse, causal=True)
    with pytest.raises(ValueError, match="delta"):
        torch_flash.dq_call(q, q, q, q, lse, torch.zeros(2, 64), causal=False)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_flash.dkv_call(meta, meta, meta, meta, lse.to("meta"), lse.to("meta"),
                             causal=False)
