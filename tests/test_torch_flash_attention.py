"""The port's flash-attention forward against the JAX package's.

Same inputs, made with numpy from a seed, go through the JAX Pallas kernel
(interpret mode on the CPU, as tests/test_flash_attention.py runs it) and
the port's plain PyTorch version, which is what a CPU tensor takes.
Tolerances: atol 1e-5 in float32 (the same algorithm in another summation
order); atol 2e-2 in bfloat16 with the inputs cast identically (outputs
rounded to bf16, whose spacing at |o| ~ 1-2 is 2^-7..2^-6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_tensorflow_examples_tpu.ops import attention as jax_attention
from distributed_tensorflow_examples_tpu.ops import flash_attention as jax_flash
from distributed_tensorflow_examples_tpu_torch import ops as torch_ops
from distributed_tensorflow_examples_tpu_torch.ops import attention as torch_attention
from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as torch_flash

# One intra-op thread: these tiny tests share the machine with the
# timing-sensitive server and fault tests of the other xdist workers.
torch.set_num_threads(1)

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    (dtype, t, d, causal)
    for dtype in ("float32", "bfloat16")
    for t in (128, 200)
    for d in (32, 64)
    for causal in (False, True)
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype,t,d,causal", CASES)
def test_fwd_call_matches_jax(dtype, t, d, causal):
    arrays = _inputs((4, t, d), seed=t + d)
    block = jax_flash._pick_block(t, 64)
    jo, jlse = jax_flash.fwd_call(
        *_jax(arrays, dtype), causal=causal, block_q=block, block_k=block
    )
    to, tlse = torch_flash.fwd_call(*_torch(arrays, dtype), causal=causal)
    assert to.dtype == getattr(torch, dtype) and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == (4, t, 1)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=ATOL[dtype])
    np.testing.assert_allclose(_np(tlse), _np(jlse), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_call_f32_out_dtype_matches_jax(causal):
    """bf16 inputs with ``out_dtype=float32``: the ring/backward partials."""
    arrays = _inputs((4, 128, 64), seed=7)
    jo, _ = jax_flash.fwd_call(
        *_jax(arrays, "bfloat16"), causal=causal, block_q=64, block_k=64,
        out_dtype=jnp.float32,
    )
    to, _ = torch_flash.fwd_call(
        *_torch(arrays, "bfloat16"), causal=causal, out_dtype=torch.float32
    )
    assert to.dtype == torch.float32
    # Both keep the f32 accumulator unrounded, so the only gap is a p that
    # rounds to the other bf16 neighbour (another summation order in s):
    # 2^-8 * p * |v| / l per such term, well under 1e-3 here.
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype,t,d,causal", CASES)
def test_flash_attention_matches_jax_flash_and_mha(dtype, t, d, causal):
    arrays = _inputs((2, 2, t, d), seed=100 + t + d)
    to = torch_flash.flash_attention(*_torch(arrays, dtype), causal=causal)
    jo = jax_flash.flash_attention(*_jax(arrays, dtype), causal=causal)
    jm = jax_attention.mha(*_jax(arrays, "float32"), causal=causal)
    tm = torch_attention.mha(*_torch(arrays, "float32"), causal=causal)
    assert tuple(to.shape) == (2, 2, t, d)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=ATOL[dtype])
    # mha in f32 is the exact softmax; the bf16 flash output is held to it
    # at the bf16 tolerance.
    np.testing.assert_allclose(_np(to), _np(jm), rtol=0, atol=ATOL[dtype])
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=0, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    torch_ops.reset_launches()
    arrays = _inputs((1, 2, 64, 32), seed=3)
    torch_flash.flash_attention(*_torch(arrays, "float32"), causal=True)
    torch_flash.fwd_call(
        *[a.reshape(2, 64, 32) for a in _torch(arrays, "float32")], causal=False
    )
    assert torch_ops.LAUNCHES["flash_fwd"] == 0


def test_auto_gate_is_false_on_cpu_true_on_cuda_shapes():
    assert not torch_flash.flash_viable(2048, "cpu", 128)
    assert torch_flash.flash_viable(2048, "cuda", 128)
    assert torch_flash.flash_viable(1000, "cuda:0", 64)
    assert not torch_flash.flash_viable(2048, "cuda", 96)


def test_fully_masked_rows_contribute_zero():
    """A causal row sees key 0 at least; the plain version must keep the
    finite-NEG_INF contract (no NaN anywhere, lse finite)."""
    arrays = _inputs((2, 70, 32), seed=5)
    o, lse = torch_flash.fwd_plain(*_torch(arrays, "float32"), causal=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # Row 0 attends to key 0 only: o[0] == v[0].
    np.testing.assert_allclose(o[:, 0].numpy(), arrays[2][:, 0], atol=1e-6)


def test_bad_inputs_raise():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError):
        torch_flash.fwd_call(q, q, torch.zeros(2, 64, 16), causal=False)
    with pytest.raises(TypeError):
        torch_flash.fwd_call(q.half(), q.half(), q.half(), causal=False)
    with pytest.raises(TypeError):
        torch_flash.fwd_call(q, q, q, causal=False, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        torch_flash.fwd_call(
            q.to("meta"), q.to("meta"), q.to("meta"), causal=False
        )


def test_entry_point_without_cpu_request_raises_when_no_gpu(monkeypatch):
    from distributed_tensorflow_examples_tpu_torch.utils import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve("cuda:0")
    assert device.resolve("cpu").type == "cpu"
