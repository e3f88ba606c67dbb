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
] + [
    # T 136 crosses the forward's 128-row q block and its 64-row k tile by
    # 8 rows.
    ("bfloat16", 136, 32, True),
    ("float32", 136, 64, False),
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


def test_kernel_checks_refuse_what_the_tensor_core_kernels_cannot_take():
    """The checks every CUDA wrapper runs before a launch: a head dim the
    kernels were not built for, a non-contiguous operand, and a bf16
    operand off a 16-byte boundary (the tensor-core kernels copy 16-byte
    chunks).  Run here on CPU tensors; on the card they raise the same."""
    q = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    torch_flash._cuda_checks("flash_fwd", 32, q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        torch_flash._cuda_checks("flash_fwd", 48, q)
    with pytest.raises(ValueError, match="contiguous"):
        torch_flash._cuda_checks("flash_fwd", 32, q.transpose(0, 1))
    off = torch.zeros(2 * 64 * 32 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 32)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        torch_flash._cuda_checks("flash_fused_bwd", 32, q, off)
    # float32 operands (the CUDA-core kernels) take any 4-byte alignment.
    f = torch.zeros(2 * 64 * 32 + 1)[1:].view(2, 64, 32)
    torch_flash._cuda_checks("flash_fwd", 32, f, f, f)


def _constexprs(source: str) -> dict:
    import re
    from pathlib import Path

    text = (Path(torch_flash.__file__).parent / "csrc" / source).read_text()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_kernel_sources_tile_as_their_plain_versions():
    """The tiles the CUDA sources are written for are the ones the plain
    versions walk (on the card, ``chip_smoke.py`` also asks the built
    libraries): the forward's tensor-core 128-row q block and 64-row k
    tile, dq's 128-row q block and 64-row k tile, dk/dv's 128-key group
    and 64-row q tile, the fused backward's 128-key group and 64-row q
    tile, and the 64-row tiles of the CUDA-core kernels."""
    fwd, fused = _constexprs("flash_fwd.cu"), _constexprs("flash_fused_bwd.cu")
    split = _constexprs("flash_bwd.cu")
    assert (fwd["kTcBlockQ"], fwd["kTcBlockK"]) == (torch_flash.FWD_BLOCK_Q,
                                                     torch_flash.FWD_BLOCK_K)
    assert (fused["kQTile"], fused["kGroup"]) == (torch_flash.FUSED_BLOCK_Q,
                                                   torch_flash.FUSED_GROUP_K)
    assert fwd["kBlockQ"] == fwd["kBlockK"] == fused["kBlock"] == torch_flash.BLOCK
    assert split["kBlock"] == torch_flash.BLOCK
    assert (split["kDqBlockQ"], split["kDqBlockK"]) == (torch_flash.DQ_BLOCK_Q,
                                                         torch_flash.DQ_BLOCK_K)
    assert (split["kDkvBlockQ"], split["kDkvGroupK"]) == (torch_flash.DKV_BLOCK_Q,
                                                           torch_flash.DKV_GROUP_K)


@pytest.mark.parametrize("tensor_core", [True, False])
def test_launch_counts_record_the_route_the_library_took(monkeypatch, tensor_core):
    """A launch adds one to its kernel's count, and to its tensor-core
    count only where the library says it took the tensor-core kernel;
    ``reset_launches`` clears both."""
    monkeypatch.setattr(torch_flash, "kernel_route",
                        lambda name, i, o: (tensor_core, (128, 64)))
    torch_ops.reset_launches()
    names = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fused_bwd")
    for name in names:
        torch_flash._count_launch(name, torch.bfloat16, torch.bfloat16)
    for name in names:
        assert torch_ops.LAUNCHES[name] == 1
        assert torch_ops.TENSOR_CORE_LAUNCHES[name] == int(tensor_core)
    torch_ops.reset_launches()
    assert not torch_ops.LAUNCHES and not torch_ops.TENSOR_CORE_LAUNCHES


def test_kernel_route_asks_the_library_that_holds_the_kernel(monkeypatch):
    """The split pair's routes live in library ``flash_bwd``
    (``dtx_flash_dq_route``, ``dtx_flash_dkv_route``); the others in the
    library of their own name.  A stand-in library answers here."""
    asked = []

    class Library:
        def __getattr__(self, fn_name):
            def route(i, o, tiles):
                tiles[0], tiles[1] = 64, 128
                return int(i == o == 1)
            return route

    monkeypatch.setattr(torch_flash._build, "load", lambda lib: asked.append(lib) or Library())
    route = torch_flash.kernel_route.__wrapped__  # the cache would keep the stand-in's answer
    bf16, f32 = torch.bfloat16, torch.float32
    assert route("flash_dq", bf16, bf16) == (True, (64, 128))
    assert route("flash_dkv", bf16, f32) == (False, (64, 128))
    assert route("flash_fwd", bf16, bf16)[0] and route("flash_fused_bwd", f32, f32) == (
        False, (64, 128))
    assert asked == ["flash_bwd", "flash_bwd", "flash_fwd", "flash_fused_bwd"]
