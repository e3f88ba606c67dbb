"""Flash attention, forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

The port of ``distributed_tensorflow_examples_tpu/ops/flash_attention.py``'s
forward.  The kernel (``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel
``_fwd_kernel``; its source note says what bounds it on the card and how
its design answers that.  The contract is the JAX one:

- q, k, v fold to [B*H, T, D]; q is scaled once by ``log2(e)/sqrt(D)`` in
  its own dtype, and the online softmax runs in base 2 (``exp2``);
- f32 running max, running sum and accumulator; p enters the p.v product
  in v's dtype;
- masked scores take the finite ``NEG_INF`` and fully masked rows add 0;
- ``o`` comes back in the input dtype, or in ``out_dtype`` (f32 for the
  partials that ring attention and the backward will merge), and ``lse``
  [B*H, T, 1] f32 in natural log: ``m*ln2 + log(l)``.

:func:`fwd_call` runs the kernel on CUDA tensors and the plain version
(:func:`fwd_plain`, the same algorithm tile by tile) on CPU tensors only.
A CUDA tensor the kernel does not take raises; nothing falls back.  The
backward kernels come with the training slice, so until then a CUDA input
that requires grad raises too.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

#: Rows of one q tile and of one k/v tile, in the kernel and the plain version.
BLOCK = 64
#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, out_dtype):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [BH, T, D] shape; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share a dtype in float32/bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if out_dtype is not None and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}"
        )


def fwd_call(q, k, v, *, causal: bool, out_dtype=None):
    """``(o, lse)`` for q, k, v [BH, T, D]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, an error on anything else."""
    _check(q, k, v, out_dtype)
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, causal=causal, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q.device}")
    return _fwd_cuda(q, k, v, causal=causal, out_dtype=out_dtype)


def _fwd_cuda(q, k, v, *, causal, out_dtype):
    bh, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dims {HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel needs contiguous q, k, v")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention has no backward kernel yet (the training "
            "slice adds it); call under torch.no_grad/inference_mode"
        )
    out_dtype = out_dtype or q.dtype
    lib = _build.load("flash_fwd")
    fn = lib.dtx_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, d, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[out_dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed with cudaError_t {err} "
            f"(shape {tuple(q.shape)}, {q.dtype} -> {out_dtype})"
        )
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def fwd_plain(q, k, v, *, causal: bool, out_dtype=None):
    """The kernel's algorithm in plain PyTorch, tile by tile (``BLOCK``
    rows, base 2, the same lse contract) — the reference the CPU tests
    hold against JAX and the card holds the kernel against."""
    _check(q, k, v, out_dtype)
    bh, t, d = q.shape
    out_dtype = out_dtype or q.dtype
    f32 = torch.float32
    qs = (q * torch.tensor((1.0 / math.sqrt(d)) * LOG2E, dtype=q.dtype)).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t, 1), dtype=f32, device=q.device)
    for q0 in range(0, t, BLOCK):
        q1 = min(q0 + BLOCK, t)
        m = torch.full((bh, q1 - q0, 1), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((bh, q1 - q0, 1), dtype=f32, device=q.device)
        acc = torch.zeros((bh, q1 - q0, d), dtype=f32, device=q.device)
        k_stop = q1 if causal else t  # causal: no tile above the diagonal
        for k0 in range(0, k_stop, BLOCK):
            k1 = min(k0 + BLOCK, t)
            s = qs[:, q0:q1] @ kf[:, k0:k1].transpose(1, 2)
            masked = causal and k1 - 1 > q0
            if masked:
                qpos = torch.arange(q0, q1, device=q.device)[:, None]
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                s = s.masked_fill(kpos > qpos, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            if masked:
                p = p * (s > NEG_INF / 2)
            alpha = torch.exp2(m - m_new)
            acc = acc * alpha + p.to(v.dtype).to(f32) @ vf[:, k0:k1]
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        o[:, q0:q1] = (acc / l_safe).to(out_dtype)
        lse[:, q0:q1] = m * LN2 + torch.log(l_safe)
    return o, lse


def flash_viable(t: int, device, head_dim: int) -> bool:
    """The ``attention="auto"`` gate: the kernel when the tensors live on a
    CUDA device and the kernel takes the shape (any T >= 1, a head dim in
    ``HEAD_DIMS``).  False on the CPU, so auto means ``mha`` there, as the
    JAX gate means XLA attention off the TPU."""
    return torch.device(device).type == "cuda" and t >= 1 and head_dim in HEAD_DIMS


def flash_attention(q, k, v, *, causal: bool = False):
    """Drop-in for ``ops.attention.mha``: q/k/v [B, H, T, D] -> [B, H, T, D]."""
    B, H, T, D = q.shape
    fold = lambda x: x.reshape(B * H, T, D).contiguous()
    o, _ = fwd_call(fold(q), fold(k), fold(v), causal=causal)
    return o.reshape(B, H, T, D)
