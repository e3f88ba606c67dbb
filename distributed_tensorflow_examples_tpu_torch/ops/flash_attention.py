"""Flash attention, forward and backward (split and fused): hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

The port of ``distributed_tensorflow_examples_tpu/ops/flash_attention.py``.
The kernels replace the Pallas TPU kernels ``_fwd_kernel``
(``csrc/flash_fwd.cu``), ``_dq_kernel`` and ``_dkv_kernel``
(``csrc/flash_bwd.cu``) and ``_fused_bwd_kernel``
(``csrc/flash_fused_bwd.cu``); each source note says what bounds it on the
card and how its design answers that.  The contract is the JAX one:

- q, k, v fold to [B*H, T, D]; q is scaled once by ``log2(e)/sqrt(D)`` in
  its own dtype, and the online softmax runs in base 2 (``exp2``);
- f32 running max, running sum and accumulator; p enters the p.v product
  in v's dtype;
- masked scores take the finite ``NEG_INF`` and fully masked rows add 0;
- ``o`` comes back in the input dtype, or in ``out_dtype`` (f32 for the
  partials that ring attention and the backward will merge), and ``lse``
  [B*H, T, 1] f32 in natural log: ``m*ln2 + log(l)``.

- the backward (FA2) recomputes p = exp2(s - lse*log2(e)) from the saved
  lse, with delta = rowsum(do*o) in f32 (:func:`compute_delta`), and
  keeps the JAX operand casts: p enters p^T.do in do's dtype, ds enters
  ds.k in k's dtype and ds^T.q in q's; dq is scaled by 1/sqrt(D) and dk
  by 1/log2(e) at the end.

- the fused backward (:func:`fused_bwd_call`) computes dq, dk and dv from
  one s/p per tile pair (5 block products instead of the split pair's 7);
  each ds.k contribution to dq is scaled by 1/sqrt(D) before it is added,
  as ``_fused_bwd_kernel`` does, where the split dq scales once at the end.

:func:`fwd_call`, :func:`dq_call`, :func:`dkv_call` and
:func:`fused_bwd_call` run the kernel on CUDA tensors and the plain
version (:func:`fwd_plain`, :func:`dq_plain`, :func:`dkv_plain`,
:func:`fused_bwd_plain`: the same algorithm tile by tile) on CPU tensors
only.  A CUDA tensor the kernel does not take raises; nothing falls back.

:func:`flash_attention` is differentiable through :class:`FlashAttention`,
whose backward takes the JAX ``_bwd``'s decision: the fused kernel where
:func:`_fused_bwd_policy` wants it (nq, nk >= 4 and ``DTX_FUSED_BWD=1``,
the ``_FUSED_BWD_VALIDATED`` latch, or ``_FUSED_BWD_OVERRIDE``), the split
pair otherwise.  nq and nk come from the JAX block sizes (``block_q``/
``block_k``, or ``DTX_FLASH_BQ``/``DTX_FLASH_BK``, default 1024, each cut
to the largest divisor of T by :func:`_pick_block`); they only decide the
dispatch.  The Hopper kernels tile by their own sizes whatever the blocks
say: the forward 128-row q blocks and 64-row k tiles (``FWD_BLOCK_Q``,
``FWD_BLOCK_K``), dq 128-row q blocks and 64-row k tiles (``DQ_BLOCK_Q``,
``DQ_BLOCK_K``), dk/dv 128-row k groups and 64-row q tiles
(``DKV_GROUP_K``, ``DKV_BLOCK_Q``), the fused backward 128-row k groups
and 64-row q tiles (``FUSED_GROUP_K``, ``FUSED_BLOCK_Q``); each plain
version walks its kernel's tiles in its kernel's order.  bf16 in and out
runs every flash kernel on the tensor cores; f32 in or out runs CUDA-core
kernels with 64-row tiles (``BLOCK``), which sum in another order (f32
rounding apart, the same result).
Where the reference segments q past its VMEM cap
(``fused_bwd_segmented``), the port runs one fused call: its dq lives in
device memory and has no cap, and the results agree (the tests hold them).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from . import LAUNCHES, TENSOR_CORE_LAUNCHES, _build
from .common import largest_divisor

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

#: Rows of one q tile and of one k/v tile of the CUDA-core kernels (any f32
#: side), which sum in another order than the plain versions' tiles.
BLOCK = 64
#: The forward's q block (8 warps of 16 rows) and k/v tile, in the kernel
#: and the plain version: the online softmax rescales at every k tile.
FWD_BLOCK_Q = 128
FWD_BLOCK_K = 64
#: The fused backward's k group (8 warps of 16 keys; a block sums the whole
#: group's dq contribution before it touches its workspace slice) and its
#: streamed q tile, in the kernel and the plain version.
FUSED_GROUP_K = 128
FUSED_BLOCK_Q = 64
#: The split backward on the tensor cores (bf16 in and out), in the kernels
#: and the plain versions: dq's q block (8 warps of 16 rows) and streamed
#: k/v tile; dk/dv's k group (8 warps of 16 keys) and streamed q tile.
DQ_BLOCK_Q, DQ_BLOCK_K = 128, 64
DKV_GROUP_K, DKV_BLOCK_Q = 128, 64
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


def _device_of(name: str, q) -> str:
    """``q``'s device type where a kernel wrapper accepts it: cpu (the
    plain version) or cuda (the kernel)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q.device}")
    return q.device.type


def fwd_call(q, k, v, *, causal: bool, out_dtype=None):
    """``(o, lse)`` for q, k, v [BH, T, D]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, an error on anything else."""
    _check(q, k, v, out_dtype)
    if _device_of("flash_fwd", q) == "cpu":
        return fwd_plain(q, k, v, causal=causal, out_dtype=out_dtype)
    return _fwd_cuda(q, k, v, causal=causal, out_dtype=out_dtype)


def _cuda_checks(name: str, d: int, *tensors) -> None:
    """What every kernel wrapper refuses: a head dim the kernel was not
    instantiated for, a non-contiguous operand, or a bf16 operand off a
    16-byte boundary (the tensor-core kernels copy 16-byte chunks)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dims {HEAD_DIMS}, got {d}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} kernel needs contiguous operands")
    if any(x.dtype == torch.bfloat16 and x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name} kernel needs 16-byte aligned bfloat16 operands")


def _raise_on(name: str, err: int, q, out_dtype) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with cudaError_t {err} "
            f"(shape {tuple(q.shape)}, {q.dtype} -> {out_dtype})"
        )


#: The library a kernel lives in, where its name differs from the kernel's.
_LIBRARY = {"flash_dq": "flash_bwd", "flash_dkv": "flash_bwd"}


@functools.cache
def kernel_route(name: str, in_dtype, out_dtype) -> tuple[bool, tuple[int, int]]:
    """What the built library of kernel ``name`` (``"flash_fwd"``,
    ``"flash_dq"``, ``"flash_dkv"`` or ``"flash_fused_bwd"``; the split
    pair lives in ``flash_bwd``) launches for these dtypes, as the library
    itself decides: whether it takes the tensor-core kernel, and that
    kernel's (q rows, k rows) tile.  Builds the library if needed."""
    tiles = (ctypes.c_int * 2)()
    fn = getattr(_build.load(_LIBRARY.get(name, name)), f"dtx_{name}_route")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tc = fn(_DTYPE_CODES[in_dtype], _DTYPE_CODES[out_dtype], tiles)
    return bool(tc), (tiles[0], tiles[1])


def _count_launch(name: str, in_dtype, out_dtype) -> None:
    LAUNCHES[name] += 1
    if kernel_route(name, in_dtype, out_dtype)[0]:
        TENSOR_CORE_LAUNCHES[name] += 1


def _fwd_cuda(q, k, v, *, causal, out_dtype):
    bh, t, d = q.shape
    _cuda_checks("flash_fwd", d, q, k, v)
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
    _raise_on("flash_fwd", err, q, out_dtype)
    _count_launch("flash_fwd", q.dtype, out_dtype)
    return o, lse


def fwd_plain(q, k, v, *, causal: bool, out_dtype=None):
    """The kernel's algorithm in plain PyTorch, tile by tile
    (``FWD_BLOCK_Q``-row q blocks, ``FWD_BLOCK_K``-row k tiles up to the
    block's last row when causal, base 2, the same lse contract) — the
    reference the CPU tests hold against JAX and the card holds the kernel
    against.  (The kernel's warps also skip the k tiles above their own
    16 rows; for those rows such a tile is fully masked, which leaves m, l
    and the accumulator exactly as they were.)"""
    _check(q, k, v, out_dtype)
    bh, t, d = q.shape
    out_dtype = out_dtype or q.dtype
    f32 = torch.float32
    qs = (q * torch.tensor((1.0 / math.sqrt(d)) * LOG2E, dtype=q.dtype)).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    o = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t, 1), dtype=f32, device=q.device)
    for q0 in range(0, t, FWD_BLOCK_Q):
        q1 = min(q0 + FWD_BLOCK_Q, t)
        m = torch.full((bh, q1 - q0, 1), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((bh, q1 - q0, 1), dtype=f32, device=q.device)
        acc = torch.zeros((bh, q1 - q0, d), dtype=f32, device=q.device)
        k_stop = q1 if causal else t  # causal: no tile above the diagonal
        for k0 in range(0, k_stop, FWD_BLOCK_K):
            k1 = min(k0 + FWD_BLOCK_K, t)
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


# ----------------------------------------------------------------------------
# Backward (FA2): dq and dk/dv, the split backward
# ----------------------------------------------------------------------------


def compute_delta(do, o):
    """FA2's delta = rowsum(do * o) in f32, [BH, T, 1]: a plain reduction
    (the JAX package computes it outside any Pallas kernel too)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1, keepdim=True)


def _check_bwd(q, k, v, do, lse, delta, out_dtype):
    _check(q, k, v, out_dtype)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q's shape, dtype and device; got {tuple(do.shape)} "
            f"{do.dtype} on {do.device} for q {tuple(q.shape)} {q.dtype}"
        )
    want = (q.shape[0], q.shape[1], 1)
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != want or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(
                f"{name} must be float32 {want} on {q.device}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )


def dq_call(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """dq [BH, T, D] (in q's dtype, or ``out_dtype``) for q, k, v, do
    [BH, T, D] and the forward's lse and :func:`compute_delta`'s delta
    [BH, T, 1] f32: the kernel on a CUDA tensor, the plain version on a
    CPU tensor, an error on anything else."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    if _device_of("flash_dq", q) == "cpu":
        return dq_plain(q, k, v, do, lse, delta, causal=causal, out_dtype=out_dtype)
    bh, t, d = q.shape
    _cuda_checks("flash_dq", d, q, k, v, do, lse, delta)
    out_dtype = out_dtype or q.dtype
    fn = _build.load("flash_bwd").dtx_flash_dq
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on("flash_dq", err, q, out_dtype)
    _count_launch("flash_dq", q.dtype, out_dtype)
    return dq


def dkv_call(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """``(dk, dv)`` [BH, T, D] (in k's and v's dtype, or ``out_dtype``) for
    the same inputs as :func:`dq_call`: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, an error on anything else."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    if _device_of("flash_dkv", q) == "cpu":
        return dkv_plain(q, k, v, do, lse, delta, causal=causal, out_dtype=out_dtype)
    bh, t, d = q.shape
    _cuda_checks("flash_dkv", d, q, k, v, do, lse, delta)
    out_dtype = out_dtype or k.dtype
    fn = _build.load("flash_bwd").dtx_flash_dkv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dk = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, d, _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype],
            int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on("flash_dkv", err, q, out_dtype)
    _count_launch("flash_dkv", q.dtype, out_dtype)
    return dk, dv


def _bwd_operands(q, k, v, do, lse):
    """The f32 views both plain versions work on: q scaled by
    ``log2(e)/sqrt(D)`` in its own dtype (the fold), k, v, do widened, and
    the base-2 lse."""
    f32 = torch.float32
    qs = q * torch.tensor((1.0 / math.sqrt(q.shape[-1])) * LOG2E, dtype=q.dtype)
    return qs.to(f32), k.to(f32), v.to(f32), do.to(f32), lse * LOG2E


def _probs(qs, kf, lse2, q0, q1, k0, k1, causal):
    """p = exp2(s - lse2) for one (q tile, k tile) pair, [BH, bq, bk] f32,
    with the diagonal tile's masked scores contributing exactly 0."""
    s = qs[:, q0:q1] @ kf[:, k0:k1].transpose(1, 2)
    masked = causal and k1 - 1 > q0
    if masked:
        qpos = torch.arange(q0, q1, device=qs.device)[:, None]
        kpos = torch.arange(k0, k1, device=qs.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    p = torch.exp2(s - lse2[:, q0:q1])
    if masked:
        p = p * (s > NEG_INF / 2)
    return p


def dq_plain(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """The dq kernel's algorithm in plain PyTorch, tile by tile on the
    tensor-core kernel's ``DQ_BLOCK_Q``-row q blocks and ``DQ_BLOCK_K``-row
    k tiles (:func:`_dq_walk`)."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    dq = _dq_walk(q, k, v, do, lse, delta, causal, DQ_BLOCK_Q, DQ_BLOCK_K)
    return dq.to(out_dtype or q.dtype)


def _dq_walk(q, k, v, do, lse, delta, causal, block_q, block_k):
    """dq in f32: for each ``block_q``-row q block, a loop over
    ``block_k``-row k tiles that stops at the block's last row when
    causal.  (The tensor-core kernel's warps also skip the k tiles above
    their own 16 rows; there p = 0, so ds = 0.)"""
    bh, t, d = q.shape
    f32 = torch.float32
    qs, kf, vf, dof, lse2 = _bwd_operands(q, k, v, do, lse)
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    for q0 in range(0, t, block_q):
        q1 = min(q0 + block_q, t)
        acc = torch.zeros((bh, q1 - q0, d), dtype=f32, device=q.device)
        k_stop = q1 if causal else t  # causal: no tile above the diagonal
        for k0 in range(0, k_stop, block_k):
            k1 = min(k0 + block_k, t)
            p = _probs(qs, kf, lse2, q0, q1, k0, k1, causal)
            dp = dof[:, q0:q1] @ vf[:, k0:k1].transpose(1, 2)
            ds = p * (dp - delta[:, q0:q1])
            acc = acc + ds.to(k.dtype).to(f32) @ kf[:, k0:k1]
        dq[:, q0:q1] = acc * (1.0 / math.sqrt(d))
    return dq


def dkv_plain(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """The dk/dv kernel's algorithm in plain PyTorch, tile by tile on the
    tensor-core kernel's ``DKV_GROUP_K``-row k groups and
    ``DKV_BLOCK_Q``-row q tiles (:func:`_dkv_walk`)."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    dk, dv = _dkv_walk(q, k, v, do, lse, delta, causal, DKV_BLOCK_Q, DKV_GROUP_K)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def _dkv_walk(q, k, v, do, lse, delta, causal, block_q, group_k):
    """dk and dv in f32: for each ``group_k``-row k group, a loop over
    ``block_q``-row q tiles that starts at the group's diagonal when
    causal."""
    bh, t, d = q.shape
    f32 = torch.float32
    qs, kf, vf, dof, lse2 = _bwd_operands(q, k, v, do, lse)
    dk = torch.empty(k.shape, dtype=f32, device=q.device)
    dv = torch.empty(v.shape, dtype=f32, device=q.device)
    for k0 in range(0, t, group_k):
        k1 = min(k0 + group_k, t)
        dk_acc = torch.zeros((bh, k1 - k0, d), dtype=f32, device=q.device)
        dv_acc = torch.zeros((bh, k1 - k0, d), dtype=f32, device=q.device)
        q_start = k0 if causal else 0  # causal: no tile above the diagonal
        for q0 in range(q_start, t, block_q):
            q1 = min(q0 + block_q, t)
            p = _probs(qs, kf, lse2, q0, q1, k0, k1, causal)
            dv_acc = dv_acc + p.to(do.dtype).to(f32).transpose(1, 2) @ dof[:, q0:q1]
            dp = dof[:, q0:q1] @ vf[:, k0:k1].transpose(1, 2)
            ds = p * (dp - delta[:, q0:q1])
            dk_acc = dk_acc + ds.to(q.dtype).to(f32).transpose(1, 2) @ qs[:, q0:q1]
        dk[:, k0:k1] = dk_acc * (1.0 / LOG2E)
        dv[:, k0:k1] = dv_acc
    return dk, dv


# ----------------------------------------------------------------------------
# Fused backward: dq, dk and dv from one s/p per tile pair
# ----------------------------------------------------------------------------

#: Streaming multiprocessors of the H100 the fused kernel is laid out for.
#: Its grid is (BH, S): S blocks per batch*head share the k groups, so
#: BH * S blocks fill the card.  S depends on the shape alone, never on the
#: card a run lands on, so a shape gives the same bits everywhere.
SMS = 132


def fused_slices(bh: int, t: int) -> int:
    """S, the number of blocks (and of f32 dq workspace slices) per
    batch*head of the fused backward: as many as fill ``SMS`` with one
    block each, at most one per ``FUSED_GROUP_K``-row k group."""
    ng = -(-t // FUSED_GROUP_K)
    return max(1, min(ng, SMS // bh))


def owned_k_groups(s: int, slices: int, ng: int) -> list[int]:
    """The k groups block ``s`` of ``slices`` owns, in the order it visits
    them: round r takes group ``r*S + s`` on even rounds and ``r*S + S-1-s``
    on odd ones (a snake), so under a causal mask, where group j meets
    nq - 2j q tiles, every block gets the same work to within one round."""
    out = []
    for r in range(-(-ng // slices)):
        g = r * slices + (slices - 1 - s if r % 2 else s)
        if g < ng:
            out.append(g)
    return out


def fused_dq_workspace_bytes(bh: int, t: int, d: int, *, causal: bool) -> tuple[int, int]:
    """Bytes of the f32 dq workspace one fused call moves on the card:
    (the blocks' walk, the reduction).  The walk writes each (q tile, k
    group) visit's rows of the block's slice and, past the block's first
    group, reads them first; the reduction reads, for each row, every slice
    that holds it (causal: the slices whose first group is at or below the
    row).  Both in the order of :func:`fused_bwd_plain`'s walk."""
    slices, ng = fused_slices(bh, t), -(-t // FUSED_GROUP_K)
    row_bytes = d * 4
    walk = 0
    for s in range(slices):
        for i, g in enumerate(owned_k_groups(s, slices, ng)):
            start = g * FUSED_GROUP_K if causal else 0  # causal: from the diagonal
            for q0 in range(start, t, FUSED_BLOCK_Q):
                rows = min(FUSED_BLOCK_Q, t - q0)
                walk += rows * row_bytes * (1 if i == 0 else 2)
    # Slice s holds the rows from its first group on (causal), or all.
    reads = sum(t - s * FUSED_GROUP_K if causal else t for s in range(slices))
    return bh * walk, bh * reads * row_bytes


def fused_bwd_call(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """``(dq, dk, dv)`` [BH, T, D] (in the input dtype, or ``out_dtype``:
    f32 for the partials ring attention merges) for the same inputs as
    :func:`dq_call`: the fused kernel on a CUDA tensor, the plain version
    on a CPU tensor, an error on anything else."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    if _device_of("flash_fused_bwd", q) == "cpu":
        return fused_bwd_plain(q, k, v, do, lse, delta, causal=causal, out_dtype=out_dtype)
    bh, t, d = q.shape
    _cuda_checks("flash_fused_bwd", d, q, k, v, do, lse, delta)
    out_dtype = out_dtype or q.dtype
    fn = _build.load("flash_fused_bwd").dtx_flash_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    slices = fused_slices(bh, t)
    # No memset: a block's first k group stores every row its slice will
    # hold, and the reduction reads only the slices that hold a row.
    ws = torch.empty((slices, bh, t, d), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty(q.shape, dtype=out_dtype, device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ws.data_ptr(), bh, t, d, slices,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype], int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on("flash_fused_bwd", err, q, out_dtype)
    _count_launch("flash_fused_bwd", q.dtype, out_dtype)
    return dq, dk, dv


def fused_bwd_plain(q, k, v, do, lse, delta, *, causal: bool, out_dtype=None):
    """The fused kernel's algorithm in plain PyTorch, in its order: block s
    of :func:`fused_slices` walks its :func:`owned_k_groups`
    (``FUSED_GROUP_K`` keys each), each over the ``FUSED_BLOCK_Q``-row q
    tiles from the group's diagonal when causal, keeping dk/dv for the
    group and adding every q tile's scaled ds.k, summed over the whole
    group, into its own f32 slice of an [S, BH, T, D] workspace; the slices
    are then summed in order 0..S-1."""
    _check_bwd(q, k, v, do, lse, delta, out_dtype)
    bh, t, d = q.shape
    f32 = torch.float32
    qs, kf, vf, dof, lse2 = _bwd_operands(q, k, v, do, lse)
    scale = 1.0 / math.sqrt(d)
    slices, ng = fused_slices(bh, t), -(-t // FUSED_GROUP_K)
    ws = torch.zeros((slices, bh, t, d), dtype=f32, device=q.device)
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=q.device)
    for s in range(slices):
        for g in owned_k_groups(s, slices, ng):
            k0, k1 = g * FUSED_GROUP_K, min(g * FUSED_GROUP_K + FUSED_GROUP_K, t)
            dk_acc = torch.zeros((bh, k1 - k0, d), dtype=f32, device=q.device)
            dv_acc = torch.zeros((bh, k1 - k0, d), dtype=f32, device=q.device)
            # causal: from the diagonal
            for q0 in range(k0 if causal else 0, t, FUSED_BLOCK_Q):
                q1 = min(q0 + FUSED_BLOCK_Q, t)
                p = _probs(qs, kf, lse2, q0, q1, k0, k1, causal)
                dv_acc = dv_acc + p.to(do.dtype).to(f32).transpose(1, 2) @ dof[:, q0:q1]
                dp = dof[:, q0:q1] @ vf[:, k0:k1].transpose(1, 2)
                # ds enters ds^T.q in q's dtype and ds.k in k's (the same).
                ds = (p * (dp - delta[:, q0:q1])).to(q.dtype).to(f32)
                dk_acc = dk_acc + ds.transpose(1, 2) @ qs[:, q0:q1]
                ws[s, :, q0:q1] += (ds @ kf[:, k0:k1]) * scale
            dk[:, k0:k1] = (dk_acc * (1.0 / LOG2E)).to(dk.dtype)
            dv[:, k0:k1] = dv_acc.to(dv.dtype)
    acc = ws[0]
    for s in range(1, slices):
        acc = acc + ws[s]
    return acc.to(out_dtype or q.dtype), dk, dv


# ----------------------------------------------------------------------------
# Backward dispatch: the JAX ``_bwd``'s, copied (not imported)
# ----------------------------------------------------------------------------

#: Fused-backward override: None = auto (the policy below), True/False force.
_FUSED_BWD_OVERRIDE: bool | None = None

#: The reference's hardware-validation latch, closed as there: without
#: ``DTX_FUSED_BWD=1`` (or the override) the backward stays split.
_FUSED_BWD_VALIDATED = False

#: The reference's cap on the fused kernel's [T, D] f32 dq accumulator
#: (TPU VMEM, 8 MB).  Past it the reference segments q
#: (``fused_bwd_segmented``); the port's dq lives in device memory, so it
#: runs one uncapped fused call wherever the reference takes either.
_FUSED_MAX_ACC_BYTES = 8 * 1024 * 1024


def _fused_bwd_policy(nq: int, nk: int) -> bool:
    """Whether the fused backward is wanted: the override, then
    ``DTX_FUSED_BWD`` ('0' split, '1' the regime without the latch, any
    other value a ValueError, so a typo never records a split run under a
    fused label), then the latch; in the regime nq, nk >= 4."""
    if _FUSED_BWD_OVERRIDE is not None:
        return _FUSED_BWD_OVERRIDE
    env = os.environ.get("DTX_FUSED_BWD", "")
    if env not in ("", "0", "1"):
        raise ValueError(f"DTX_FUSED_BWD={env!r}: must be '0' or '1'")
    if env == "0":
        return False
    if env != "1" and not _FUSED_BWD_VALIDATED:
        return False
    return nq >= 4 and nk >= 4


def _use_fused_bwd(nq: int, nk: int, tq: int, d: int) -> bool:
    """The reference's "one fused call?" answer: wanted and the [tq, d] f32
    accumulator under its cap."""
    return _fused_bwd_policy(nq, nk) and tq * d * 4 <= _FUSED_MAX_ACC_BYTES


def _fused_segment_rows(tq: int, d: int, bq: int, bk: int) -> int:
    """The reference's q-segment length past the cap: the largest that fits
    the cap, divides tq and is a multiple of both blocks; 0 when none does
    (the reference then runs the split kernels)."""
    cap_rows = _FUSED_MAX_ACC_BYTES // (d * 4)
    for m in range(2, tq // bq + 1):
        if tq % m:
            continue
        seg = tq // m
        if seg % bq or seg % bk:
            continue
        if seg <= cap_rows:
            return seg
    return 0


def _takes_fused(t: int, d: int, bq: int, bk: int) -> bool:
    """``_bwd``'s decision: the fused mechanism (one call, or segments in
    the reference) or the split kernels."""
    if not _fused_bwd_policy(t // bq, t // bk):
        return False
    return t * d * 4 <= _FUSED_MAX_ACC_BYTES or bool(_fused_segment_rows(t, d, bq, bk))


def _pick_block(t: int, want: int) -> int:
    """Largest divisor of ``t`` that is <= ``want``, as the reference picks
    its tiles.  (The reference also warns about tiles under 128 rows, slow
    on the TPU; here the block only sets nq/nk, so there is nothing to
    warn about.)"""
    return largest_divisor(t, want)


def _env_block(name: str) -> int:
    """``DTX_FLASH_BQ``/``DTX_FLASH_BK`` (default 1024), validated as the
    reference validates them: an integer >= 128, or a ValueError."""
    raw = os.environ.get(name, "1024")
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: flash block overrides must be integers") from None
    if val < 128:
        raise ValueError(f"{name}={val}: flash blocks must be >= 128")
    return val


class FlashAttention(torch.autograd.Function):
    """Flash attention over folded q, k, v [BH, T, D] with the FA2 backward:
    the port of the JAX ``_flash_bhd`` custom VJP.  The forward saves
    (q, k, v, o, lse); the backward computes delta, then dq, dk and dv with
    :func:`fused_bwd_call` where :func:`_takes_fused` says so for the
    dispatch blocks (bq, bk), else with :func:`dq_call` and
    :func:`dkv_call`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = fwd_call(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.blocks = causal, (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = compute_delta(do, o)
        t, d = q.shape[1], q.shape[2]
        if _takes_fused(t, d, *ctx.blocks):
            dq, dk, dv = fused_bwd_call(q, k, v, do, lse, delta, causal=ctx.causal)
        else:
            dq = dq_call(q, k, v, do, lse, delta, causal=ctx.causal)
            dk, dv = dkv_call(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_viable(t: int, device, head_dim: int) -> bool:
    """The ``attention="auto"`` gate: the kernel when the tensors live on a
    CUDA device and the kernel takes the shape (any T >= 1, a head dim in
    ``HEAD_DIMS``).  False on the CPU, so auto means ``mha`` there, as the
    JAX gate means XLA attention off the TPU."""
    return torch.device(device).type == "cuda" and t >= 1 and head_dim in HEAD_DIMS


def flash_attention(q, k, v, *, causal: bool = False,
                    block_q: int | None = None, block_k: int | None = None):
    """Drop-in for ``ops.attention.mha``: q/k/v [B, H, T, D] -> [B, H, T, D],
    differentiable (:class:`FlashAttention`).  ``block_q``/``block_k`` (else
    ``DTX_FLASH_BQ``/``DTX_FLASH_BK``, read at every call) are the
    reference's blocks: here they choose the backward, not the tiles."""
    if block_q is None:
        block_q = _env_block("DTX_FLASH_BQ")
    if block_k is None:
        block_k = _env_block("DTX_FLASH_BK")
    B, H, T, D = q.shape
    bq, bk = _pick_block(T, block_q), _pick_block(T, block_k)
    fold = lambda x: x.reshape(B * H, T, D).contiguous()
    o = FlashAttention.apply(fold(q), fold(k), fold(v), bool(causal), bq, bk)
    return o.reshape(B, H, T, D)
