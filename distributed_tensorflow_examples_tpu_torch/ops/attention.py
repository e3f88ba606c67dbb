"""Attention: reference multi-head attention and both sequence-parallel
layouts, the ring and Ulysses all-to-all.

The port of ``distributed_tensorflow_examples_tpu/ops/attention.py``.
Sequences shard over the mesh ``seq`` axis (``parallel/mesh.py``); each
rank holds its slice ``[s T/S, (s + 1) T/S)`` of q, k and v as local
[B, H, T/S, D] tensors (the JAX ``shard_map`` bodies' shapes; no
``shard_map`` here: the port's ranks run the body directly, and the axis
is the group the calling thread has installed, ``collectives.use_group``).
Attention then runs either

- as a RING: queries stay local while k/v blocks rotate around the axis
  (``collectives.ring_permute``, one hop a step), accumulated with the
  online softmax (:func:`ring_attention`, plain PyTorch) or with the
  hand-written flash kernels per hop (:func:`ring_flash_attention`), so
  no rank ever holds the full [T, T] scores; any head count; or
- as ULYSSES: one ``collectives.all_to_all`` per tensor trades the
  sequence sharding for head sharding, attention runs locally over the
  full sequence (the flash kernels on the card), and one all-to-all brings
  the output back (:func:`ulysses_attention`); local heads must divide by
  the seq shards.

Either layout over a seq-sharded mesh equals full-sequence attention on
one rank, values and gradients (tested against the JAX package).
"""

from __future__ import annotations

import math

import torch

from ..parallel import collectives
from . import flash_attention as fa

#: Finite "minus infinity" for masked logits: keeps an online-softmax
#: recurrence NaN-free when a block is fully masked (exp(-1e30 - m) == 0 for
#: any finite m), where a true -inf would produce inf-inf = NaN.
NEG_INF = -1e30

IMPLS = ("auto", "xla", "flash", "ulysses")


def mha(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """q: [B, H, Tq, D], k/v: [B, H, Tk, D] -> [B, H, Tq, D].

    ``q_offset``/``k_offset`` are the global positions of the first row of
    q/k (causal masking across sequence shards)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        s = s.masked_fill(_future(q, k, q_offset, k_offset), NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _future(q, k, q_offset: int, k_offset: int) -> torch.Tensor:
    """[Tq, Tk] True where the key lies after the query (global positions)."""
    qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
    return kpos > qpos


def _block(q, k, v, carry, *, scale, causal, q_offset, k_offset):
    """One online-softmax accumulation step (the flash-attention
    recurrence) against a single k/v block: JAX ``_block``.  carry =
    (o, m, l): o [B,H,Tq,D] unnormalised output, m [B,H,Tq,1] running max,
    l [B,H,Tq,1] running sum of exp."""
    o, m, l = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(_future(q, k, q_offset, k_offset), NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # Valid (unmasked) entries only: a fully-masked block contributes 0.
    p = torch.exp(s - m_new) * (s > NEG_INF / 2)
    alpha = torch.exp(m - m_new)
    o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    return o, m_new, l


def ring_attention(q, k, v, *, axis_name: str = "seq", causal: bool = False):
    """Sequence-parallel attention, JAX ``ring_attention``: queries stay
    local, k/v rotate ``axis_size`` hops around the ring (receive from the
    next rank, ``shift=-1``), every hop's block in float32 plain PyTorch;
    differentiable through autograd (each rotation's backward sends the
    gradient back a hop).  q/k/v: this rank's [B, H, T_local, D]; the
    global sequence is the concatenation over the axis in index order."""
    n = collectives.axis_size(axis_name)
    my = collectives.axis_index(axis_name)
    t_local = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, dtype = q.to(torch.float32), q.dtype
    o = q32.new_zeros(q.shape[:3] + (v.shape[-1],))
    m = q32.new_full(q.shape[:3] + (1,), NEG_INF)
    l = q32.new_zeros(q.shape[:3] + (1,))
    kv = torch.stack([k, v])
    for i in range(n):
        src = (my + i) % n
        o, m, l = _block(q32, kv[0].to(torch.float32), kv[1].to(torch.float32), (o, m, l),
                         scale=scale, causal=causal, q_offset=my * t_local,
                         k_offset=src * t_local)
        if i < n - 1:  # JAX's nth rotation brings k/v home and is dead code
            kv = collectives.ring_permute(kv, axis_name, shift=-1)
    return (o / torch.clamp(l, min=1e-30)).to(dtype)


# ----------------------------------------------------------------------------
# Ring attention with the hand-written flash kernels per hop (B9)
# ----------------------------------------------------------------------------
#
# The same ring schedule with the flash kernels as each hop's compute,
# hops merged by their log-sum-exp.  Hop 0 is always the diagonal block
# (the causal kernel); later hops are never diagonal (the non-causal
# kernel), and under causal masking a later block is either wholly
# visible (src < my) or wholly masked, in which case no kernel runs at
# all.  Every partial leaves the kernel in float32 (``out_dtype``); on the
# card every hop runs on the tensor cores (each kernel's f32-out instance,
# checked by ``tools/flash_rounding.py``); on a CPU tensor the plain
# versions run.  The backward runs the fused kernel or
# the split dq/dkv pair per hop, with the dk/dv accumulators rotating in
# lockstep with their k/v blocks, so every gradient arrives home after one
# final rotation.


def _merge(o1, lse1, o2, lse2):
    """Merge two normalised attention partials by their lse (f32)."""
    lse = torch.logaddexp(lse1, lse2)
    return o1 * torch.exp(lse1 - lse) + o2 * torch.exp(lse2 - lse), lse


def _fold_heads(x):
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D).contiguous()


def _hop_bwd(q, kh, vh, do, lse, delta, *, causal: bool, blocks):
    """One hop's (dq, dk, dv) float32 partials: the fused kernel where the
    JAX ``_use_fused_bwd`` takes it for this shard's block counts, the
    split pair otherwise."""
    t, d = q.shape[1], q.shape[2]
    bq, bk = blocks
    if fa._use_fused_bwd(t // bq, kh.shape[1] // bk, t, d):
        return fa.fused_bwd_call(q, kh, vh, do, lse, delta, causal=causal,
                                 out_dtype=torch.float32)
    dq = fa.dq_call(q, kh, vh, do, lse, delta, causal=causal, out_dtype=torch.float32)
    dk, dv = fa.dkv_call(q, kh, vh, do, lse, delta, causal=causal, out_dtype=torch.float32)
    return dq, dk, dv


class RingFlashAttention(torch.autograd.Function):
    """JAX ``_ring_flash`` (its ``_ring_flash_fwd_impl`` forward and
    ``_ring_flash_bwd_rule`` backward) over folded [B*H, T_local, D]
    q, k, v and the seq group ``g`` (None: one rank).  The group is held,
    not read from the thread: the backward runs on autograd's thread."""

    @staticmethod
    def forward(ctx, q, k, v, g, causal, blocks):
        n, my = (1, 0) if g is None else (g.size, g.rank)
        o, lse = fa.fwd_call(q, k, v, causal=causal, out_dtype=torch.float32)
        kv = torch.stack([k, v])
        for i in range(1, n):
            kv = collectives.permute_over(g, kv, shift=-1)
            src = (my + i) % n
            if not causal or src < my:
                o_h, lse_h = fa.fwd_call(q, kv[0], kv[1], causal=False,
                                         out_dtype=torch.float32)
                o, lse = _merge(o, lse, o_h, lse_h)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.g, ctx.causal, ctx.blocks = g, causal, blocks
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        g, causal, blocks = ctx.g, ctx.causal, ctx.blocks
        n, my = (1, 0) if g is None else (g.size, g.rank)
        do = do.contiguous()
        delta = fa.compute_delta(do, o)
        dq, dk, dv = _hop_bwd(q, k, v, do, lse, delta, causal=causal, blocks=blocks)
        kv, dkv = torch.stack([k, v]), torch.stack([dk, dv])
        for i in range(1, n):
            kv = collectives.permute_over(g, kv, shift=-1)
            dkv = collectives.permute_over(g, dkv, shift=-1)
            src = (my + i) % n
            # Skipped, not masked by a multiply-by-zero: on a masked hop the
            # non-causal kernel's exp(s - lse) (lse covers only the visible
            # keys) can overflow f32, and 0 * inf would poison the sums.
            if not causal or src < my:
                dq_h, dk_h, dv_h = _hop_bwd(q, kv[0], kv[1], do, lse, delta, causal=False,
                                            blocks=blocks)
                dq = dq + dq_h
                dkv = dkv + torch.stack([dk_h, dv_h])
        if n > 1:  # one final rotation brings the accumulators home
            dkv = collectives.permute_over(g, dkv, shift=-1)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None, None


def ring_flash_attention(q, k, v, *, axis_name: str = "seq", causal: bool = False,
                         block_q: int = 1024, block_k: int = 1024):
    """Ring attention whose per-hop compute is the flash kernels, forward
    and backward (JAX ``ring_flash_attention``; shapes per rank
    [B, H, T_local, D]).  ``block_q``/``block_k`` are the JAX blocks, cut
    to divisors of T_local: they choose each hop's backward (fused or
    split), not the kernels' tiles.  On a CUDA tensor every hop launches
    a hand kernel (or raises); on a CPU tensor the plain versions run."""
    B, H, T, D = q.shape
    collectives.axis_size(axis_name)  # refuses an axis the port lacks
    g = collectives.group(axis_name)
    blocks = (fa._pick_block(T, block_q), fa._pick_block(T, block_k))
    o = RingFlashAttention.apply(_fold_heads(q), _fold_heads(k), _fold_heads(v), g,
                                 bool(causal), blocks)
    return o.reshape(B, H, T, D)


def sequence_parallel_attention(q, k, v, *, causal: bool = False, impl: str = "auto",
                                seq_axis: str = "seq", head_axis: str = "model"):
    """JAX ``sequence_parallel_attention`` for this rank's [B, H_local,
    T_local, D] blocks (heads sharded over ``head_axis`` compose: each
    model rank runs its own heads).  ``impl``: "xla" (the plain ring),
    "flash" (the kernel ring), "ulysses" (:func:`ulysses_attention`), or
    "auto": the kernel ring where ``flash_viable`` holds for the local T
    (a CUDA tensor and a head dim the kernels take), the plain ring
    otherwise, as JAX takes the flash ring on the TPU and XLA elsewhere.
    Plain attention without a seq group."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|xla|flash|ulysses, got {impl!r}")
    if collectives.axis_size(seq_axis) == 1:
        return mha(q, k, v, causal=causal)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, causal=causal, seq_axis=seq_axis,
                                 head_axis=head_axis)
    if impl == "auto":
        impl = "flash" if fa.flash_viable(q.shape[2], q.device, q.shape[-1]) else "xla"
    if impl == "flash":
        return ring_flash_attention(q, k, v, axis_name=seq_axis, causal=causal)
    return ring_attention(q, k, v, axis_name=seq_axis, causal=causal)


def ulysses_attention(q, k, v, *, causal: bool = False, seq_axis: str = "seq",
                      head_axis: str = "model"):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses), JAX
    ``ulysses_attention``: one all-to-all per tensor re-shards
    [B, H_loc, T/s, D] -> [B, H_loc/s, T, D] (sequence gathered, heads
    scattered), attention runs locally over the full sequence
    (:func:`_ulysses_local`), and one all-to-all brings the output back to
    the sequence layout.  Needs the local heads divisible by the seq
    shards."""
    s = collectives.axis_size(seq_axis)
    if s == 1:
        return mha(q, k, v, causal=causal)
    h_shards = collectives.axis_size(head_axis)
    h_local = q.shape[1]
    if h_local % s:
        raise ValueError(
            f"ulysses: {h_local * h_shards} heads / {h_shards} '{head_axis}' shards leaves "
            f"{h_local} local heads, not divisible by {seq_axis}={s}; "
            "use the ring (impl='flash'/'xla') for this shape"
        )
    local = _ulysses_local(q.device, q.shape[-1])
    q, k, v = (collectives.all_to_all(t, 1, 2, seq_axis) for t in (q, k, v))
    return collectives.all_to_all(local(q, k, v, causal=causal), 2, 1, seq_axis)


def _ulysses_local(device, head_dim: int):
    """Ulysses' attention over the full sequence: the flash kernels on a
    CUDA device, plain ``mha`` on the CPU.  A head dim the kernels do not
    take raises on a CUDA device, before any all-to-all: the card never
    runs the plain version."""
    if torch.device(device).type != "cuda":
        return mha
    if head_dim not in fa.HEAD_DIMS:
        raise ValueError(
            f"ulysses: the flash kernels take head dims {fa.HEAD_DIMS}, got {head_dim}")
    return fa.flash_attention
