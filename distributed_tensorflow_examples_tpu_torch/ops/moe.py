"""Mixture-of-experts FFN with expert parallelism over the ``expert`` axis:
the port of ``distributed_tensorflow_examples_tpu/ops/moe.py``.

The GShard layer, function for function: top-k routing with gates
renormalised over the k chosen experts, a capacity of
``C = max(4, ceil(k g / E * capacity_factor))`` slots per expert and
routing group of ``g`` tokens (overflow tokens are dropped: they add
zero), a per-expert tanh-GELU MLP whose weights stack to [E, ...], and
the Switch load-balance loss ``E * sum_e frac_e * mean_prob_e``.

- Routing runs in float32 on ``tok.float()``, as in JAX: router logits,
  softmax, and the top k by a stable descending sort, which is
  ``jax.lax.top_k``'s order (the larger probability first, the lower
  expert on a tie).  A choice's place in its expert's buffer is the
  exclusive running count over the group laid out [k, g], so every
  token's first choice ranks before any second choice; places at or
  past C are dropped.
- Dispatch and combine: JAX builds one-hot [G, g, E, C] tensors and
  contracts them (a TPU formulation).  The port puts each kept (token,
  choice) in its own slot of the [E, G, C, D] buffer by index and sums a
  token's gated rows back out of the experts' output: the same function
  without the one-hot arithmetic.  Both halves are index copies whose
  backward is the other half (:class:`_Place`, :class:`_Take`), so no
  atomics run and the results repeat bit for bit.
- The aux loss's ``frac`` (first choices) and ``mean_prob`` are means
  over every token of the global batch.

Under a ``mesh`` the tokens arrive as this rank's block of the global
[B, T, D] (rows over ``("data", "expert")``, data major, the sequence over
``seq``: the transformer's ``batch_spec``), and the group size is JAX's
(``_group`` over the global token count, ``data x expert`` shards, with
its warnings).  Where the rank's tokens are whole routing groups the
groups route here, the buffers cross the expert group with
``collectives.all_to_all`` (the experts' dim split over the expert ranks,
the groups gathered; then back: JAX's ``_constrain_expert`` boundary,
which GSPMD lowers to the same all-to-all), and the aux loss's sums add
up over the batch group (``collectives.psum``, whose backward sums the
cotangents: the step then averages them).  Where a group straddles the
shards (a sequence slice shorter than a group, or fewer tokens than
shards) the tokens are gathered over the batch group and every rank
routes the whole batch with the experts gathered over the expert group,
then keeps its block: JAX's numbers at any shape.  Expert weights that
are ``model`` blocks (``SHARDING_RULES``) run Megatron-style, their
partial products summed over ``model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers
from ..parallel import collectives
from ..parallel.partitioner import PartitionSpec as P
from ..utils import threefry
from .common import largest_divisor

#: When a list (:func:`record_drops`), each call of :func:`apply` appends
#: the share of its (token, choice) pairs that overflowed (a 0-dim tensor).
_DROPS: list | None = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    #: Routing-group size (GShard's G): tokens route within groups of this
    #: many, so the buffers stay linear in the total token count.
    group_size: int = 1024


def init(key, dim: int, hidden: int, moe: MoEConfig, *, device="cpu") -> dict:
    """JAX ``init``: ``split(key, 3)``, each expert's glorot-uniform w1 and
    w2 (fan in and out of one expert's matrix) from ``split(ks[0], E)``
    and ``split(ks[1], E)``, one draw per key as JAX's ``vmap`` makes them,
    the router from ``ks[2]``; zero biases."""
    ks = threefry.split(key, 3)
    E = moe.n_experts
    w1 = torch.stack([layers.glorot_uniform(k, (dim, hidden), device=device)
                      for k in threefry.split(ks[0], E)])
    w2 = torch.stack([layers.glorot_uniform(k, (hidden, dim), device=device)
                      for k in threefry.split(ks[1], E)])
    return {
        "router": {"kernel": layers.glorot_uniform(ks[2], (dim, E), device=device)},
        "w1": w1,
        "b1": np.zeros((E, hidden), np.float32),
        "w2": w2,
        "b2": np.zeros((E, dim), np.float32),
    }


def capacity(group_tokens: int, moe: MoEConfig) -> int:
    c = math.ceil(moe.top_k * group_tokens / moe.n_experts * moe.capacity_factor)
    return max(4, c)


def _group(n: int, want: int, shards: int = 1) -> int:
    """Largest divisor of ``n`` that is <= ``want`` whose group count is a
    multiple of ``shards`` (data x expert), so groups stay inside a
    shard; else, with JAX's warning, the largest divisor of ``n``."""
    g = min(want, n)
    while g > 1 and not (n % g == 0 and (n // g) % shards == 0):
        g -= 1
    if g > 1 or n % shards == 0:
        return g
    warnings.warn(
        f"moe: no routing-group size <= {want} splits {n} tokens into a "
        f"multiple of {shards} shards; groups will straddle shard "
        "boundaries and the dispatch may lower to all-gather instead of "
        "all_to_all (pad batch*seq to a multiple of data*expert shards)."
    )
    return largest_divisor(n, want)


@contextlib.contextmanager
def record_drops():
    """Collect, for every :func:`apply` in the block, the share of its
    (token, choice) pairs past capacity: yields the list of 0-dim
    tensors (on the tokens' device, read after the block)."""
    global _DROPS
    old, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = old


def route(tok32, router, moe: MoEConfig, C: int):
    """Routing of ``tok32`` [G, g, D] (float32): (probs [G, g, E], expert
    idx [G, g, k], gates [G, g, k] (renormalised, 0 where dropped), pos
    [G, g, k] (the place in the expert's buffer), keep [G, g, k])."""
    G, g, _ = tok32.shape
    E, k = moe.n_experts, moe.top_k
    probs = torch.softmax(torch.matmul(tok32, router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    gates = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, E)  # [G, g, k, E]
    flat = onehot.transpose(1, 2).reshape(G, k * g, E)  # first choices first
    before = (flat.cumsum(dim=1) - flat).reshape(G, k, g, E).transpose(1, 2)
    pos = (before * onehot).sum(dim=-1)
    keep = pos < C
    return probs, idx, gates * keep, pos, keep


class _Place(torch.autograd.Function):
    """``rows`` [M, D] copied to rows ``index`` of an [n, D] zero buffer
    (distinct indices but for the last, pad row); the backward takes the
    cotangent's rows back."""

    @staticmethod
    def forward(ctx, rows, index, n):
        ctx.save_for_backward(index)
        return rows.new_zeros(n, rows.shape[1]).index_copy_(0, index, rows)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return grad.index_select(0, index), None, None


class _Take(torch.autograd.Function):
    """Rows ``index`` of ``buf`` [n, D] (distinct but for the last, pad
    row); the backward places the cotangent's rows back."""

    @staticmethod
    def forward(ctx, buf, index):
        ctx.save_for_backward(index)
        ctx.n = buf.shape[0]
        return buf.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return grad.new_zeros(ctx.n, grad.shape[1]).index_copy_(0, index, grad), None


def _experts(p, xin, cd, hidden):
    """Each expert's MLP over its buffer ``xin`` [E', G', C, D] in the
    compute dtype ``cd``; w1/b1 and w2 as this rank's ``model`` blocks
    where w1 holds fewer than ``hidden`` columns."""
    e, gc = xin.shape[0], xin.shape[1] * xin.shape[2]
    tp = hidden is not None and p["w1"].shape[-1] != hidden
    inp = collectives.copy_to_model(xin) if tp else xin
    h = torch.matmul(inp.reshape(e, gc, xin.shape[3]), p["w1"].to(cd))
    h = F.gelu(h + p["b1"].to(cd)[:, None, :], approximate="tanh")
    out = torch.matmul(h, p["w2"].to(cd))
    if tp:
        out = collectives.reduce_from_model(out)
    out = out + p["b2"].to(cd)[:, None, :]
    return out.view(xin.shape)


def _core(p, tok, moe: MoEConfig, cd, hidden, *, n_total: int, exchange: bool, summed: bool):
    """The layer over ``tok`` [G, g, D] (whole groups): (y [G, g, D] in
    ``cd``, aux).  ``exchange``: the buffers cross the expert group (this
    rank holds its experts' block); ``summed``: the aux loss's sums add up
    over the batch group; ``n_total`` tokens in all."""
    G, g, D = tok.shape
    E, k = moe.n_experts, moe.top_k
    C = capacity(g, moe)
    probs, idx, gates, pos, keep = route(tok.float(), p["router"]["kernel"], moe, C)
    if _DROPS is not None:
        _DROPS.append(1.0 - keep.float().mean().detach())
    pad = E * G * C
    slot = (idx * G + torch.arange(G, device=tok.device)[:, None, None]) * C + pos
    slot = torch.where(keep, slot, torch.full_like(slot, pad)).reshape(-1)
    rows = tok.to(cd)[:, :, None, :].expand(G, g, k, D).reshape(-1, D)
    expert_in = _Place.apply(rows, slot, pad + 1)[:pad].view(E, G, C, D)
    if exchange:
        expert_in = collectives.all_to_all(expert_in, 0, 1, "expert", tag="expert_a2a")
    out = _experts(p, expert_in, cd, hidden)
    if exchange:
        out = collectives.all_to_all(out, 1, 0, "expert", tag="expert_a2a")
    out = torch.cat([out.reshape(pad, D), out.new_zeros(1, D)])
    chosen = _Take.apply(out, slot).view(G, g, k, D)
    y = (chosen.float() * gates.to(cd).float()[..., None]).sum(dim=2).to(cd)

    frac = F.one_hot(idx[..., 0], E).sum(dim=(0, 1)).to(torch.float32)
    prob = probs.sum(dim=(0, 1))
    if summed:  # one sum of both over the batch group (frac takes no gradient)
        both = collectives.psum(torch.cat([frac, prob]), "batch", tag="expert_aux")
        frac, prob = both[:E].detach(), both[E:]
    aux = E * torch.sum((frac / n_total) * (prob / n_total))
    return y, aux


def _whole(p, moe: MoEConfig, expert_sharded: bool) -> dict:
    """``p`` with every expert leaf whole: this rank's expert blocks
    gathered over the expert group (differentiable)."""
    if not expert_sharded:
        return p
    out = dict(p)
    for name in ("w1", "b1", "w2", "b2"):
        out[name] = collectives.gather_blocks(p[name], 0, "expert", tag="expert_gather")
    return out


def apply(p, x, moe: MoEConfig, *, dtype=None, mesh=None, hidden=None, x_sharded=True):
    """x: [B, T, D] -> (y [B, T, D] in x's dtype, aux float32 scalar).

    Routing in float32, the experts in ``dtype`` (default float32).
    ``mesh``: ``x`` is this rank's block of the global batch (rows over
    data x expert, columns over seq) unless ``x_sharded`` is False (the
    whole input on every rank); the experts are this rank's block when
    ``w1`` holds fewer than ``n_experts`` (module docstring).
    ``hidden``: the experts' whole hidden width, which tells a ``model``
    block of w1 from the whole."""
    B, T, D = x.shape
    E = moe.n_experts
    cd = torch.float32 if dtype is None else dtype
    sizes = {} if mesh is None else dict(mesh.shape)
    shards = sizes.get("data", 1) * sizes.get("expert", 1)
    seq = sizes.get("seq", 1)
    spread = x_sharded and shards * seq > 1
    if spread and collectives.axis_size("batch") != shards * seq:
        raise ValueError(
            f"moe.apply under mesh {sizes} needs its {shards * seq} batch ranks installed "
            "(run under mesh.axes() or a train step)")
    nb, nt = (B * shards, T * seq) if spread else (B, T)
    N = nb * nt
    g = _group(N, moe.group_size, shards)
    G = N // g
    if mesh is not None and shards > 1 and G % shards:
        warnings.warn(
            f"moe: group count {G} is not a multiple of the {shards} token "
            "shards; skipping the ('data','expert') token pin — the "
            "dispatch may not lower to all_to_all at this shape."
        )
    data = sizes.get("data", 1)
    if sizes.get("expert", 1) > 1 and data > 1 and G % data:
        warnings.warn(
            f"moe: group dim {G} does not divide the data axis ({data}); dropping the "
            "group entry from the expert buffers' sharding — capacity buffers replicate "
            "over 'data' at this shape."
        )
    expert_sharded = p["w1"].shape[0] != E
    if spread and ((B * T) % g == 0 if seq == 1 else T % g == 0):
        y, aux = _core(p, x.reshape(-1, g, D), moe, cd, hidden, n_total=N,
                       exchange=expert_sharded, summed=True)
        return y.reshape(B, T, D).to(x.dtype), aux
    tokens = x
    if spread:  # a group straddles the shards: route the whole batch here
        tokens = collectives.gather_blocks(x, 1, "seq", tag="expert_gather")
        tokens = collectives.gather_blocks(tokens, 0, "expert", tag="expert_gather")
        tokens = collectives.gather_blocks(tokens, 0, "data", tag="expert_gather")
    y, aux = _core(_whole(p, moe, expert_sharded), tokens.reshape(G, g, D), moe, cd, hidden,
                   n_total=N, exchange=False, summed=False)
    y = y.reshape(nb, nt, D)
    if spread:
        r, s = collectives.axis_index(("data", "expert")), collectives.axis_index("seq")
        y = y[r * B:(r + 1) * B, s * T:(s + 1) * T]
    return y.to(x.dtype), aux


#: Rule fragment for a block holding one MoE layer under the prefix ``moe/``
#: (JAX ``SHARDING_RULES``).
SHARDING_RULES: tuple = (
    (r".*moe/router/kernel", P(None, None)),
    (r".*moe/w1", P("expert", None, "model")),
    (r".*moe/b1", P("expert", "model")),
    (r".*moe/w2", P("expert", "model", None)),
    (r".*moe/b2", P("expert", None)),
)
