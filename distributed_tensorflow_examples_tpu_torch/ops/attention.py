"""Reference multi-head attention (the ``attention="xla"`` path).

The port of ``distributed_tensorflow_examples_tpu/ops/attention.py::mha``;
the ring and Ulysses layouts come with the model-parallel slice.
"""

from __future__ import annotations

import math

import torch

#: Finite "minus infinity" for masked logits: keeps an online-softmax
#: recurrence NaN-free when a block is fully masked (exp(-1e30 - m) == 0 for
#: any finite m), where a true -inf would produce inf-inf = NaN.
NEG_INF = -1e30


def mha(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """q: [B, H, Tq, D], k/v: [B, H, Tk, D] -> [B, H, Tq, D].

    ``q_offset``/``k_offset`` are the global positions of the first row of
    q/k (causal masking across sequence shards)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
