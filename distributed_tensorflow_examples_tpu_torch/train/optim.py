"""The transformer example's optimizer, with optax's formulas.

The JAX package builds ``optax.chain(optax.clip_by_global_norm(clip_norm),
optax.adamw(learning_rate))``.  :class:`ClippedAdamW` is the same update
as a hand-written clip followed by ``torch.optim.AdamW``:

- the clip is optax's ``where(norm < max, g, g / norm * max)``, with no
  ``+1e-6`` in the denominator (``torch.nn.utils.clip_grad_norm_`` adds
  one), chosen on the device with no host sync;
- AdamW takes optax's settings: b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias correction, and weight decay 1e-4 on every leaf
  (torch defaults to 1e-2).  torch decays ``p *= 1 - lr * wd`` before
  the Adam step; optax adds ``wd * p`` to the Adam update; both read the
  old ``p``, so the two are the same formula in another order.  It runs
  fused (one kernel for every leaf).

The optimizer state is the ``torch.optim.AdamW`` itself: it holds the
parameter tensors, which the train step updates in place.
"""

from __future__ import annotations

import torch

from .state import leaves

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm (f32) is at or above ``max_norm``; below it they are unchanged."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
    )
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


class ClippedAdamW:
    """``init(params) -> opt_state``; ``update(opt_state, params)`` clips the
    leaves' ``.grad`` and steps the parameters in place."""

    def __init__(self, learning_rate: float, clip_norm: float):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            leaves(params), lr=self.learning_rate, betas=(B1, B2), eps=EPS,
            weight_decay=WEIGHT_DECAY, fused=True,
        )

    @torch.no_grad()
    def update(self, opt_state: torch.optim.AdamW, params) -> None:
        ps = leaves(params)
        for p in ps:
            if p.grad is None:  # optax moves every leaf, a zero gradient too
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in ps], self.clip_norm)
        opt_state.step()
