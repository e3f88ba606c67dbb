"""The examples' optimizers, with optax's formulas.

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

:class:`SGD` is ``optax.sgd(schedule, momentum)`` (ResNet-50's optimizer):
``optax.trace`` (buf = g + momentum * buf, from zeros; no dampening, no
Nesterov) scaled by the learning rate, which is ``torch.optim.SGD`` with
the rate of update k set from the schedule before the update.  k is the
train step's count of updates so far, not a counter of the optimizer's own,
so a resumed run reads the right rate.  With ``clip_norm`` it is
``optax.chain(clip_by_global_norm(clip_norm), sgd(...))`` (the PTB
LSTM's optimizer), the clip the one :class:`ClippedAdamW` takes.
:func:`piecewise_constant_schedule` and :func:`linear_schedule` are
optax's, in float32 as optax computes them.

Both run fused (one kernel for every leaf) and share ``init(params) ->
opt_state`` and ``update(opt_state, params, step)``.
"""

from __future__ import annotations

import numpy as np
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
    def update(self, opt_state: torch.optim.AdamW, params, step: int | None = None) -> None:
        """``step`` is unused: AdamW's own count, saved with its state,
        drives the bias correction."""
        ps = _grads_or_zeros(params)
        clip_by_global_norm_([p.grad for p in ps], self.clip_norm)
        opt_state.step()


def _grads_or_zeros(params) -> list:
    """The leaves, each with a ``.grad`` (zeros where autograd left none:
    optax moves every leaf, a zero gradient too)."""
    ps = leaves(params)
    for p in ps:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return ps


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None):
    """optax's ``piecewise_constant_schedule``: ``schedule(count)`` is
    ``init_value`` times every scale whose boundary ``count`` has reached
    (``count >= boundary``; updates count from 0), in float32."""
    items = sorted((int(b), np.float32(s)) for b, s in (boundaries_and_scales or {}).items())

    def schedule(count: int) -> float:
        if not items:  # optax hands the value back untouched
            return init_value
        v = np.float32(init_value)
        for boundary, scale in items:
            if count >= boundary:
                v = np.float32(scale * v)
        return float(v)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's ``linear_schedule``: ``schedule(count)`` runs from
    ``init_value`` at count 0 to ``end_value`` at ``transition_steps`` and
    holds it after, in float32 operation for operation as optax evaluates
    it: ``(init - end) * (1 - clip(count) / steps) + end``."""
    if transition_steps <= 0:  # optax: a constant schedule
        return lambda _count: init_value
    span = np.float32(init_value - end_value)
    end = np.float32(end_value)
    steps = np.float32(transition_steps)

    def schedule(count: int) -> float:
        c = np.float32(min(max(int(count), 0), transition_steps))
        frac = np.float32(1.0) - np.float32(c / steps)
        return float(np.float32(span * frac) + end)

    return schedule


class SGD:
    """``optax.sgd(learning_rate, momentum)``: ``learning_rate`` a float or
    a ``schedule(count)``; ``clip_norm`` chains a global-norm clip before
    it."""

    def __init__(self, learning_rate, momentum: float = 0.0, clip_norm: float | None = None):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _count: learning_rate)
        self.momentum = momentum
        self.clip_norm = clip_norm

    def init(self, params) -> torch.optim.SGD:
        return torch.optim.SGD(
            leaves(params), lr=self.schedule(0), momentum=self.momentum,
            dampening=0.0, nesterov=False, fused=True,
        )

    @torch.no_grad()
    def update(self, opt_state: torch.optim.SGD, params, step: int) -> None:
        """Update number ``step`` (0 for the first) at ``schedule(step)``."""
        ps = _grads_or_zeros(params)
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in ps], self.clip_norm)
        lr = self.schedule(int(step))
        for group in opt_state.param_groups:
            group["lr"] = lr
        opt_state.step()
