"""Small shared helpers for the op modules: the port's copy of
``distributed_tensorflow_examples_tpu/ops/common.py``."""

from __future__ import annotations


def largest_divisor(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want`` (>= 1)."""
    b = max(1, min(n, want))
    while n % b:
        b -= 1
    return b
