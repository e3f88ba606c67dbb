"""The JAX package's random numbers, drawn by the port.

A copy of ``jax.random``'s default generator (threefry-2x32) in its
partitionable mode (``jax_threefry_partitionable``, the default since JAX
0.5), so a seed gives the port the same initial weights and the same
sampled tokens as the JAX package:

- a key is two uint32 words; :func:`key` builds it from an integer seed
  as ``jax.random.key`` does in JAX's default 32-bit mode;
- ``split(key, n)[i]`` is the word pair ``threefry2x32(key, (0, i))``;
- ``random_bits(key, shape)`` is ``a ^ b`` for ``(a, b) =
  threefry2x32(key, (hi, lo))`` over the 64-bit row-major index of each
  element;
- :func:`uniform` keeps 23 of those bits as the mantissa of a float in
  [1, 2), subtracts 1 and scales, as ``jax.random.uniform`` does in
  float32; :func:`normal` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0),
  1))`` with XLA's float32 ``erf_inv`` (Giles' polynomial);
  :func:`truncated_normal` is the same ``erf_inv`` over ``uniform``
  between the bounds' ``erf``; :func:`bernoulli` is ``uniform < p``;
  :func:`gumbel` and :func:`categorical` are ``jax.random``'s
  (Gumbel-max over ``uniform(tiny, 1)``);
- :func:`fold_in` is the word pair ``threefry2x32(key, (0, data))``.

Keys, bits, uniform and Bernoulli draws are bitwise JAX's (on its CPU
backend, which rounds ``uniform``'s multiply-add once, as a fused
multiply-add; so does :func:`uniform`).  ``normal`` evaluates the same
polynomial, its multiply-adds rounded once as well, with torch's
``log1p`` and ``sqrt``, so a draw may differ from JAX's by a few float32
ulps (``tests/test_torch_threefry.py`` states the bound), and so may
``truncated_normal``; ``gumbel`` likewise through ``torch.log``.

The arithmetic runs on torch tensors on the device the caller names, in
int64 with every 32-bit word kept in [0, 2^32): the additions carry into
the high bits, and the mask after each round's xor drops them.  A large
draw runs in chunks, so its temporaries stay bounded.  Keys
(:func:`split`, :func:`fold_in`) are derived in Python integers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: Elements per chunk of a draw: int64 temporaries of 32 MB on the card,
#: and a chunk that stays in the caches of a CPU core.
_CHUNK = {"cuda": 1 << 22, "cpu": 1 << 15}


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two words.  JAX's default 32-bit mode
    takes the seed as an int32, so the high word is 0 and the low word is
    the seed mod 2^32 (with x64 enabled JAX would put ``seed >> 32`` in
    the high word; the JAX package does not enable it)."""
    return (0, int(seed) & _M32)


def _as_key(k) -> tuple[int, int]:
    if isinstance(k, torch.Tensor):
        k = k.tolist()
    k0, k1 = (int(w) for w in np.asarray(k, dtype=np.uint64).reshape(2))
    return k0 & _M32, k1 & _M32


def threefry2x32(k, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    (int64 tensors in [0, 2^32)) under key ``k``; returns two new int64
    tensors in [0, 2^32)."""
    k0, k1 = _as_key(k)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            # x0 carries above bit 32 until the next mask; x1 is masked
            # after every round, so its rotation sees only its 32 bits.
            x0 += x1
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1 >>= 32 - r
            x1 |= tmp
            x1 ^= x0
            x1 &= _M32
        x0 += ks[(i + 1) % 3]
        x0 &= _M32
        x1 += ks[(i + 2) % 3] + i + 1
        x1 &= _M32
    return x0, x1


def _hash_pair(k, x0: int, x1: int) -> tuple[int, int]:
    """:func:`threefry2x32` of one counter pair, in Python integers (a
    key derivation costs microseconds this way, not hundreds of tensor
    operations)."""
    k0, k1 = _as_key(k)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(k, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(k, num)`` (partitionable): key ``i`` is the word
    pair ``threefry2x32(k, (0, i))``."""
    return [_hash_pair(k, 0, i) for i in range(num)]


def fold_in(k, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)``: the word pair ``threefry2x32(k,
    (0, data))``, ``data`` taken as a uint32 as JAX does."""
    return _hash_pair(k, 0, int(data) & _M32)


def _draw(k, shape, device, finish) -> torch.Tensor:
    """float32 ``shape`` on ``device`` from the random bits of ``k``,
    chunk by chunk: ``finish(bits)`` maps an int64 chunk of 32-bit words
    to its float32 values."""
    device = torch.device(device)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    step = _CHUNK.get(device.type, _CHUNK["cuda"])
    for start in range(0, n, step):
        idx = torch.arange(start, min(start + step, n), dtype=torch.int64, device=device)
        a, b = threefry2x32(k, idx >> 32, idx & _M32)
        out[start : start + idx.numel()] = finish(a ^ b)
    return out.reshape(shape)


def random_bits(k, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2^32)."""
    device = torch.device(device)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k, idx >> 32, idx & _M32)
    return (a ^ b).reshape(shape)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values (``b`` and ``c`` tensors or Python
    floats holding float32 values) rounded once, as XLA contracts it into
    a fused multiply-add: the float32 product is exact in float64, and the
    float64 sum is exact too wherever the three share a scale, as in the
    draws here."""
    return (a.double() * b + c).float()


def _uniform_of(bits: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The float32 uniform draws in [lo, hi) (0-d float32 tensors on the
    draw's device) of int64 32-bit words ``bits``."""
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.maximum(lo, fma32(one_two - 1.0, hi - lo, lo))


def _uniform_draw(k, shape, minval, maxval, device, then=lambda u: u) -> torch.Tensor:
    """``then(uniform draws)``, chunk by chunk."""
    lo, hi = _f32(minval, device), _f32(maxval, device)
    return _draw(k, shape, device, lambda bits: then(_uniform_of(bits, lo, hi)))


def uniform(k, shape, minval=0.0, maxval=1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top
    23 bits as a float in [1, 2), minus 1, times ``maxval - minval`` plus
    ``minval`` rounded once (XLA contracts the two into a fused
    multiply-add), at least ``minval``."""
    return _uniform_draw(k, shape, minval, maxval, device)


#: XLA's float32 ``erf_inv`` (Giles, "Approximating the erfinv function"):
#: degree-8 polynomials in ``w - 2.5`` below ``w = -log1p(-x^2) = 5`` and in
#: ``sqrt(w) - 3`` above, highest power first.
_ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` polynomial on a float32 tensor (+-1 maps
    to +-the largest float32, as XLA's select does)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, a, b) for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma32(p, w, c)
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


def normal(k, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: ``sqrt(2) * erfinv(u)``
    for ``u = uniform(k, shape, nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    sqrt2 = _f32(np.sqrt(2), device)
    return _uniform_draw(k, shape, lo, 1.0, device, lambda u: erfinv(u) * sqrt2)


def truncated_normal(k, lower, upper, shape, device="cpu") -> torch.Tensor:
    """``jax.random.truncated_normal(k, lower, upper, shape, float32)``:
    ``sqrt(2) * erfinv(u)`` for ``u = uniform(k, shape, erf(lower /
    sqrt(2)), erf(upper / sqrt(2)))``, clipped to the open interval
    (``nextafter`` of each bound towards the other).  The two ``erf``
    values are float32 scalars, as JAX computes them."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a, b = (torch.erf(torch.tensor(x / sqrt2, dtype=torch.float32)).item()
            for x in (lower, upper))
    lo = float(np.nextafter(lower, np.float32(np.inf)))
    hi = float(np.nextafter(upper, np.float32(-np.inf)))
    sqrt2_t = _f32(sqrt2, device)
    return _uniform_draw(k, shape, a, b, device,
                         lambda u: torch.clamp(erfinv(u) * sqrt2_t, lo, hi))


def bernoulli(k, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform(k, shape) < p`` in
    float32, as a bool tensor."""
    return uniform(k, shape, device=device) < _f32(p, device)


def gumbel(k, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(k, shape, float32)`` (its default "low" mode):
    ``-log(-log(uniform(tiny, 1)))``."""
    tiny = np.finfo(np.float32).tiny
    return _uniform_draw(k, shape, tiny, 1.0, device, lambda u: -torch.log(-torch.log(u)))


def categorical(k, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis: the
    argmax of ``gumbel + logits`` (the first index on a tie)."""
    g = gumbel(k, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
