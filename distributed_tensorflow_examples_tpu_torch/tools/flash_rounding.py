"""The check of the split backward's f32-out route on the tensor cores that
accounts for bf16 rounding flips, in place of a looser tolerance.

B2 and B3 at bf16 in and f32 out (``ops/csrc/flash_bwd.cu``, the flash
ring's hops) sum s = q.k^T and dp = do.v^T on the tensor cores, in another
order than their plain versions, which moves them by ~1e-7 relative.  Now
and then a p or a ds then lands on the other side of a bf16 rounding
boundary, and the product term it feeds moves by 2^-8 of itself, past the
f32 tolerance that only equal scores could meet.  So the check splits the
kernel's result into two claims, each held tightly:

1. **Faithful sums.**  Fed the kernel's own bf16 p and ds (its check-only
   instance records them: ``flash_attention.dq_record``/``dkv_record``),
   the plain walks reproduce the kernel's f32 dq, dk and dv within
   :data:`TOL` of the largest entry, the f32 tolerance of the other
   backward checks: the operands are then the same bf16 values, and only
   the f32 summation order differs.
2. **Faithful roundings.**  Each recorded p is the plain walk's own
   rounded p or one of its two bf16 neighbours (p >= 0, so their bf16 bit
   patterns differ by at most 1), and each recorded ds lies within
   :func:`ds_bound` of the plain walk's own rounded ds.

The bound of claim 2, fixed before its first run on a card.  For one
(q row i, key j) pair, with u = 2^-24 (f32 round to nearest) and
U = 2^-22 (the tensor cores' f32 accumulation, which may truncate; taken as
4 u a step):
- one dot product over the D head columns, computed by both sides,
  differs by at most E(x, y)_ij = D (u + U) sum_c |x_ic| |y_jc|
  (:func:`sum_bound`: the classical gamma_D bound, each side at its own
  unit); s = qs.k^T differs by E_s = E(qs, k), dp = do.v^T by
  E_dp = E(do, v);
- p = exp2(s - lse2) differs by the relative eps_p = ln 2 (E_s +
  2 u (|s - lse2| + |lse2|)) + 8 u: the scores' gap, each side's rounding
  of lse * log2(e) and of the difference, and each side's exp2 (CUDA's
  exp2f is within 2 ulp);
- ds = p (dp - delta) differs, unrounded, by at most
  p E_dp + |ds| (eps_p + 4 u) (each side rounds dp - delta and the
  product once);
- rounded to bf16 on each side, by that plus one bf16 step at the larger
  of the two rounded values.
p and |ds| unrounded are taken as the larger rounded value times
(1 + 2^-7).  The bound is loose by design (worst cases summed), yet a sign,
mask or scale fault moves ds by the order of ds itself, ~10^3 times more.

:func:`check` runs both claims for one input and returns the gaps, the
share of p and ds that flipped, and ``ok``.  ``chip_smoke.py`` phase 2
runs it on the card; the CPU tests feed it injected faults.
"""

from __future__ import annotations

import math

import torch

#: Claim 1's tolerance, relative to the largest entry of each output: the
#: f32 tolerance of every backward check (``chip_smoke.TOL_BWD[f32]``).
TOL = 2e-5
#: f32 round to nearest, and the tensor cores' accumulation step.
U_RN = 2.0 ** -24
U_TC = 2.0 ** -22


def sum_bound(x, y):
    """E(x, y) [BH, T, T]: how far two f32 computations of the [BH, T, D]
    x times y^T, one by round to nearest and one by the tensor cores, may
    lie apart at each (row of x, row of y)."""
    d = x.shape[-1]
    return d * (U_RN + U_TC) * (x.abs() @ y.abs().transpose(1, 2))


def bf16_step(x):
    """The spacing of bf16 values at |x| (0 where x is 0): 2^(e - 7) for
    |x| in [2^e, 2^(e + 1)), the subnormal spacing 2^-133 below 2^-126."""
    m, e = torch.frexp(x.abs().float())
    step = torch.ldexp(torch.ones_like(m), e - 8).clamp_min(2.0 ** -133)
    return torch.where(x == 0, torch.zeros_like(step), step)


def bit_steps(a, b):
    """Max distance in bf16 steps between two bf16 tensors of one sign
    (their bit patterns as integers)."""
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max().item()) if ia.numel() else 0


def ds_bound(p_k, p_p, ds_k, ds_p, e_dp, eps_p):
    """Claim 2's bound on |ds_k - ds_p| at each pair (the module
    docstring): one bf16 step at the larger, plus p E_dp, plus |ds| times
    (eps_p + 4 u)."""
    grow = 1.0 + 2.0 ** -7
    p_hi = torch.maximum(p_k.float(), p_p.float()) * grow
    ds_hi = torch.maximum(ds_k.float().abs(), ds_p.float().abs())
    return bf16_step(ds_hi) + p_hi * e_dp + ds_hi * grow * (eps_p + 4 * U_RN)


def _rel(got, want) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def _share(a, b) -> float:
    """Share of the pairs where either is non-zero whose values differ."""
    a, b = a.float(), b.float()
    live = int(((a != 0) | (b != 0)).sum().item())
    return int((a != b).sum().item()) / max(live, 1)


def check(flash, args, causal: bool, got, dq_rec, dkv_rec, tol: float = TOL) -> dict:
    """Claims 1 and 2 for one input.  ``flash`` is the port's
    ``ops.flash_attention``; ``args`` are (q, k, v, do, lse, delta) with
    bf16 q, k, v, do; ``got`` the kernel's f32 (dq, dk, dv); ``dq_rec`` and
    ``dkv_rec`` the (p, ds) [BH, T, T] bf16 its check-only instances
    recorded.  Returns the claim-1 gaps (``fed``), the largest p gap in
    bf16 steps, the largest ds gap over its bound (``ds_excess``, <= 0 when
    held), the flip shares, ``ok`` and ``failed`` (what did not hold)."""
    bh, t, _d = args[0].shape
    for rec in (dq_rec, dkv_rec):
        if any(x.dtype != torch.bfloat16 or tuple(x.shape) != (bh, t, t) for x in rec):
            raise ValueError(f"records must be bfloat16 [{bh}, {t}, {t}]")
    tiles_q, tiles_kv = (flash.DQ_BLOCK_Q, flash.DQ_BLOCK_K), (flash.DKV_BLOCK_Q, flash.DKV_GROUP_K)
    fed = (flash._dq_walk(*args, causal, *tiles_q, given=dq_rec),
           *flash._dkv_walk(*args, causal, *tiles_kv, given=dkv_rec))
    out: dict = {"fed": {n: _rel(g, f) for n, g, f in zip(("dq", "dk", "dv"), got, fed)}}
    del fed
    own = {"flash_dq": flash._dq_walk(*args, causal, *tiles_q, keep=True)[-1],
           "flash_dkv": flash._dkv_walk(*args, causal, *tiles_kv, keep=True)[-1]}
    qs, kf, vf, dof, lse2 = flash._bwd_operands(*args[:5])
    s = qs @ kf.transpose(1, 2)
    eps_p = math.log(2.0) * (sum_bound(qs, kf) + 2 * U_RN * ((s - lse2).abs() + lse2.abs()))
    eps_p += 8 * U_RN
    del s
    e_dp = sum_bound(dof, vf)
    failed = [f"claim 1 {n} {r:.3e} > {tol:g}" for n, r in out["fed"].items()
              if not (math.isfinite(r) and r <= tol)]
    for name, (p_k, ds_k) in (("flash_dq", dq_rec), ("flash_dkv", dkv_rec)):
        p_p, ds_p = own[name]
        steps = bit_steps(p_k, p_p)
        bound = ds_bound(p_k, p_p, ds_k, ds_p, e_dp, eps_p)
        gap = (ds_k.float() - ds_p.float()).abs()
        excess = (gap - bound).max().item()
        out[name] = {"p_steps": steps, "p_flips": _share(p_k, p_p),
                     "ds_excess": excess, "ds_flips": _share(ds_k, ds_p),
                     "ds_worst_over_bound": (gap / bound.clamp_min(1e-38)).max().item()}
        if steps > 1:
            failed.append(f"claim 2 {name}: a p {steps} bf16 steps from the plain one")
        if not (math.isfinite(excess) and excess <= 0):
            failed.append(f"claim 2 {name}: a ds {excess:.3e} past its bound")
    out["ok"], out["failed"] = not failed, failed
    return out
