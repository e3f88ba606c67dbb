"""The check of the flash kernels' f32-out routes on the tensor cores that
accounts for bf16 rounding flips, in place of a looser tolerance.

B1-B4 at bf16 in and f32 out (``ops/csrc/flash_fwd.cu``, ``flash_bwd.cu``,
``flash_fused_bwd.cu``: the flash ring's hops) sum s = q.k^T and dp =
do.v^T on the tensor cores, in another order than their plain versions,
which moves them by ~1e-7 relative.  Now and then a p or a ds then lands
on the other side of a bf16 rounding boundary, and the product term it
feeds moves by 2^-8 of itself, past the f32 tolerance that only equal
scores could meet.  So the check splits the kernel's result into two
claims, each held tightly:

1. **Faithful sums.**  Fed the kernel's own bf16 p and ds (its check-only
   instance records them: ``flash_attention.dq_record``/``dkv_record``/
   ``fused_bwd_record``), the plain walks reproduce the kernel's f32 dq,
   dk and dv within :data:`TOL` of the largest entry, the f32 tolerance of
   the other backward checks: the operands are then the same bf16 values,
   and only the f32 summation order differs.  The forward
   (``flash_attention.fwd_record``) records the p that entered p.v and
   each row's running max m after every k tile; fed both, the plain walk
   reproduces the kernel's f32 o within :data:`TOL_O` and its lse within
   :data:`TOL_LSE` (absolute), the f32 tolerances of the forward's check.
2. **Faithful roundings.**  Each recorded p is the plain walk's own
   rounded p or one of its two bf16 neighbours (p >= 0, so their bf16 bit
   patterns differ by at most 1), each recorded ds lies within
   :func:`ds_bound` of the plain walk's own rounded ds, and each recorded
   running max lies within :func:`m_bound` of the plain walk's own.

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

The forward's bound on the running max, fixed before its first run on a
card.  The max itself rounds nothing (both sides take the largest of the
same f32 scores, and a masked score is -1e30 on both), so after k tile J
of row i the two maxima differ by at most the largest score gap over the
keys the row has seen:
- E_m(i, J) = max over visible keys j < 64 (J + 1) of E_s(i, j), plus
  2 u |m| (each side's score may round once more as it is read back);
- the forward's p = exp2(s - m) then differs by the relative eps_p =
  ln 2 (E_s + E_m + 2 u (|s - m| + |m|)) + 8 u: the bound above with lse2
  replaced by the running max, which now carries its own gap E_m, and
  the tile's E_m taken at the key's tile.  A recorded p must lie within
  one bf16 step of the plain one (claim 2), and within bf16_step + p eps_p
  of it (:func:`p_bound`, reported as the worst gap over its bound).
A running max off by a fault (a missed mask, a wrong fold, a skipped tile)
moves by the order of a score, ~10^3-10^4 times E_m.

:func:`check` (the split pair), :func:`check_fused` and :func:`check_fwd`
run both claims for one input and return the gaps, the share of p and ds
that flipped, and ``ok``.  ``chip_smoke.py`` phase 2 runs them on the
card; the CPU tests feed them injected faults.
"""

from __future__ import annotations

import math

import torch

#: Claim 1's tolerance, relative to the largest entry of each output: the
#: f32 tolerance of every backward check (``chip_smoke.TOL_BWD[f32]``).
TOL = 2e-5
#: The forward's claim-1 tolerances, absolute: ``chip_smoke.TOL_O[f32]``
#: on o and ``chip_smoke.TOL_LSE`` on lse.
TOL_O = 1e-4
TOL_LSE = 1e-3
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


def p_bound(p_k, p_p, eps_p):
    """The forward's bound on |p_k - p_p| at each pair (the module
    docstring): one bf16 step at the larger, plus p eps_p."""
    p_hi = torch.maximum(p_k.float(), p_p.float()) * (1.0 + 2.0 ** -7)
    return bf16_step(p_hi) + p_hi * eps_p


def m_bound(e_s, m, causal: bool, block_k: int):
    """E_m [BH, T, ceil(T / block_k)] (the module docstring): after each k
    tile, the largest E_s over the visible keys a row has seen, plus
    2 u |m|."""
    bh, t, _t = e_s.shape
    if causal:  # a key past the row is masked: -1e30 on both sides
        e_s = e_s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=e_s.device).triu(1), 0.0)
    nk = -(-t // block_k)
    padded = torch.nn.functional.pad(e_s, (0, nk * block_k - t))
    per_tile = padded.view(bh, t, nk, block_k).amax(dim=-1)
    return per_tile.cummax(dim=-1).values + 2 * U_RN * m.abs()


def _rel(got, want) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def _share(a, b) -> float:
    """Share of the pairs where either is non-zero whose values differ."""
    a, b = a.float(), b.float()
    live = int(((a != 0) | (b != 0)).sum().item())
    return int((a != b).sum().item()) / max(live, 1)


def _bwd_bounds(flash, args):
    """(eps_p, E_dp) [BH, T, T] for the backward's p = exp2(s - lse2) and
    dp = do.v^T (the module docstring)."""
    qs, kf, vf, dof, lse2 = flash._bwd_operands(*args[:5])
    s = qs @ kf.transpose(1, 2)
    eps_p = math.log(2.0) * (sum_bound(qs, kf) + 2 * U_RN * ((s - lse2).abs() + lse2.abs()))
    eps_p += 8 * U_RN
    del s
    return eps_p, sum_bound(dof, vf)


def _hold_p_ds(name, rec, own, e_dp, eps_p, out: dict, failed: list) -> None:
    """Claim 2 for one backward kernel's recorded (p, ds) against the plain
    walk's own: p within one bf16 step, ds within :func:`ds_bound`."""
    (p_k, ds_k), (p_p, ds_p) = rec, own
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


def _check_records(args, recs) -> None:
    bh, t, _d = args[0].shape
    for rec in recs:
        if any(x.dtype != torch.bfloat16 or tuple(x.shape) != (bh, t, t) for x in rec):
            raise ValueError(f"records must be bfloat16 [{bh}, {t}, {t}]")


def _claim1(names, got, fed, tol) -> tuple[dict, list]:
    gaps = {n: _rel(g, f) for n, g, f in zip(names, got, fed)}
    return gaps, [f"claim 1 {n} {r:.3e} > {tol:g}" for n, r in gaps.items()
                  if not (math.isfinite(r) and r <= tol)]


def check(flash, args, causal: bool, got, dq_rec, dkv_rec, tol: float = TOL) -> dict:
    """Claims 1 and 2 for the split pair on one input.  ``flash`` is the
    port's ``ops.flash_attention``; ``args`` are (q, k, v, do, lse, delta)
    with bf16 q, k, v, do; ``got`` the kernels' f32 (dq, dk, dv); ``dq_rec``
    and ``dkv_rec`` the (p, ds) [BH, T, T] bf16 their check-only instances
    recorded.  Returns the claim-1 gaps (``fed``), the largest p gap in
    bf16 steps, the largest ds gap over its bound (``ds_excess``, <= 0 when
    held), the flip shares, ``ok`` and ``failed`` (what did not hold)."""
    _check_records(args, (dq_rec, dkv_rec))
    tiles_q, tiles_kv = (flash.DQ_BLOCK_Q, flash.DQ_BLOCK_K), (flash.DKV_BLOCK_Q, flash.DKV_GROUP_K)
    fed = (flash._dq_walk(*args, causal, *tiles_q, given=dq_rec),
           *flash._dkv_walk(*args, causal, *tiles_kv, given=dkv_rec))
    gaps, failed = _claim1(("dq", "dk", "dv"), got, fed, tol)
    out: dict = {"fed": gaps}
    del fed
    own = {"flash_dq": flash._dq_walk(*args, causal, *tiles_q, keep=True)[-1],
           "flash_dkv": flash._dkv_walk(*args, causal, *tiles_kv, keep=True)[-1]}
    eps_p, e_dp = _bwd_bounds(flash, args)
    for name, rec in (("flash_dq", dq_rec), ("flash_dkv", dkv_rec)):
        _hold_p_ds(name, rec, own[name], e_dp, eps_p, out, failed)
    out["ok"], out["failed"] = not failed, failed
    return out


def check_fused(flash, args, causal: bool, got, rec, tol: float = TOL) -> dict:
    """Claims 1 and 2 for the fused backward on one input: as
    :func:`check`, with ``got`` the kernel's f32 (dq, dk, dv) and ``rec``
    the (p, ds) its check-only instance recorded (``fused_bwd_record``).
    Claim 2's results sit under ``"flash_fused_bwd"``."""
    _check_records(args, (rec,))
    fed = flash._fused_walk(*args, causal, torch.float32, given=rec)
    gaps, failed = _claim1(("dq", "dk", "dv"), got, fed, tol)
    out: dict = {"fed": gaps}
    del fed
    own = flash._fused_walk(*args, causal, torch.float32, keep=True)[-1]
    eps_p, e_dp = _bwd_bounds(flash, args)
    _hold_p_ds("flash_fused_bwd", rec, own, e_dp, eps_p, out, failed)
    out["ok"], out["failed"] = not failed, failed
    return out


def check_fwd(flash, qkv, causal: bool, got, rec, tol_o: float = TOL_O,
              tol_lse: float = TOL_LSE) -> dict:
    """Claims 1 and 2 for the forward on one input.  ``qkv`` are bf16 (q,
    k, v); ``got`` the kernel's f32 (o, lse); ``rec`` the (p, m) its
    check-only instance recorded (``fwd_record``: p [BH, T, T] bf16, m
    [BH, T, ceil(T / FWD_BLOCK_K)] f32).  Returns the claim-1 gaps
    (``fed``: o and lse, absolute), and under ``"flash_fwd"`` the largest p
    gap in bf16 steps, the flip share of p, the worst p gap over
    :func:`p_bound`, the largest running-max gap over :func:`m_bound`
    (``m_excess``, <= 0 when held) and its worst share of the bound; ``ok``
    and ``failed``."""
    q, k, v = qkv
    bh, t, _d = q.shape
    nk = -(-t // flash.FWD_BLOCK_K)
    p_k, m_k = rec
    if p_k.dtype != torch.bfloat16 or tuple(p_k.shape) != (bh, t, t):
        raise ValueError(f"p must be bfloat16 [{bh}, {t}, {t}]")
    if m_k.dtype != torch.float32 or tuple(m_k.shape) != (bh, t, nk):
        raise ValueError(f"m must be float32 [{bh}, {t}, {nk}]")
    fed = flash._fwd_walk(q, k, v, causal, torch.float32, given=rec)
    gaps = {n: (g.float() - f.float()).abs().max().item() for n, g, f in zip(("o", "lse"), got, fed)}
    failed = [f"claim 1 {n} {e:.3e} > {tol:g}" for (n, e), tol in zip(gaps.items(), (tol_o, tol_lse))
              if not (math.isfinite(e) and e <= tol)]
    out: dict = {"fed": gaps}
    del fed
    p_p, m_p = flash._fwd_walk(q, k, v, causal, torch.float32, keep=True)[-1]
    qs, kf = flash._fold(q), k.float()
    e_s = sum_bound(qs, kf)
    e_m = m_bound(e_s, m_p, causal, flash.FWD_BLOCK_K)
    m_gap = (m_k - m_p).abs()
    m_excess = (m_gap - e_m).max().item()
    # Each key's tile: its row's running max and E_m there.
    tile = torch.arange(t, device=q.device) // flash.FWD_BLOCK_K
    m_at, e_m_at = m_p[:, :, tile], e_m[:, :, tile]
    s = qs @ kf.transpose(1, 2)
    eps_p = math.log(2.0) * (e_s + e_m_at + 2 * U_RN * ((s - m_at).abs() + m_at.abs()))
    eps_p += 8 * U_RN
    del s, e_s, m_at, e_m_at
    bound = p_bound(p_k, p_p, eps_p)
    gap = (p_k.float() - p_p.float()).abs()
    steps = bit_steps(p_k, p_p)
    out["flash_fwd"] = {"p_steps": steps, "p_flips": _share(p_k, p_p),
                        "p_worst_over_bound": (gap / bound.clamp_min(1e-38)).max().item(),
                        "m_excess": m_excess,
                        "m_worst_over_bound": (m_gap / e_m.clamp_min(1e-38)).max().item()}
    if steps > 1:
        failed.append(f"claim 2 flash_fwd: a p {steps} bf16 steps from the plain one")
    if not (math.isfinite(m_excess) and m_excess <= 0):
        failed.append(f"claim 2 flash_fwd: a running max {m_excess:.3e} past its bound")
    out["ok"], out["failed"] = not failed, failed
    return out
