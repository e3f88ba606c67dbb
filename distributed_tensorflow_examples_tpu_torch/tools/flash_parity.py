"""Fused-vs-split flash-backward parity and bitwise determinism: the port's
twin of ``tools/flash_parity.py``, the gate to pass before trusting
``DTX_FUSED_BWD=1``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.flash_parity \\
        [--quick] [--segmented] [--device=cuda]

On the reference's cases (bf16 causal and f32 non-causal at [1, 2, 2048,
128]; without ``--quick`` also bf16 causal at [1, 8, 8192, 128]; with
``--segmented`` bf16 causal at [1, 1, 32768, 128], where the reference
segments q and the port runs one uncapped fused call), for the gradients
of ``sum(flash_attention(q, k, v)**2)``:

1. fused against split dq/dk/dv, within 0.05 of the largest entry in bf16
   and 2e-4 in f32 (the two order their f32 sums differently);
2. fused against autograd through dense ``mha``, at the two T 2048 cases;
3. two fused runs, bitwise equal.

On the card, the fused runs must also have launched the fused kernel and
the split run the split pair.  Prints one JSON line ``{"parity_ok": ...,
"cases": [...]}`` and exits 0 (pass) or 1.  The inputs are
``0.5 * standard_normal`` from ``numpy.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import ops
from ..ops import attention, flash_attention as flash

_BWD_KERNELS = ("flash_fused_bwd", "flash_dq", "flash_dkv")
_INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _qkv(b, h, t, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (torch.from_numpy(rng.standard_normal((b, h, t, d), dtype=np.float32)) * 0.5)
        .to(device=device, dtype=dtype)
        for _ in range(3)
    ]


def _grads(q, k, v, *, causal, fused=None, attend=None):
    """(dq, dk, dv) of sum(attend(q, k, v)**2) in f32, with the fused
    backward forced on or off, and the backward kernels it launched."""
    attend = attend or flash.flash_attention
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = {name: ops.LAUNCHES[name] for name in _BWD_KERNELS}
    saved = flash._FUSED_BWD_OVERRIDE
    flash._FUSED_BWD_OVERRIDE = fused
    try:
        loss = (attend(*leaves, causal=causal).float() ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        flash._FUSED_BWD_OVERRIDE = saved
    return grads, {name: ops.LAUNCHES[name] - before[name] for name in _BWD_KERNELS}


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    denom = max(a.abs().max().item(), b.abs().max().item(), 1e-6)
    return (a - b).abs().max().item() / denom


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(_INT_VIEW[a.dtype]), b.view(_INT_VIEW[b.dtype]))


def run_case(b, h, t, d, dtype, causal, *, check_ref, device="cuda") -> dict:
    q, k, v = _qkv(b, h, t, d, dtype, device)
    gf, lf = _grads(q, k, v, causal=causal, fused=True)
    gs, ls = _grads(q, k, v, causal=causal, fused=False)
    gf2, _ = _grads(q, k, v, causal=causal, fused=True)

    rec = {"shape": [b, h, t, d], "dtype": str(dtype).removeprefix("torch."),
           "causal": causal}
    tol = 0.05 if dtype == torch.bfloat16 else 2e-4
    ok = True
    for name, f, s in zip(("dq", "dk", "dv"), gf, gs):
        rec[f"{name}_vs_split_rel"] = _rel(f, s)
        ok &= rec[f"{name}_vs_split_rel"] <= tol
    if check_ref:  # dense attention materialises [T, T]: small cases only
        gr, _ = _grads(q, k, v, causal=causal, attend=attention.mha)
        for name, f, r in zip(("dq", "dk", "dv"), gf, gr):
            rec[f"{name}_vs_ref_rel"] = _rel(f, r)
            ok &= rec[f"{name}_vs_ref_rel"] <= max(tol, 0.05)
    rec["bitwise_deterministic"] = all(_same_bits(a, c) for a, c in zip(gf, gf2))
    if q.device.type == "cuda":
        rec["launches_fused_run"], rec["launches_split_run"] = lf, ls
        ok &= lf == {"flash_fused_bwd": 1, "flash_dq": 0, "flash_dkv": 0}
        ok &= ls == {"flash_fused_bwd": 0, "flash_dq": 1, "flash_dkv": 1}
    rec["ok"] = bool(ok and rec["bitwise_deterministic"])
    return rec


def run(*, quick: bool = False, segmented: bool = False, device: str = "cuda") -> dict:
    """The reference's cases; ``{"parity_ok", "device", "cases"}``."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        run_case(1, 2, 2048, 128, bf16, True, check_ref=True, device=device),
        run_case(1, 2, 2048, 128, f32, False, check_ref=True, device=device),
    ]
    if not quick:
        cases.append(run_case(1, 8, 8192, 128, bf16, True, check_ref=False, device=device))
    if segmented:
        cases.append(run_case(1, 1, 32768, 128, bf16, True, check_ref=False, device=device))
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"parity_ok": all(c["ok"] for c in cases), "device": name, "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="skip the T=8192 case")
    ap.add_argument("--segmented", action="store_true",
                    help="add the T=32768 case (the reference's segmented regime)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = run(quick=args.quick, segmented=args.segmented, device=args.device)
    print(json.dumps(result))
    return 0 if result["parity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
