"""One card's compute-side A/B of the two context-parallel layouts, the
twin of the root ``tools/ulysses_ab.py``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.ulysses_ab \\
        [--b 2] [--h 8] [--t 8192] [--d 128] [--sp 2,4] [--steps 10]

- **Ulysses** (all-to-all context parallelism): after the head/sequence
  all-to-all each device runs full-T attention over h/sp heads, one
  flash call of [b, h/sp, T, d] a layer;
- **the ring** (point-to-point): each device keeps a T/sp query chunk and
  the k/v chunks visit in sp hops, sp flash calls of [b, h, T/sp, d].

Both schedules do the same multiply-adds (``causal=False``, so every hop
is alike).  The tool times forward plus backward of
``sum(flash_attention(q, k, v).float() ** 2)``, bf16 in and out, of each
schedule with the port's ``ops/flash_attention.flash_attention`` (on the
card: B1, then B4 or B2 + B3, as ``DTX_FUSED_BWD`` has the dispatch
choose at each shape) and ``tools/flash_bench.py::time_ms`` (CUDA events
on the card), and reports t_ring / t_ulysses.  The ring rows leave out
the f32 merge of the hops' partials the real ring does, so the ratio is
a lower bound on the ring's cost; the communication is not timed here.
One JSON line, the root tool's: ``tool``, ``platform``, ``fused_env``,
``shape``, ``note``, ``rows``.  On the card unless ``--device=cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..ops import flash_attention as F
from ..utils import device as device_lib
from ..utils import threefry
from .flash_bench import time_ms


def _qkv(b: int, h: int, t: int, d: int, device) -> list[torch.Tensor]:
    """q, k, v of the root tool: ``jax.random.normal`` under ``split(key(0),
    3)``, times 0.5, in bf16."""
    return [(threefry.normal(k, (b, h, t, d), device=device) * 0.5).to(torch.bfloat16)
            for k in threefry.split(threefry.key(0), 3)]


def grads(q, k, v) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of ``sum(flash_attention(q, k, v).float() ** 2)``."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    loss = (F.flash_attention(*leaves, causal=False).float() ** 2).sum()
    return torch.autograd.grad(loss, leaves)


def grad_time(b: int, h: int, t: int, d: int, *, steps: int, device=None) -> float:
    """Seconds of one forward plus backward of :func:`grads` at [b, h, t,
    d]; the backward is whichever the dispatch takes at this shape."""
    q, k, v = _qkv(b, h, t, d, device_lib.resolve(device))
    return time_ms(lambda: grads(q, k, v), iters=steps) / 1e3


def run(args) -> dict:
    device = device_lib.resolve(args.device)
    rows = []
    for sp in [int(s) for s in args.sp.split(",") if s]:
        if args.h % sp or args.t % sp:
            print(f"skip sp={sp}: h/t not divisible", file=sys.stderr)
            continue
        # Ulysses a device: h/sp heads over the whole T.
        t_uly = grad_time(args.b, args.h // sp, args.t, args.d, steps=args.steps, device=device)
        # The ring a device and hop: every head, T/sp x T/sp.
        t_hop = grad_time(args.b, args.h, args.t // sp, args.d, steps=args.steps, device=device)
        rows.append({
            "sp": sp,
            "t_ulysses_ms": round(t_uly * 1e3, 3),
            "t_ring_hop_ms": round(t_hop * 1e3, 3),
            "t_ring_ms": round(sp * t_hop * 1e3, 3),
            "ring_over_ulysses": round(sp * t_hop / t_uly, 3),
        })
        print(f"sp={sp}: {rows[-1]}", file=sys.stderr)
    return {
        "tool": "ulysses_ab",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "fused_env": os.environ.get("DTX_FUSED_BWD", ""),
        "shape": {"b": args.b, "h": args.h, "t": args.t, "d": args.d},
        "note": "ring rows exclude inter-hop f32 combine -> ratio is a lower bound on ring cost",
        "rows": rows,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--t", type=int, default=8192)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--sp", default="2,4", help="comma list of context-parallel degrees")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device; default cuda (no silent CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
