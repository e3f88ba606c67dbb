"""The bf16-out flash forward (B1) and fused backward (B4) of two checkouts
of this repository on one card: their outputs bit for bit, their times in
turns, and the registers ptxas gave each tensor-core instance::

    python -m distributed_tensorflow_examples_tpu_torch.tools.flash_ab OTHER

``OTHER`` is the root of another checkout (say, a parent commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists).  Each turn is
a process of its own in one checkout's root (that checkout's package and
kernels, built from its sources into its own ``build/kernels/``), in the
order other, this, this, other.  Every turn draws the same inputs on the
card from fixed seeds and runs B1 at the shapes ``chip_smoke.py``'s phase
2 checks it at with bf16 out, and B4 likewise; it prints a digest of every
output's bits and CUDA-event times of B1 at [16, 2048, 128] causal and B4
at [16, 8192, 128] causal.  The last line is one JSON object: whether the
two checkouts' outputs agree bit for bit at every shape, the times by turn
and the tensor-core instances' registers and spills in each.  A turn needs
only the functions both checkouts have (``fwd_call``, ``fused_bwd_call``,
``compute_delta``, ``_build``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: One turn, run as ``python -c TURN`` from a checkout's root.
TURN = r'''
import hashlib, json, re, sys
import torch
from distributed_tensorflow_examples_tpu_torch.ops import _build
from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as flash

FWD = [(16, 2048, 128, True), (8, 2048, 128, False), (8, 1000, 128, True),
       (8, 2048, 64, True), (8, 2048, 32, True), (16, 8192, 128, True)]
FUSED = [(16, 8192, 128, True), (8, 2048, 128, False), (8, 1000, 64, True),
         (8, 1000, 32, False), (3, 320, 128, True), (3, 192, 32, False)]
bf16 = torch.bfloat16
_build.build(["flash_fwd", "flash_fused_bwd"])


def inputs(bh, t, d, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, t, d, device="cuda", generator=g).to(bf16) for _ in range(n)]


def digest(xs):
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().view(torch.int16 if x.dtype == bf16 else torch.int32)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def fused_args(bh, t, d, causal):
    q, k, v, do = inputs(bh, t, d, 4, bh * 131 + t * 7 + d + 1)
    o, lse = flash.fwd_call(q, k, v, causal=causal)
    return q, k, v, do, lse, flash.compute_delta(do, o)


out = {"digests": {}, "ms": {}, "ptxas": {}}
for bh, t, d, c in FWD:
    q, k, v = inputs(bh, t, d, 3, bh * 7919 + t * 31 + d)
    out["digests"][f"flash_fwd [{bh}, {t}, {d}] causal={c}"] = digest(
        flash.fwd_call(q, k, v, causal=c))
    if (bh, t, d, c) == FWD[0]:
        out["ms"]["flash_fwd [16, 2048, 128] causal"] = ms(lambda: flash.fwd_call(q, k, v, causal=c))
for bh, t, d, c in FUSED:
    args = fused_args(bh, t, d, c)
    out["digests"][f"flash_fused_bwd [{bh}, {t}, {d}] causal={c}"] = digest(
        flash.fused_bwd_call(*args, causal=c))
    if (bh, t, d, c) == FUSED[0]:
        out["ms"]["flash_fused_bwd [16, 8192, 128] causal"] = ms(
            lambda: flash.fused_bwd_call(*args, causal=c), iters=5)
    del args
torch.cuda.synchronize()
for lib in ("flash_fwd", "flash_fused_bwd"):
    name = None
    for line in open(str(_build.library_path(lib)) + ".log").read().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_(?:fwd|fused_bwd)_tc_kernel)ILi(\d+)E(f|13__nv_bfloat16)?"
                          r"(?:Lb(\d)E)?", m.group(1))
            name = (f"{k.group(1)}<{'bf16->f32' if k.group(3) == 'f' else 'bf16->bf16'}, "
                    f"D={k.group(2)}{', record' if k.group(4) == '1' else ''}>") if k else None
            spill = ""
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and re.search(r"Used (\d+) registers", line):
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out["ptxas"][name] = f"{regs} registers; {spill}"
            name = None
print("TURN " + json.dumps(out))
'''


def turn(root: Path) -> dict:
    """One turn in checkout ``root``: its digests, times and ptxas lines."""
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"flash_ab: the turn in {root} failed:\n{proc.stdout}\n{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("TURN "))
    return json.loads(line[len("TURN "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args(argv)
    import torch

    from .profile_step import card_line

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    other = Path(args.other).resolve()
    turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    results = []
    for tag, root in turns:
        r = turn(root)
        results.append((tag, r))
        print(f"{tag} ({root}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in r["ms"].items())
              + f" [{card}]")
    this = [r for tag, r in results if tag == "this"]
    that = [r for tag, r in results if tag == "other"]
    same = {k: v == that[0]["digests"].get(k) for k, v in this[0]["digests"].items()}
    steady = this[0]["digests"] == this[1]["digests"] and that[0]["digests"] == that[1]["digests"]
    for name, regs in sorted(this[0]["ptxas"].items()):
        print(f"ptxas {name}: this {regs}; other {that[0]['ptxas'].get(name, 'none')}")
    print(json.dumps({"card": card, "bitwise_equal": all(same.values()), "by_shape": same,
                      "repeatable": steady,
                      "ms": [{"turn": tag, **r["ms"]} for tag, r in results],
                      "ptxas": {"this": this[0]["ptxas"], "other": that[0]["ptxas"]}}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
