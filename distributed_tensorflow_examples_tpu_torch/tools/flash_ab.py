"""The bf16-out flash forward (B1) and fused backward (B4), and the
BatchNorm statistics kernels (B6, B7), of two checkouts of this
repository on one card: their outputs bit for bit, their times in turns,
and the registers ptxas gave each flash tensor-core instance::

    python -m distributed_tensorflow_examples_tpu_torch.tools.flash_ab OTHER \\
        [--kernels flash,bn]

``OTHER`` is the root of another checkout (say, a parent commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists).  Each turn is
a process of its own in one checkout's root (that checkout's package and
kernels, built from its sources into its own ``build/kernels/``), in the
order other, this, this, other.  Every turn draws the same inputs on the
card from fixed seeds.  A flash turn runs B1 at the shapes
``chip_smoke.py``'s phase 2 checks it at with bf16 out, and B4 likewise;
it prints a digest of every output's bits and CUDA-event times of B1 at
[16, 2048, 128] causal and B4 at [16, 8192, 128] causal.  A BN turn runs
B6 and B7 at the 12 distinct BatchNorm shapes of a ResNet-50 step (batch
256, 224^2; B7 with the step's ReLU flags): a digest of every output's
bits, a second run's equality, the largest per-channel error against
the plain version (``TOL_BN``, 1e-4, as ``chip_smoke.py``), CUDA-event
times at the stem and summed over the 53 shapes, and each call's device
us and kernel count from ``torch.profiler``.  The last line is one JSON
object: whether the flash outputs agree bit for bit at every shape, the
times by turn and the tensor-core instances' registers and spills; for
BN whether B7 agrees bit for bit (its kernels did not change) and B6
(its sums may take another order), whether every turn repeated itself
and kept within ``TOL_BN``, and the times by turn.  A turn needs only
the functions both checkouts have (``fwd_call``, ``fused_bwd_call``,
``compute_delta``, ``bn_stats``, ``bn_bwd_stats`` and their plain
versions, ``flash_bench``'s ResNet shapes, ``_build``).
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


#: One BN turn, run as ``python -c TURN_BN`` from a checkout's root.
TURN_BN = r'''
import collections, hashlib, json, math
import torch
from torch.profiler import ProfilerActivity, profile
from distributed_tensorflow_examples_tpu_torch.ops import _build, bn
from distributed_tensorflow_examples_tpu_torch.tools import flash_bench as fb

TOL_BN = 1e-4
_build.build(["bn_stats"])
shapes = fb.resnet50_bn_shapes(256, 224)
biggest = max(math.prod(sh) for sh, _r in shapes)
g = torch.Generator(device="cuda").manual_seed(3)
xbuf = (torch.randn(biggest, device="cuda", generator=g) * 2 + 0.5).to(torch.bfloat16)
dbuf = torch.randn(biggest, device="cuda", generator=g).to(torch.bfloat16)
args = {}
for shape, _r in shapes:
    n = math.prod(shape)
    x, do = xbuf[:n].view(shape), dbuf[:n].view(shape)
    args[shape] = (do, x, *fb.bn_inputs(bn, x, do))
calls = {
    "bn_stats": lambda sh, relu: bn.bn_stats(args[sh][1]),
    "bn_bwd_stats": lambda sh, relu: bn.bn_bwd_stats(*args[sh], relu=relu),
}
plains = {
    "bn_stats": lambda sh, relu: bn.bn_stats_plain(args[sh][1]),
    "bn_bwd_stats": lambda sh, relu: bn.bn_bwd_stats_plain(*args[sh], relu=relu),
}


def scales(name, sh):
    do, x, mean, inv = args[sh][:4]
    c = sh[-1]
    xf = x.float().reshape(-1, c)
    if name == "bn_stats":
        return xf.abs().sum(0), (xf * xf).sum(0)
    dof = do.float().reshape(-1, c)
    return dof.abs().sum(0), (dof * ((xf - mean) * inv)).abs().sum(0)


def ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


distinct = list(collections.Counter(shapes).items())
out = {"digests": {}, "repeatable": True, "max_rel": {}, "ms": {}, "device_us": {},
       "kernels_a_call": {}}
for name in calls:
    h, rel = hashlib.sha256(), 0.0
    for (sh, relu), _n in distinct:
        got = calls[name](sh, relu)
        again = calls[name](sh, relu)
        out["repeatable"] = out["repeatable"] and all(torch.equal(a, b) for a, b in zip(got, again))
        for a in got:
            h.update(a.contiguous().view(torch.int32).cpu().numpy().tobytes())
        want = plains[name](sh, relu)
        rel = max(rel, *(((a - b).abs().reshape(-1) / m.clamp_min(1e-30)).max().item()
                         for a, b, m in zip(got, want, scales(name, sh))))
    out["digests"][name] = h.hexdigest()[:16]
    out["max_rel"][name] = rel
    out["ms"][f"{name} stem"] = ms(lambda: calls[name](*shapes[0]))
    out["ms"][f"{name} 53 shapes"] = sum(ms(lambda: calls[name](sh, relu)) for sh, relu in shapes)
    # Device us a call by distinct shape: every "bn_" kernel row of this
    # wrapper's calls (one window a wrapper), cut in order.
    iters = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for (sh, relu), _n in distinct:
            for _ in range(iters):
                calls[name](sh, relu)
        torch.cuda.synchronize()
    rows = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CPU and "bn_" in e.name)
    per = len(rows) // (iters * len(distinct))
    out["kernels_a_call"][name] = len(rows) / (iters * len(distinct))
    us = [sum(e - s for s, e in rows[i * per * iters:(i + 1) * per * iters]) / iters
          for i in range(len(distinct))]
    out["device_us"][name] = {f"{list(sh)}{' relu' if relu and name != 'bn_stats' else ''}": u
                              for ((sh, relu), _n), u in zip(distinct, us)}
    out["device_us"][f"{name} step"] = sum(n * u for (_k, n), u in zip(distinct, us))
out["within_tol"] = all(r <= TOL_BN for r in out["max_rel"].values())
print("TURN " + json.dumps(out))
'''


def turn(root: Path, script: str = TURN) -> dict:
    """One turn of ``script`` in checkout ``root``: its JSON line."""
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"flash_ab: the turn in {root} failed:\n{proc.stdout}\n{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("TURN "))
    return json.loads(line[len("TURN "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--kernels", default="flash,bn",
                    help="comma-separated: flash (B1, B4), bn (B6, B7)")
    args = ap.parse_args(argv)
    import torch

    from .profile_step import card_line

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    other = Path(args.other).resolve()
    kinds = args.kernels.split(",")
    turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    record, ok = {"card": card}, True
    if "flash" in kinds:
        results = []
        for tag, root in turns:
            r = turn(root)
            results.append((tag, r))
            print(f"{tag} ({root}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in r["ms"].items())
                  + f" [{card}]")
        this = [r for tag, r in results if tag == "this"]
        that = [r for tag, r in results if tag == "other"]
        same = {k: v == that[0]["digests"].get(k) for k, v in this[0]["digests"].items()}
        steady = (this[0]["digests"] == this[1]["digests"]
                  and that[0]["digests"] == that[1]["digests"])
        for name, regs in sorted(this[0]["ptxas"].items()):
            print(f"ptxas {name}: this {regs}; other {that[0]['ptxas'].get(name, 'none')}")
        record.update(bitwise_equal=all(same.values()), by_shape=same, repeatable=steady,
                      ms=[{"turn": tag, **r["ms"]} for tag, r in results],
                      ptxas={"this": this[0]["ptxas"], "other": that[0]["ptxas"]})
        ok = ok and all(same.values())
    if "bn" in kinds:
        results = []
        for tag, root in turns:
            r = turn(root, TURN_BN)
            results.append((tag, r))
            print(f"{tag} ({root}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in r["ms"].items())
                  + "; device us a step " + ", ".join(
                      f"{k} {r['device_us'][f'{k} step']:.1f} ({r['kernels_a_call'][k]:g} "
                      f"kernels a call)" for k in r["kernels_a_call"])
                  + f"; max rel {r['max_rel']} [{card}]")
        digests = {tag: [r["digests"] for t, r in results if t == tag] for tag in ("this", "other")}
        bn = {
            # B7's kernels are the parent's: bitwise across checkouts.  B6's
            # sums may be added in another order: bitwise run to run only.
            "b7_bitwise_equal": digests["this"][0]["bn_bwd_stats"]
            == digests["other"][0]["bn_bwd_stats"],
            "b6_bitwise_equal": digests["this"][0]["bn_stats"] == digests["other"][0]["bn_stats"],
            "repeatable": all(r["repeatable"] for _t, r in results)
            and all(d[0] == d[1] for d in digests.values()),
            "within_tol": all(r["within_tol"] for _t, r in results),
            "turns": [{"turn": tag, **{k: r[k] for k in ("ms", "device_us", "kernels_a_call",
                                                          "max_rel")}}
                      for tag, r in results],
        }
        record["bn"] = bn
        ok = ok and bn["b7_bitwise_equal"] and bn["repeatable"] and bn["within_tol"]
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
