"""Each workload's collectives in one training step, by kind: the port's
twin of ``tools/comms_scaling.py``'s ``worker(n)``::

    python -m distributed_tensorflow_examples_tpu_torch.tools.comms_scaling [--sizes 2,4]

For each size ``n`` every workload of :func:`workloads` runs one step on
``n`` simulated ranks (``parallel.collectives.ThreadRanks``, CPU, tiny
shapes: a step's bytes depend on the parameters and the per-rank batch,
not on the device), on the mesh its rule table shards it over, and the
step's collective account (``utils/hlo_analysis.py``) prints: each
kind's count and bytes on rank 0, and each tag's.  Weak scaling: the
per-rank batch is fixed.  The JAX tool's ``project()`` (a roofline
projection of the step onto TPU interconnect links) has no twin here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..models import lstm, mlp, resnet, transformer, word2vec
from ..parallel import collectives, sharding
from ..parallel.mesh import MeshSpec, build_mesh
from ..train import optim, state
from ..train import step as step_lib
from ..utils import hlo_analysis

_LM = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, max_seq_len=64,
           compute_dtype="float32", attention="xla")


def _tokens(rng, b: int, t: int = 64, vocab: int = 512) -> dict:
    toks = rng.integers(0, vocab, size=(b, t + 1)).astype(np.int32)
    return {"x": toks[:, :-1], "y": toks[:, 1:]}


def workloads(n: int) -> dict:
    """{name: dict(mesh, cfg, init, loss, rules, opt, batch, per_chip)} at
    ``n`` ranks (``n`` even): ``init(cfg, rows a rank)``, ``loss(cfg,
    mesh)``, ``batch(rng, rows)`` the global batch (the transformers'
    from :func:`_lm_defaults`)."""
    tp = 2 if n >= 4 else 1
    lm = transformer.Config(**_LM)
    pp = dataclasses.replace(lm, n_layers=4, pipeline_stages=2, microbatches=2)
    moe = dataclasses.replace(lm, moe_experts=4, moe_group_size=64)
    w2v = word2vec.Config(vocab_size=10_000, dim=64)
    rn = resnet.Config(compute_dtype="float32")
    ls = lstm.Config(vocab_size=1000, compute_dtype="float32")
    seq_mesh = {"data": n // (2 * tp), "seq": 2, "model": tp}
    return {
        "mlp": dict(mesh={"data": n}, cfg=mlp.Config(compute_dtype="float32"),
                    init=lambda c, b: mlp.init_numpy(c, 0), loss=lambda c, m: mlp.loss_fn(c),
                    rules=(), opt=optim.SGD(0.1), per_chip=16,
                    batch=lambda rng, b: {
                        "image": rng.normal(size=(b, 28, 28, 1)).astype(np.float32),
                        "label": rng.integers(0, 10, size=(b,)).astype(np.int32)}),
        "resnet50": dict(mesh={"data": n}, cfg=rn, init=lambda c, b: resnet.init_numpy(c, 0),
                         loss=lambda c, m: resnet.loss_fn(c, mesh=m),
                         rules=resnet.sharding_rules(rn), opt=optim.SGD(0.1, momentum=0.9),
                         per_chip=2,
                         batch=lambda rng, b: {
                             "image": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
                             "label": rng.integers(0, 1000, size=(b,)).astype(np.int32)}),
        "word2vec": dict(mesh={"data": n // 2, "model": 2}, cfg=w2v,
                         init=lambda c, b: word2vec.init_numpy(c, 0),
                         loss=lambda c, m: word2vec.loss_fn(c),
                         rules=word2vec.SHARDING_RULES, opt=optim.SGD(0.1), per_chip=64,
                         batch=lambda rng, b: {
                             k: rng.integers(0, w2v.vocab_size, size=(b,)).astype(np.int32)
                             for k in ("center", "context")}),
        "lstm": dict(mesh={"data": n}, cfg=ls,
                     init=lambda c, b: lstm.init_numpy(c, 0, batch_size=b),
                     loss=lambda c, m: lstm.loss_fn(c), rules=lstm.SHARDING_RULES,
                     opt=optim.SGD(0.1),
                     per_chip=4, batch=lambda rng, b: _tokens(rng, b, 16, ls.vocab_size)),
        "transformer": dict(mesh=seq_mesh, cfg=lm, per_chip=2),
        "transformer_ulysses": dict(mesh=seq_mesh,
                                    cfg=dataclasses.replace(lm, attention="ulysses"),
                                    per_chip=2),
        "transformer_pp": dict(mesh={"data": n // 2, "pipe": 2}, cfg=pp, per_chip=2),
        "transformer_moe": dict(mesh={"data": n // 2, "expert": 2}, cfg=moe, per_chip=2),
    }


def _lm_defaults(w: dict) -> dict:
    cfg = w["cfg"]
    return dict(init=lambda c, b: transformer.init_numpy(c, 0),
                loss=lambda c, m: transformer.loss_fn(c, mesh=m),
                rules=transformer.sharding_rules(cfg), opt=optim.ClippedAdamW(1e-3, 1.0),
                batch=lambda rng, b: _tokens(rng, b), **w)


def step_account(name: str, w: dict, n: int) -> list:
    """One step of workload ``w`` on ``n`` thread ranks; each rank's
    records."""
    if name.startswith("transformer"):
        w = _lm_defaults(w)
    spec = ",".join(f"{a}={s}" for a, s in w["mesh"].items())
    row_shards = w["mesh"].get("data", 1) * w["mesh"].get("expert", 1)
    batch = w["batch"](np.random.default_rng(0), w["per_chip"] * row_shards)
    cfg = w["cfg"]
    init = w["init"](cfg, w["per_chip"])  # numpy; every rank copies it

    def rank(_r):
        mesh = build_mesh(MeshSpec.parse(spec), "cpu")
        rows = sharding.rank_rows(len(next(iter(batch.values()))), mesh.row_index,
                                  mesh.row_shards)
        local = {k: v[rows] for k, v in batch.items()}
        if mesh.shape.get("seq", 1) > 1:
            local = {k: sharding.seq_block(v, mesh.seq_index, mesh.shape["seq"])
                     for k, v in local.items()}
        loss = w["loss"](cfg, mesh)
        with mesh.axes():
            st, _specs = state.create_sharded_state(
                lambda s: init, w["opt"], 0, "cpu", mesh=mesh, rules=w["rules"])
        step = step_lib.build_train_step(loss, w["opt"], mesh=mesh)
        return hlo_analysis.step_collectives(
            step, st, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in local.items()})

    return collectives.ThreadRanks(n, timeout=300).run(rank)


def account(n: int) -> dict:
    """The twin of the JAX ``worker(n)``: {"n", "workloads": {name: {mesh,
    per_chip_batch, collectives (rank 0's summary by kind), by_tag (rank
    0's)}}}."""
    out: dict = {"n": n, "workloads": {}}
    for name, w in workloads(n).items():
        records = step_account(name, w, n)[0]
        out["workloads"][name] = {
            "mesh": w["mesh"], "per_chip_batch": w["per_chip"],
            "collectives": hlo_analysis.summarize(records),
            "by_tag": {tag: {k: {"count": v["count"], "bytes": v["bytes"]}
                             for k, v in kinds.items()}
                       for tag, kinds in hlo_analysis.by_tag(records).items()},
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="2,4")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for n in (int(x) for x in args.sizes.split(",")):
        res = account(n)
        print(f"## n = {n} simulated ranks (rank 0's step; bytes by the JAX hlo_analysis "
              "convention)")
        print("| workload | mesh | kind | count | MB | tags |")
        print("|---|---|---|---|---|---|")
        for name, r in res["workloads"].items():
            mesh = ",".join(f"{a}={s}" for a, s in r["mesh"].items())
            for kind, v in r["collectives"].items():
                if kind == "total":
                    continue
                tags = ", ".join(t for t, kinds in r["by_tag"].items() if kind in kinds)
                print(f"| {name} | {mesh} | {kind} | {v['count']} | {v['bytes'] / 1e6:.3f} "
                      f"| {tags} |")
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
