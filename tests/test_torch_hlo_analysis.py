"""The port's collective account (``utils/hlo_analysis.py``) against the
JAX package's HLO parser on the same meshes.

The JAX side compiles its step on ``local_mesh_for_testing`` and parses
the optimised HLO; the port runs the same step on
``collectives.ThreadRanks`` (one thread a rank, no process spawned) under
``record_collectives`` and reads every rank's records.  Each twin
asserts the JAX test's verdict for both packages, and where both name
the groups of a kind, that each of the port's groups is among the JAX
HLO's; both packages' numbers are in the assertion messages.

- unit twins of ``tests/test_hlo_sharding.py``'s
  ``test_parser_sees_known_collectives`` (the port issues the synthetic
  dump's collectives; ``summarize`` gives the parser's counts and bytes)
  and ``test_replica_group_parsing_forms`` (explicit, iota, transposed
  iota and source-target forms against the port's groups), a record
  made on another thread (autograd's, in a custom backward) landing on
  the rank that owns the group, and ``all_gather_object`` left out;
- W4 on ``data=4,model=2`` moves no tensor as large as a whole [V, D]
  table (vocab 20,000 x 128: 10 MB a table, 640 KB the all-gather bound;
  the JAX test's 100,000 would hold 400 MB of tables in this process),
  and its replicated control on ``data=8`` does all-reduce a table-sized
  gradient;
- Megatron TP on ``data=4,model=2`` gathers no whole weight, and its
  backward's sums over ``model`` are recorded;
- the MoE step on ``data=2,expert=4`` crosses the expert group by
  all-to-all, forward and backward, and gathers no expert weights (a
  routing group of 64 tokens on both sides, so a rank's two rows are
  whole groups);
- ghost BN on ``slice=2,data=4``: every BatchNorm all-reduce stays in
  its slice and only the gradient and metrics cross (part (a) of
  ``tests/test_models.py::test_resnet_ghost_bn_slice_local_stats_and_parity``).
"""

import threading

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu import train as jax_train
from distributed_tensorflow_examples_tpu.data.pipeline import as_global
from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.utils import hlo_analysis as jax_hlo
from distributed_tensorflow_examples_tpu_torch.models import resnet, transformer, word2vec
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import optim, state
from distributed_tensorflow_examples_tpu_torch.train import step as step_lib
from distributed_tensorflow_examples_tpu_torch.utils import hlo_analysis


def _jax_hlo(model_loss, mesh, rules, state_init, batch, batch_spec=None):
    """``tests/test_hlo_sharding.py::_compile_step`` with SGD 0.1."""
    opt = optax.sgd(0.1)
    st, shardings = jax_train.create_sharded_state(
        state_init, opt, jax.random.key(0), mesh=mesh, rules=rules)
    step = jax_train.build_train_step(model_loss, opt, mesh=mesh, state_shardings=shardings,
                                      batch_spec=batch_spec)
    return step.lower(st, as_global(batch, mesh, spec=batch_spec)).compile().as_text()


def _port_step(spec: str, n: int, init, loss, rules, batch):
    """One SGD 0.1 step of the port on ``n`` thread ranks of the ``spec``
    mesh from the numpy ``init``, each rank on its rows of ``batch``;
    every rank's records."""
    def rank(_r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(spec), "cpu")
        rows = sharding.rank_rows(len(next(iter(batch.values()))), mesh.row_index,
                                  mesh.row_shards)
        opt = optim.SGD(0.1)
        with mesh.axes():
            st, _specs = state.create_sharded_state(lambda s: init, opt, 0, "cpu", mesh=mesh,
                                                    rules=rules)
        step = step_lib.build_train_step(loss(mesh), opt, mesh=mesh)
        local = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}
        return hlo_analysis.step_collectives(step, st, local)

    return collectives.ThreadRanks(n, timeout=120).run(rank)


def _groups_among(port_records, jax_cs, kind: str, n: int) -> None:
    """Each of the port's groups of ``kind`` is one of the JAX HLO's groups
    of that kind (an absent attribute: one global group)."""
    jax_groups = []
    for c in jax_cs:
        if c.kind == kind:
            jax_groups += c.groups if c.groups is not None else [list(range(n))]
    for rec in port_records:
        if rec.kind == kind:
            for g in rec.groups:
                assert g in jax_groups, (kind, rec.tag, g, jax_groups)


# ----------------------------------------------------------------------------
# Unit twins
# ----------------------------------------------------------------------------


_KNOWN_HLO = """
  %ar = f32[1024,128]{1,0} all-reduce(f32[1024,128]{1,0} %x), replica_groups={}
  %ag.1 = bf16[64,64]{1,0} all-gather(bf16[32,64]{1,0} %y), dimensions={0}
  %cp = f32[8]{0} collective-permute(f32[8]{0} %z), source_target_pairs={{0,1}}
  %tup = (f32[16]{0}, f32[16]{0}) all-reduce(f32[16]{0} %a, f32[16]{0} %b)
  %done = f32[64,64]{1,0} all-gather-done(f32[64,64] %ag2)
"""


def test_account_sees_known_collectives():
    """The synthetic dump's collectives, issued by the port on 2 ranks: the
    same kinds, counts and bytes as the JAX parser reads from the dump (a
    flat bucket of two f32[16] is the variadic all-reduce)."""
    def rank(_r):
        with hlo_analysis.record_collectives() as recs:
            collectives.all_reduce_sum_(torch.zeros(1024, 128), tag="a")
            collectives.all_gather(torch.zeros(32, 64, dtype=torch.bfloat16), 0,
                                   axis_name="data", tag="b")
            collectives.permute_over(collectives.group("data"), torch.zeros(8), shift=1)
            with collectives.bucket([(16,), (16,)]):
                collectives.all_reduce_sum_(torch.zeros(32), tag="c")
        return recs

    recs = collectives.ThreadRanks(2).run(rank)[0]
    want = jax_hlo.summarize(jax_hlo.parse_collectives(_KNOWN_HLO))
    got = hlo_analysis.summarize(recs)
    assert sorted(c.kind for c in recs) == ["all-gather", "all-reduce", "all-reduce",
                                            "collective-permute"]
    assert got == want, (got, want)
    assert got["all-reduce"]["bytes"] == 1024 * 128 * 4 + 2 * 16 * 4
    assert got["all-gather"]["bytes"] == 64 * 64 * 2
    assert [c.shapes for c in recs] == [["f32[1024,128]"], ["bf16[64,64]"], ["f32[8]"],
                                        ["f32[16]", "f32[16]"]]
    assert hlo_analysis.max_tensor_bytes(recs) == jax_hlo.max_tensor_bytes(_KNOWN_HLO)
    assert hlo_analysis.max_collective_bytes(recs, "all-reduce") == \
        jax_hlo.max_collective_bytes(_KNOWN_HLO, "all-reduce")


_FORMS_HLO = """
  %a = f32[8]{0} all-reduce(f32[8]{0} %x), replica_groups={{0,1}, {2,3}}
  %b = f32[8]{0} all-gather(f32[8]{0} %y), replica_groups=[2,4]<=[8], dimensions={0}
  %c = f32[8]{0} all-reduce(f32[8]{0} %z), replica_groups=[4,2]<=[2,4]T(1,0)
  %d = f32[8]{0} collective-permute(f32[8]{0} %w), source_target_pairs={{0,4},{1,5}}
  %e = f32[8]{0} all-reduce(f32[8]{0} %v)
"""


def test_account_groups_match_replica_group_forms():
    """The JAX parser's group forms against the port's groups on the same
    device numbering: ``data=2,model=4`` (model innermost) gives model
    groups {0..3}, {4..7} (the iota form) and data groups {r, r + 4} (the
    transposed iota); ``data=4,model=2`` model groups {0,1}, {2,3}
    (explicit); a ring step over data sends r to r + 4 (the source-target
    pairs); the world is the one global group (no attribute)."""
    cs = jax_hlo.parse_collectives(_FORMS_HLO)

    def rank(_r, spec):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(spec), "cpu")
        with hlo_analysis.record_collectives() as recs:
            with mesh.axes():
                collectives.all_reduce_sum_(torch.zeros(8), tag="model", axis_name="model")
                if spec == "data=2,model=4":
                    collectives.all_gather(torch.zeros(2), 0, axis_name="model", tag="gather")
                    collectives.all_reduce_sum_(torch.zeros(8), tag="data")
                    collectives.ring_permute(torch.zeros(8), "data", shift=1)
            if spec == "data=2,model=4":  # no mesh installed: the world
                collectives.all_reduce_sum_(torch.zeros(8), tag="world")
        return mesh.model_index, recs

    four = collectives.ThreadRanks(4).run(lambda r: rank(r, "data=2,model=2"))
    for _m, recs in four:
        assert recs[0].groups[0] in cs[0].groups, (recs[0].groups, cs[0].groups)
    eight = collectives.ThreadRanks(8).run(lambda r: rank(r, "data=2,model=4"))
    for m, recs in eight:
        model_ar, gather, data_ar, permute, world = recs
        assert gather.groups[0] in cs[1].groups and model_ar.groups[0] in cs[1].groups
        assert data_ar.groups[0] in cs[2].groups, (data_ar.groups, cs[2].groups)
        if m < 2:  # the pairs the dump names: model indices 0 and 1
            assert [m, m + 4] in permute.groups and [m, m + 4] in cs[3].groups
        assert permute.groups == [[m, m + 4], [m + 4, m]]
        assert cs[4].groups is None and world.groups == [list(range(8))]


def test_account_attributes_by_group_across_threads():
    """A custom backward's sum run from another thread (as autograd's
    thread runs a CUDA backward) lands on the rank whose group made it;
    ``all_gather_object`` (a pickled host object) is not recorded, nor is
    anything outside the block; nested recorders both see a record."""
    def rank(_r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=1,model=2"), "cpu")
        x = torch.ones(3, 4, requires_grad=True)
        with mesh.axes():
            y = collectives.copy_to_model(x)
        with hlo_analysis.record_collectives() as outer:
            with hlo_analysis.record_collectives() as inner:
                worker = threading.Thread(target=lambda: y.sum().backward())
                worker.start()
                worker.join(timeout=30)
            collectives.all_gather_object(1)
        collectives.all_reduce_sum_(torch.zeros(2))
        return mesh.model_index, outer, inner

    for m, outer, inner in collectives.ThreadRanks(2).run(rank):
        assert [(c.kind, c.tag, c.groups) for c in outer] == \
            [("all-reduce", "model_bwd", [[0, 1]])], (m, outer)
        assert outer == inner
    assert not collectives.RECORDERS


# ----------------------------------------------------------------------------
# Twins of the HLO tests
# ----------------------------------------------------------------------------


def _w4_batch(vocab: int, b: int) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, size=(b,)).astype(np.int32) for k in ("center", "context")}


def test_word2vec_sharded_table_no_full_tensor_twin():
    """``test_word2vec_sharded_table_no_full_allgather`` at vocab 20,000:
    per tensor nothing larger than a [V/2, D] shard crosses the mesh, and
    no all-gather comes near a table, in both packages."""
    vocab, dim, b = 20_000, 128, 256
    table, shard = vocab * dim * 4, vocab * dim * 4 // 2
    jcfg = jax_models.word2vec.Config(vocab_size=vocab, dim=dim)
    hlo = _jax_hlo(jax_models.word2vec.loss_fn(jcfg), local_mesh_for_testing({"data": 4, "model": 2}),
                   jax_models.word2vec.SHARDING_RULES,
                   lambda r: jax_models.word2vec.init(jcfg, r), _w4_batch(vocab, b))
    cs = jax_hlo.parse_collectives(hlo)
    cfg = word2vec.Config(vocab_size=vocab, dim=dim)
    ranks = _port_step("data=4,model=2", 8, word2vec.init_numpy(cfg, 0),
                       lambda m: word2vec.loss_fn(cfg), word2vec.SHARDING_RULES,
                       _w4_batch(vocab, b))
    both = {"jax": (jax_hlo.max_tensor_bytes(hlo), jax_hlo.max_tensor_bytes(hlo, "all-gather")),
            "port": [(hlo_analysis.max_tensor_bytes(r), hlo_analysis.max_tensor_bytes(r, "all-gather"))
                     for r in ranks]}
    assert cs and all(ranks), both
    assert both["jax"][0] <= shard and both["jax"][1] < table // 16, both
    assert all(big <= shard and ag < table // 16 for big, ag in both["port"]), both
    for recs in ranks:
        _groups_among(recs, cs, "all-reduce", 8)


def test_word2vec_replicated_mesh_control_twin():
    """``test_word2vec_replicated_mesh_differs``: on ``data=8`` the tables
    are replicated and their gradient's all-reduce is table-sized in both
    packages (the account could fail the test above)."""
    vocab, dim, b = 10_000, 64, 128
    table = vocab * dim * 4
    jcfg = jax_models.word2vec.Config(vocab_size=vocab, dim=dim)
    hlo = _jax_hlo(jax_models.word2vec.loss_fn(jcfg), local_mesh_for_testing({"data": 8}),
                   jax_models.word2vec.SHARDING_RULES,
                   lambda r: jax_models.word2vec.init(jcfg, r), _w4_batch(vocab, b))
    cfg = word2vec.Config(vocab_size=vocab, dim=dim)
    ranks = _port_step("data=8", 8, word2vec.init_numpy(cfg, 0), lambda m: word2vec.loss_fn(cfg),
                       word2vec.SHARDING_RULES, _w4_batch(vocab, b))
    got = {"jax": jax_hlo.max_collective_bytes(hlo, "all-reduce"),
           "port": [hlo_analysis.max_collective_bytes(r, "all-reduce") for r in ranks]}
    assert got["jax"] >= table // 4 and all(x >= table // 4 for x in got["port"]), got
    for recs in ranks:
        _groups_among(recs, jax_hlo.parse_collectives(hlo), "all-reduce", 8)


def _lm_batch(vocab: int, b: int, t: int) -> dict:
    toks = np.random.default_rng(0).integers(0, vocab, size=(b, t + 1)).astype(np.int32)
    return {"x": toks[:, :-1], "y": toks[:, 1:]}


def test_transformer_megatron_no_full_weight_twin():
    """``test_transformer_megatron_no_full_weight_movement``: no all-gather
    as large as the embedding, no collective above the logits' size, in
    both packages; the backward's sums over ``model`` (a custom
    backward's) are in the port's account, over the model groups."""
    kw = dict(vocab_size=8192, dim=256, n_layers=2, n_heads=8, max_seq_len=128,
              compute_dtype="float32", attention="xla")
    b, t = 8, 128
    emb = kw["vocab_size"] * kw["dim"] * 4
    jcfg = jax_models.transformer.Config(**kw)
    jmesh = local_mesh_for_testing({"data": 4, "model": 2})
    hlo = _jax_hlo(jax_models.transformer.loss_fn(jcfg, mesh=jmesh), jmesh,
                   jax_models.transformer.SHARDING_RULES,
                   lambda r: jax_models.transformer.init(jcfg, r), _lm_batch(8192, b, t))
    cfg = transformer.Config(**kw)
    ranks = _port_step("data=4,model=2", 8, transformer.init_numpy(cfg, 0),
                       lambda m: transformer.loss_fn(cfg, mesh=m), transformer.SHARDING_RULES,
                       _lm_batch(8192, b, t))
    bound = max(emb, b * t * kw["vocab_size"] * 4)
    got = {"jax": (jax_hlo.max_collective_bytes(hlo, "all-gather"),
                   jax_hlo.max_collective_bytes(hlo)),
           "port": [(hlo_analysis.max_collective_bytes(r, "all-gather"),
                     hlo_analysis.max_collective_bytes(r)) for r in ranks]}
    assert got["jax"][0] < emb and got["jax"][1] <= bound, got
    assert all(ag < emb and big <= bound for ag, big in got["port"]), got
    for r, recs in enumerate(ranks):
        tags = hlo_analysis.by_tag(recs)
        assert tags["model_bwd"]["all-reduce"]["groups"] == [[[r // 2 * 2, r // 2 * 2 + 1]]], tags
        _groups_among(recs, jax_hlo.parse_collectives(hlo), "all-reduce", 8)


def test_moe_dispatch_is_all_to_all_twin():
    """``test_moe_dispatch_lowers_to_all_to_all`` on ``data=2,expert=4``:
    all-to-alls exist (over the expert group, forward and backward, in the
    port) and no all-gather as large as the stacked expert weights."""
    kw = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, max_seq_len=64,
              compute_dtype="float32", attention="xla", moe_experts=8, moe_group_size=64)
    b, t = 16, 64
    full_w1 = kw["moe_experts"] * kw["dim"] * 4 * kw["dim"] * 4
    jcfg = jax_models.transformer.Config(**kw)
    jmesh = local_mesh_for_testing({"data": 2, "expert": 4})
    hlo = _jax_hlo(jax_models.transformer.loss_fn(jcfg, mesh=jmesh), jmesh,
                   jax_models.transformer.sharding_rules(jcfg),
                   lambda r: jax_models.transformer.init(jcfg, r), _lm_batch(512, b, t),
                   batch_spec=jax_models.transformer.batch_spec(jcfg))
    cs = jax_hlo.parse_collectives(hlo)
    cfg = transformer.Config(**kw)
    ranks = _port_step("data=2,expert=4", 8, transformer.init_numpy(cfg, 0),
                       lambda m: transformer.loss_fn(cfg, mesh=m), transformer.sharding_rules(cfg),
                       _lm_batch(512, b, t))
    got = {"jax": (jax_hlo.summarize(cs), jax_hlo.max_tensor_bytes(hlo, "all-gather")),
           "port": [(hlo_analysis.summarize(r), hlo_analysis.max_tensor_bytes(r, "all-gather"))
                    for r in ranks]}
    assert "all-to-all" in got["jax"][0] and got["jax"][1] < full_w1, got
    for r, (summary, ag) in enumerate(got["port"]):
        assert "all-to-all" in summary and ag < full_w1, got
        # Two a layer forward (dispatch, combine) and their backward's two.
        assert summary["all-to-all"]["count"] == 4 * kw["n_layers"], summary
        expert = [c for c in ranks[r] if c.kind == "all-to-all"]
        assert all(c.groups == [[r // 4 * 4 + i for i in range(4)]] for c in expert), expert
    for recs in ranks:
        _groups_among(recs, cs, "all-to-all", 8)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ghost_bn_no_statistics_all_reduce_crosses_slices_twin(fused):
    """Part (a) of ``test_resnet_ghost_bn_slice_local_stats_and_parity``
    on ``slice=2,data=4`` (slice = device // 4): slice-local all-reduces
    exist (the BatchNorm statistics), and those that cross the slices
    are few (the gradient and the metrics), in both packages; in the
    port no BatchNorm all-reduce crosses a slice."""
    kw = dict(num_classes=10, stage_sizes=(1,), width=8, compute_dtype="float32",
              bn_ghost_slices=2)
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, size=(16,)).astype(np.int32)}
    jcfg = jax_models.resnet.Config(**kw)
    jmesh = local_mesh_for_testing({"slice": 2, "data": 4})
    hlo = _jax_hlo(jax_models.resnet.loss_fn(jcfg, l2=0.0), jmesh,
                   jax_models.resnet.sharding_rules(jcfg),
                   lambda r: jax_models.resnet.init(jcfg, r), batch, batch_spec=JP(("slice", "data")))
    cs = jax_hlo.parse_collectives(hlo)
    cfg = resnet.Config(**kw)
    init = resnet.init_numpy(cfg, 0)
    ranks = _port_step("slice=2,data=4", 8, init,
                       lambda m: resnet.loss_fn(cfg, l2=0.0, mesh=m if fused else None),
                       resnet.sharding_rules(cfg), batch)

    def split(groups_of):
        local = crossing = 0
        for groups in groups_of:
            if any(len({d // 4 for d in g}) > 1 for g in groups):
                crossing += 1
            else:
                local += 1
        return local, crossing

    n_params = len(jax.tree_util.tree_leaves(init[0]))
    jax_split = split(c.groups or [list(range(8))] for c in cs if c.kind == "all-reduce")
    port_split = [split(c.groups for c in r if c.kind == "all-reduce") for r in ranks]
    msg = {"jax": jax_split, "port": port_split, "params": n_params}
    assert jax_split[0] >= 8 and 1 <= jax_split[1] <= n_params + 4, msg
    assert all(local >= 8 and 1 <= crossing <= n_params + 4 for local, crossing in port_split), msg
    for r, recs in enumerate(ranks):
        bn = [c for c in recs if c.kind == "all-reduce" and c.tag not in ("grads", "metrics")]
        assert bn and all(c.groups == [[r // 4 * 4 + i for i in range(4)]] for c in bn), bn
        _groups_among(recs, cs, "all-reduce", 8)
