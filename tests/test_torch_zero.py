"""ZeRO-1 in the port (``--zero_opt``): the optimizer slots of the big
replicated leaves hold only each data rank's block
(``train/state.py::create_sharded_state``, ``train/optim.py::
ShardedOptState``), against JAX ``_zero_shard_opt`` and
``tests/test_sharding.py::test_zero_opt_sharding_parity_and_layout``'s
MLP and Adam.

Simulated ranks (``collectives.ThreadRanks``) run the port's train step:

- the layout: which slots are sharded, and along which dim, as JAX's
  ``create_sharded_state(..., zero_opt_sharding=True)`` lays them out on a
  mesh of the same data degree;
- the numbers: 5 AdamW steps of the MLP on two ranks with ZeRO-1 (the
  port's ``ClippedAdamW``, its clip never engaged) against the JAX run of
  ``optax.chain(clip_by_global_norm, adamw)`` on a ``data=2`` mesh
  (losses within the JAX test's rtol 1e-5, atol 1e-6: the two packages'
  float32 Adam and matmuls round apart) and
  against the port's replicated run (every parameter and slot bit for bit:
  the update is elementwise, the all-reduce is the same, and the
  all-gather copies);
- each rank's optimizer bytes (every tensor it holds beyond the
  parameters), half of every sharded slot and nothing more;
- a restore that copies parameters into the leaves, which the next
  ZeRO-1 step starts from;
- the state dict of a ZeRO-1 state holds the global slots, the replicated
  optimizer's layout, and loads back into either layout;
- ZeRO-1 beside a ``model`` axis: the PTB LSTM at ``data=2,model=2`` on 4
  ranks, its clip engaged, against the replicated run on one rank over the
  global rows (1e-6 absolute, the float32 order of the two row halves'
  gradient sums).
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_examples_tpu import models as jax_models
from distributed_tensorflow_examples_tpu.parallel.mesh import local_mesh_for_testing
from distributed_tensorflow_examples_tpu.train import state as jax_state
from distributed_tensorflow_examples_tpu.train import step as jax_step
from distributed_tensorflow_examples_tpu_torch import bridge
from distributed_tensorflow_examples_tpu_torch.models import lstm, mlp
from distributed_tensorflow_examples_tpu_torch.parallel import collectives, sharding
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_examples_tpu_torch.train import optim, state
from distributed_tensorflow_examples_tpu_torch.train import step as step_lib

HIDDEN = (128, 128)
LR = 1e-2


def _batches(n=5, rows=64):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(size=(rows, 784)).astype(np.float32),
             "label": rng.integers(0, 10, size=(rows,)).astype(np.int32)} for _ in range(n)]


#: The port's AdamW with a clip that never engages: optax.chain(clip, adamw).
CLIP = 1e6


def _adam():
    return optim.ClippedAdamW(LR, CLIP)


def _jax_adam():
    return optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))


def _port_run(data, zero, min_elements=1024, steps=5):
    """Each rank's (losses, params, opt specs, slot bytes, state dict)."""
    cfg = mlp.Config(hidden=HIDDEN, compute_dtype="float32")
    batches = _batches(steps)

    def rank(r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(f"data={data}"), "cpu")
        opt = _adam()
        st, specs = state.create_sharded_state(
            lambda seed: mlp.init_numpy(cfg, seed), opt, 0, "cpu", mesh=mesh,
            zero_opt_sharding=zero, zero_min_elements=min_elements)
        f = step_lib.build_train_step(mlp.loss_fn(cfg), opt, mesh=mesh)
        losses = []
        for b in batches:
            rows = sharding.rank_rows(len(b["label"]), mesh.data_index, data)
            st, m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
            losses.append(float(m["loss"]))
        return (losses, [p.detach().clone() for p in state.leaves(st.params)],
                specs["opt_state"], optim.state_bytes(st.opt_state), st.opt_state.state_dict())

    return collectives.ThreadRanks(data).run(rank)


def _jax_layout(data, min_elements):
    """JAX's ZeRO-1 layout of Adam's first moment (the slots' shapes, and
    so their layout, are AdamW's too)."""
    mesh = local_mesh_for_testing({"data": data})
    cfg = jax_models.mlp.Config(hidden=HIDDEN, compute_dtype="float32")
    _st, sh = jax_state.create_sharded_state(
        lambda r: jax_models.mlp.init(cfg, r), optax.adam(LR), jax.random.key(0),
        mesh=mesh, rules=(), zero_opt_sharding=True, zero_min_elements=min_elements)
    mu = sh.opt_state[0].mu
    return {"/".join(str(k.key) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(mu)[0]}


@pytest.mark.parametrize("data,min_elements", [(2, 1024), (2, 65536), (4, 1024), (8, 100)])
def test_zero_layout_matches_jax(data, min_elements):
    ours = _port_run(data, True, min_elements, steps=1)[0][2]
    got = {p: tuple(s) for p, s in bridge._leaves(ours)}
    assert got == _jax_layout(data, min_elements)
    assert any("data" in s for s in got.values()) == (min_elements <= 784 * 128)


def test_zero_matches_jax_adam_and_the_replicated_step_bit_for_bit():
    zero, rep = _port_run(2, True), _port_run(2, False)
    # JAX: the same MLP, Adam and batches on a data=2 mesh with ZeRO-1.
    mesh = local_mesh_for_testing({"data": 2})
    cfg = jax_models.mlp.Config(hidden=HIDDEN, compute_dtype="float32")
    st, sh = jax_state.create_sharded_state(
        lambda r: jax_models.mlp.init(cfg, r), _jax_adam(), jax.random.key(0),
        mesh=mesh, rules=(), zero_opt_sharding=True, zero_min_elements=1024)
    stepper = jax_step.build_train_step(jax_models.mlp.loss_fn(cfg), _jax_adam(), mesh=mesh,
                                        state_shardings=sh)
    want = []
    for b in _batches():
        st, m = stepper(st, jax.device_put(b, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("data"))))
        want.append(float(m["loss"]))
    for r in range(2):
        np.testing.assert_allclose(zero[r][0], want, rtol=1e-5, atol=1e-6)
        assert zero[r][0] == rep[r][0]
        for a, b in zip(zero[r][1], rep[r][1], strict=True):
            assert torch.equal(a, b)
        # Each rank's slot bytes: half of each sharded leaf's two moments.
        leaves = [p for p in rep[r][1]]
        specs = list(state.leaves(zero[r][2]))
        half = sum(p.numel() * 4 * 2 // (2 if "data" in s else 1) for p, s in zip(leaves, specs))
        steps_bytes = zero[r][3] - half
        assert steps_bytes == rep[r][3] - sum(p.numel() * 4 * 2 for p in leaves)
        assert zero[r][3] < 0.55 * rep[r][3]
    # The state dict holds the global slots: the replicated optimizer's.
    for k, slots in rep[0][4]["state"].items():
        for name, v in slots.items():
            assert torch.equal(zero[0][4]["state"][k][name], v), (k, name)


def test_zero_state_dict_loads_into_either_layout():
    cfg = mlp.Config(hidden=HIDDEN, compute_dtype="float32")
    b0, b1 = _batches(2)
    saved = _port_run(2, False, steps=1)[0][4]  # replicated, after one step

    def rank(r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2"), "cpu")
        out = []
        for zero in (True, False):
            opt = _adam()
            st, _specs = state.create_sharded_state(
                lambda seed: mlp.init_numpy(cfg, seed), opt, 0, "cpu", mesh=mesh,
                zero_opt_sharding=zero, zero_min_elements=1024)
            f = step_lib.build_train_step(mlp.loss_fn(cfg), opt, mesh=mesh)
            rows = sharding.rank_rows(64, mesh.data_index, 2)
            st, _m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b0.items()})
            st.opt_state.load_state_dict(copy.deepcopy(saved))  # torch keeps the tensors
            assert all(torch.equal(st.opt_state.state_dict()["state"][k][n], v)
                       for k, s in saved["state"].items() for n, v in s.items())
            st, m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b1.items()})
            out.append((float(m["loss"]), [p.detach().clone() for p in state.leaves(st.params)]))
        return out

    for (lz, pz), (lr, pr) in collectives.ThreadRanks(2).run(rank):
        assert lz == lr
        assert all(torch.equal(a, b) for a, b in zip(pz, pr, strict=True))


def test_zero_steps_on_from_parameters_restored_in_place():
    """A checkpoint's restore copies the saved parameters into the leaves
    (``CheckpointManager.restore``) and loads the global slots: the next
    ZeRO-1 step must start from those parameters, with the optimizer
    updating views of them, not copies it made before the restore."""
    cfg = mlp.Config(hidden=HIDDEN, compute_dtype="float32")
    b0, b1 = _batches(2)
    want = _port_run(2, False, steps=2)

    def rank(r):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2"), "cpu")
        rows = sharding.rank_rows(64, mesh.data_index, 2)
        local = [{k: torch.from_numpy(v[rows]) for k, v in b.items()} for b in (b0, b1)]
        states = []
        for _ in range(2):
            opt = _adam()
            st, _specs = state.create_sharded_state(
                lambda seed: mlp.init_numpy(cfg, seed), opt, 0, "cpu", mesh=mesh,
                zero_opt_sharding=True, zero_min_elements=1024)
            states.append((st, step_lib.build_train_step(mlp.loss_fn(cfg), opt, mesh=mesh)))
        (first, f), (resumed, g) = states
        first, _m = f(first, local[0])
        with torch.no_grad():
            for p, saved in zip(state.leaves(resumed.params), state.leaves(first.params)):
                p.copy_(saved)
        resumed.opt_state.load_state_dict(first.opt_state.state_dict())
        resumed.step = first.step
        resumed, m = g(resumed, local[1])
        return float(m["loss"]), [p.detach().clone() for p in state.leaves(resumed.params)]

    for r, (loss, params) in enumerate(collectives.ThreadRanks(2).run(rank)):
        assert loss == want[r][0][1]
        assert all(torch.equal(a, b) for a, b in zip(params, want[r][1], strict=True))


def test_zero_beside_the_model_axis_with_the_clip_matches_one_rank():
    cfg = lstm.Config(vocab_size=64, dim=16, num_layers=2, compute_dtype="float32")
    rng = np.random.default_rng(1)
    batches = [{"x": rng.integers(0, 64, (8, 5)).astype(np.int32),
                "y": rng.integers(0, 64, (8, 5)).astype(np.int32)} for _ in range(3)]
    opt_fn = lambda: optim.SGD(1.0, clip_norm=0.05)  # noqa: E731

    def run(text, rows_of, zero):
        def rank(r):
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(text), "cpu")
            d = mesh.shape["data"]
            opt = opt_fn()
            st, specs = state.create_sharded_state(
                lambda seed: lstm.init_numpy(cfg, seed, batch_size=8 // d), opt, 1, "cpu",
                mesh=mesh, rules=lstm.SHARDING_RULES, zero_opt_sharding=zero,
                zero_min_elements=1024)
            f = step_lib.build_train_step(lstm.loss_fn(cfg), opt, mesh=mesh)
            losses = []
            for b in batches:
                rows = rows_of(mesh)
                st, m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
                losses.append(float(m["loss"]))
            got = {p: t.detach().clone() for p, t in bridge._leaves(st.params)}
            return losses, got, specs, mesh.model_index
        return rank

    one = collectives.ThreadRanks(1).run(run("", lambda m: slice(None), False))[0]
    four = collectives.ThreadRanks(4).run(
        run("data=2,model=2", lambda m: sharding.rank_rows(8, m.data_index, 2), True))
    specs = four[0][2]
    assert any("data" in s for s in state.leaves(specs["opt_state"]))  # the cells' slots
    for losses, _p, _s, _m in four:
        np.testing.assert_allclose(losses, one[0], rtol=0, atol=1e-6)
    by_model = sorted(four[:2], key=lambda x: x[3])  # data index 0's two model ranks
    for path, want in one[1].items():
        spec = dict(bridge._leaves(specs["params"]))[path]
        blocks = [x[1][path] for x in by_model]
        got = torch.cat(blocks, dim=spec.index("model")) if "model" in spec else blocks[0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=path)


def test_zero_on_an_expert_mesh_is_the_replicated_run_bit_for_bit():
    """ZeRO-1 on ``data=2,expert=2``: the replicated leaves' slots chunk over
    the 4 row shards (data x expert; here the position table, the one
    leaf no rule names), the experts stay rule-sharded, and
    two AdamW steps of a tiny MoE transformer equal the run without it,
    every loss and parameter bit for bit."""
    from distributed_tensorflow_examples_tpu_torch.models import transformer

    cfg = transformer.Config(vocab_size=64, dim=32, n_layers=1, n_heads=2, max_seq_len=8,
                             compute_dtype="float32", attention="xla", moe_experts=4,
                             moe_group_size=8)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        xy = rng.integers(0, 64, size=(8, 9)).astype(np.int32)
        batches.append({"x": xy[:, :-1], "y": xy[:, 1:]})

    def run(zero):
        def rank(_r):
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2,expert=2"), "cpu")
            opt = optim.ClippedAdamW(LR, 1.0)
            st, specs = state.create_sharded_state(
                lambda seed: transformer.init_numpy(cfg, seed), opt, 0, "cpu", mesh=mesh,
                rules=transformer.sharding_rules(cfg), zero_opt_sharding=zero,
                zero_min_elements=256)
            f = step_lib.build_train_step(transformer.loss_fn(cfg, mesh=mesh), opt, mesh=mesh)
            rows = sharding.rank_rows(8, mesh.row_index, mesh.row_shards)
            losses = []
            for b in batches:
                st, m = f(st, {k: torch.from_numpy(v[rows]) for k, v in b.items()})
                losses.append(float(m["loss"]))
            return losses, [p.detach().clone() for p in state.leaves(st.params)], specs
        return collectives.ThreadRanks(4).run(rank)

    zero, rep = run(True), run(False)
    opt_specs = state.leaves(zero[0][2]["opt_state"])
    assert ("data", "expert") in {e for s in opt_specs for e in s}  # the row shards' chunks
    assert any("expert" in s for s in state.leaves(zero[0][2]["params"]))
    for (lz, pz, _s), (lr, pr, _r) in zip(zero, rep):
        assert lz == lr
        assert all(torch.equal(a, b) for a, b in zip(pz, pr, strict=True))
