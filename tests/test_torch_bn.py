"""The port's BatchNorm statistics and batchnorm layer against the JAX
package's, at small size on the CPU.

The JAX side runs ``ops/bn.py``'s Pallas kernels in interpret mode, called
directly (``bn_stats``, ``bn_bwd_stats``) and through ``layers.batchnorm``
with a one-device ``Mesh`` and ``bn_ops.FORCE_PALLAS``; the port's
wrappers take their plain versions on CPU tensors.  The same numpy inputs
go to both.

Tolerances.  The statistics are f32 sums of the same terms in another
order: 1e-6 of the per-channel sum of magnitudes (f32 has 2^-24 = 6e-8;
a few hundred terms per channel).  The layer in f32: y and new stats
1e-5, gradients 1e-4 relative to the largest entry (seen under 1e-5).  In
bf16 both sides round y to bf16 after the same f32 statistics: y within
one bf16 step (2^-7 relative to |y| <= 4: 3e-2), new stats 1e-5; the
fused path's gradients 1e-2 relative (s1, s2 are exact f32 sums on both
sides and dx rounds in bf16 at the same places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_tensorflow_examples_tpu.models import layers as jax_layers
from distributed_tensorflow_examples_tpu.ops import bn as jax_bn
from distributed_tensorflow_examples_tpu_torch.models import layers
from distributed_tensorflow_examples_tpu_torch.ops import bn
from distributed_tensorflow_examples_tpu_torch.parallel import collectives
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

SHAPE = (4, 6, 5, 24)  # C = 24: not a multiple of the kernel's 8-wide loads
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=SHAPE) * 2 + 0.5).astype(np.float32)
    do = rng.normal(size=SHAPE).astype(np.float32)
    # Round through the dtype once so both sides start from the same values.
    x = np.array(jnp.asarray(x, _JDT[dtype]).astype(jnp.float32))
    do = np.array(jnp.asarray(do, _JDT[dtype]).astype(jnp.float32))
    return x, do


def _vecs(x):
    c = x.shape[-1]
    xf = x.reshape(-1, c)
    mean = xf.mean(0).astype(np.float32)
    inv = (1.0 / np.sqrt(xf.var(0) + 1e-5)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, c, dtype=np.float32)
    bias = np.linspace(-1.0, 1.0, c, dtype=np.float32)
    return mean, inv, scale, bias


def _close_per_channel(got, want, magnitude, tol=1e-6):
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    rel = np.abs(got - want) / np.maximum(magnitude, 1e-30)
    assert rel.max() <= tol, f"max per-channel relative error {rel.max():.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_plain_matches_the_jax_kernel(dtype):
    x, _ = _inputs(dtype)
    js, jss = jax_bn.bn_stats(jnp.asarray(x, _JDT[dtype]))
    ts, tss = bn.bn_stats(torch.from_numpy(x).to(_TDT[dtype]))
    assert tuple(ts.shape) == tuple(js.shape) == (1, SHAPE[-1])
    assert ts.dtype == torch.float32
    xf = x.reshape(-1, SHAPE[-1])
    _close_per_channel(ts.numpy(), js, np.abs(xf).sum(0))
    _close_per_channel(tss.numpy(), jss, (xf * xf).sum(0))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_bwd_stats_plain_matches_the_jax_kernel(dtype, relu):
    x, do = _inputs(dtype, seed=1)
    mean, inv, scale, bias = _vecs(x)
    jvec = [jnp.asarray(v)[None] for v in (mean, inv, scale, bias)]
    j1, j2 = jax_bn.bn_bwd_stats(
        jnp.asarray(do, _JDT[dtype]), jnp.asarray(x, _JDT[dtype]), *jvec, relu=relu
    )
    t1, t2 = bn.bn_bwd_stats(
        torch.from_numpy(do).to(_TDT[dtype]), torch.from_numpy(x).to(_TDT[dtype]),
        *(torch.from_numpy(v)[None] for v in (mean, inv, scale, bias)), relu=relu,
    )
    c = SHAPE[-1]
    dof = do.reshape(-1, c)
    xhat = (x.reshape(-1, c) - mean) * inv
    _close_per_channel(t1.numpy(), j1, np.abs(dof).sum(0))
    _close_per_channel(t2.numpy(), j2, np.abs(dof * xhat).sum(0))
    if relu:  # the mask did something
        t1_all, _ = bn.bn_bwd_stats_plain(
            torch.from_numpy(do), torch.from_numpy(x),
            *(torch.from_numpy(v) for v in (mean, inv, scale, bias)), relu=False,
        )
        assert not torch.allclose(t1_all, t1.to(torch.float32))


def _jax_batchnorm(x, params, stats, w, *, train, relu, use_mesh, impl="pallas"):
    """(y, new_stats, grads of (params, x)) of the JAX layer under loss
    sum(y * w)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",)) if use_mesh else None

    def f(p, xx):
        y, ns = jax_layers.batchnorm(p, stats, xx, train=train, mesh=mesh, relu=relu)
        return jnp.sum(y.astype(jnp.float32) * w), (y, ns)

    old = jax_bn.FORCE_PALLAS, jax_bn.IMPL
    jax_bn.FORCE_PALLAS, jax_bn.IMPL = use_mesh, impl
    try:
        (_, (y, ns)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    finally:
        jax_bn.FORCE_PALLAS, jax_bn.IMPL = old
    return y, ns, gp, gx


def _port_batchnorm(x, params, stats, w, *, train, relu, use_mesh, impl="kernel"):
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=1"), "cpu") if use_mesh else None
    p = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in params.items()}
    s = {k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()}
    xx = torch.tensor(np.asarray(x.astype(jnp.float32))).to(_TDT[str(x.dtype)])
    xx.requires_grad_(True)
    old = bn.IMPL
    bn.IMPL = impl
    try:
        y, ns = layers.batchnorm(p, s, xx, train=train, mesh=mesh, relu=relu)
        (y.to(torch.float32) * torch.from_numpy(np.asarray(w))).sum().backward()
    finally:
        bn.IMPL = old
    return y, ns, {k: v.grad for k, v in p.items()}, xx.grad


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


CASES = [
    # (path, relu, train, dtype)
    ("mesh", True, True, "float32"),
    ("mesh", False, True, "float32"),
    ("plain", True, True, "float32"),
    ("plain", False, True, "float32"),
    ("mesh", True, False, "float32"),
    ("plain", False, False, "float32"),
    ("ghost_stats", True, False, "float32"),
    ("mesh", True, True, "bfloat16"),
    ("mesh", False, True, "bfloat16"),
]


@pytest.mark.parametrize("path,relu,train,dtype", CASES)
def test_batchnorm_matches_jax(path, relu, train, dtype):
    x, w = _inputs(dtype, seed=2)
    c = SHAPE[-1]
    params = {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
              "bias": np.linspace(-1.0, 1.0, c, dtype=np.float32)}
    rng = np.random.default_rng(3)
    shape = (3, c) if path == "ghost_stats" else (c,)
    stats = {"mean": rng.normal(size=shape).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=shape).astype(np.float32)}
    jx = jnp.asarray(x, _JDT[dtype])
    use_mesh = path == "mesh"
    jy, jns, jgp, jgx = _jax_batchnorm(jx, params, stats, w, train=train, relu=relu,
                                       use_mesh=use_mesh)
    ty, tns, tgp, tgx = _port_batchnorm(jx, params, stats, w, train=train, relu=relu,
                                        use_mesh=use_mesh)
    assert ty.dtype == _TDT[dtype] and tuple(ty.shape) == SHAPE
    assert ty.is_contiguous()
    y_tol = 3e-2 if dtype == "bfloat16" else 1e-5
    assert _rel(ty.detach().to(torch.float32).numpy(), jy.astype(jnp.float32)) <= y_tol
    for k in ("mean", "var"):
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]), rtol=1e-5, atol=1e-5)
        assert not tns[k].requires_grad
    g_tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for k in ("scale", "bias"):
        assert _rel(tgp[k].numpy(), jgp[k]) <= g_tol, k
    assert _rel(tgx.to(torch.float32).numpy(), jnp.asarray(jgx, jnp.float32)) <= g_tol


@pytest.mark.parametrize("relu", [True, False])
def test_batchnorm_matmul_impl_matches_jax(relu):
    """IMPL="matmul" (the reference's contraction forms, plain torch ops
    here) on both sides, through the mesh path."""
    x, w = _inputs("float32", seed=4)
    c = SHAPE[-1]
    params = {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
              "bias": np.linspace(-1.0, 1.0, c, dtype=np.float32)}
    stats = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    jx = jnp.asarray(x)
    jy, jns, jgp, jgx = _jax_batchnorm(jx, params, stats, w, train=True, relu=relu,
                                       use_mesh=True, impl="matmul")
    ty, tns, tgp, tgx = _port_batchnorm(jx, params, stats, w, train=True, relu=relu,
                                        use_mesh=True, impl="matmul")
    assert _rel(ty.detach().numpy(), jy) <= 1e-5
    for k in ("mean", "var"):
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]), rtol=1e-5, atol=1e-5)
    for k in ("scale", "bias"):
        assert _rel(tgp[k].numpy(), jgp[k]) <= 1e-4, k
    assert _rel(tgx.numpy(), jgx) <= 1e-4


@pytest.mark.parametrize(
    "m,c,vec",
    [(256 * 112 * 112, 64, 8), (256 * 56 * 56, 256, 8), (256 * 7 * 7, 2048, 8),
     (105, 24, 4), (18, 10, 1), (1, 1, 1), (3, 2049, 1)],
)
def test_kernel_launch_shape_covers_every_row_and_channel(m, c, vec):
    tx_n, strips, splits, rows = bn.launch_shape(m, c, vec)
    assert tx_n in (1, 2, 4, 8, 16, 32)
    assert strips * tx_n * vec >= c > (strips - 1) * tx_n * vec
    assert splits * rows >= m > (splits - 1) * rows
    assert 1 <= splits <= 65535 and strips * splits <= max(bn._TARGET_BLOCKS, strips)


PLAN_CASES = [
    # (m, c, vec, sms): the B7 cases above, ResNet-50's most frequent,
    # smallest and widest shapes, ragged strips over many blocks, and cards
    # with fewer SMs (ragged strips and rows cut over several blocks at
    # small m).
    (256 * 112 * 112, 64, 8, 132), (256 * 56 * 56, 256, 8, 132), (256 * 7 * 7, 2048, 8, 132),
    (105, 24, 4, 132), (18, 10, 1, 132), (1, 1, 1, 132), (3, 2049, 1, 132),
    (256 * 14 * 14, 256, 8, 132), (256 * 7 * 7, 512, 8, 132), (64 * 28 * 28, 264, 8, 132),
    (32 * 28 * 28, 100, 1, 132), (50_000, 384, 8, 7),
    (32 * 8 * 8, 24, 4, 8), (16 * 8 * 8, 264, 8, 8), (64 * 8 * 8, 100, 1, 8),
]


@pytest.mark.parametrize("m,c,vec,sms", PLAN_CASES)
def test_stats_plan_covers_every_row_and_channel_once(m, c, vec, sms):
    """B6's one grid tiles [m, c]: strips partition the channel groups,
    row ranges partition the rows (none empty), at most one block an SM
    unless the strips alone outnumber the SMs; the workspace is
    [splits, 2, c] f32 and the tickets one a strip."""
    plan = bn.stats_plan(m, c, vec, sms)
    groups = -(-c // vec)
    assert plan.gs in (1, 2, 4, 8, 16, 32) and plan.gs * plan.lanes == bn._STATS_THREADS
    assert plan.strips * plan.gs >= groups > (plan.strips - 1) * plan.gs
    assert plan.splits * plan.rows >= m > (plan.splits - 1) * plan.rows
    assert 1 <= plan.splits <= 65535
    assert plan.strips * plan.splits <= max(sms, plan.strips)
    # Rows are cut only while each block walks its steps.
    assert plan.splits <= max(1, -(-m // (plan.lanes * bn._STATS_MIN_STEPS)))
    # Every (row, channel) in exactly one block, counted on a coarse grid of
    # the blocks' edges.
    row_edges = sorted({0, m, *(min(m, j * plan.rows) for j in range(plan.splits + 1))})
    ch_edges = sorted({0, c, *(min(c, i * plan.gs * vec) for i in range(plan.strips + 1))})
    counts = np.zeros((len(row_edges) - 1, len(ch_edges) - 1), np.int64)
    for i in range(plan.strips):
        c0, c1 = i * plan.gs * vec, min(c, (i + 1) * plan.gs * vec)
        for j in range(plan.splits):
            r0, r1 = j * plan.rows, min(m, (j + 1) * plan.rows)
            counts[row_edges.index(r0):row_edges.index(r1), ch_edges.index(c0):ch_edges.index(c1)] += 1
    assert (counts == 1).all()
    # One allocation: the [2, c] output, then the [splits, 2, c] workspace.
    assert plan.buffer(c) == (2 + plan.splits * 2, c)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn.bn_stats(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn.bn_stats(torch.zeros(2, 8, dtype=torch.float16))
    xc = torch.zeros(2, 3, 4, 8)
    vec = torch.zeros(8)
    with pytest.raises(ValueError, match="do must match"):
        bn.bn_bwd_stats(xc.bfloat16(), xc, vec, vec, vec, vec, relu=True)
    with pytest.raises(ValueError, match="inv must be float32"):
        bn.bn_bwd_stats(xc, xc, vec, torch.zeros(7), vec, vec, relu=True)
    # SyncBN over a data axis of 2 needs a group of 2 ranks: one process has none.
    with pytest.raises(ValueError, match="data group of 2 ranks"):
        mesh_lib.Mesh(device=torch.device("cpu"), shape={"data": 2})

    def rank(r):
        two = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2"), "cpu")
        return bn.batchnorm_train(vec + 1, vec, xc + r, 1e-5, two)

    # On two simulated ranks it computes: every rank's statistics are the pair's.
    outs = collectives.ThreadRanks(2).run(rank)
    torch.testing.assert_close(outs[0][1], torch.full((8,), 0.5), rtol=0, atol=0)
    torch.testing.assert_close(outs[0][2], torch.full((8,), 0.25), rtol=0, atol=0)
    assert all(torch.equal(outs[0][i], outs[1][i]) for i in (1, 2))
    # Ghost BN trains now (``test_torch_ghost_bn.py``); what it refuses is
    # a batch that does not split into its slices, as JAX does.
    p, s = layers.batchnorm_init(8, ghost_slices=2)
    with pytest.raises(ValueError, match="not divisible by 2 slices"):
        layers.batchnorm({k: torch.from_numpy(v) for k, v in p.items()},
                         {k: torch.from_numpy(v) for k, v in s.items()}, xc[:1],
                         train=True, ghost_slices=2)


def test_mesh_spec_and_one_device_mesh():
    from distributed_tensorflow_examples_tpu.parallel.mesh import MeshSpec as JaxMeshSpec

    for text in ("", "data=1", "data=8,model=2", "slice=2,data=4"):
        assert dataclasses.asdict(mesh_lib.MeshSpec.parse(text)) == dataclasses.asdict(
            JaxMeshSpec.parse(text)
        )
    for text in ("", "data=1", "data=-1", "model=1,data=1"):
        m = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(text), "cpu")
        assert m.shape == {"data": 1} and m.size == 1 and m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=2"), "cpu")
    # One rank has no second model or slice rank.
    with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
        mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("model=2"), "cpu")
    with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
        mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("slice=2"), "cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh_lib.MeshSpec.parse("bogus=2")
    with pytest.raises(ValueError, match=">= 1"):
        mesh_lib.build_mesh(mesh_lib.MeshSpec.parse("data=0"), "cpu")
