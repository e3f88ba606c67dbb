"""The port's rank layout on every mesh of 2, 4 and 8 ranks over the six
axes, against the JAX package's device layout.

For each way of writing the rank count as a product over ``(slice,
data, pipe, expert, seq, model)`` (JAX's ``DEFAULT_AXES`` order), the
port builds the mesh on simulated ranks (``collectives.ThreadRanks``)
and JAX lays the same sizes over its fake CPU devices
(``local_mesh_for_testing``).  Rank r's index on every axis must be the
coordinate of device r in JAX's device array, its row shard
(``Mesh.row_index`` of ``Mesh.row_shards``) the block of a batch that
JAX's ``P(("slice", "data", "expert"))`` sharding places on device r, and
every group the ranks that share the other coordinates.
"""

import itertools
import math

import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

from distributed_tensorflow_examples_tpu.parallel import local_mesh_for_testing
from distributed_tensorflow_examples_tpu_torch.parallel import collectives
from distributed_tensorflow_examples_tpu_torch.parallel import mesh as mesh_lib

AXES = mesh_lib.DEFAULT_AXES


def _shapes(n: int) -> list:
    """Every assignment of powers of two with product ``n`` to the axes."""
    k = int(math.log2(n))
    out = []
    for exps in itertools.product(range(k + 1), repeat=len(AXES)):
        if sum(exps) == k:
            out.append(tuple(2 ** e for e in exps))
    return out


CASES = [s for n in (2, 4, 8) for s in _shapes(n)]


def _text(shape: tuple) -> str:
    return ",".join(f"{a}={s}" for a, s in zip(AXES, shape))


@pytest.mark.parametrize("shape", CASES, ids=[_text(s) for s in CASES])
def test_rank_layout_matches_the_jax_device_layout(shape):
    n = math.prod(shape)
    sizes = dict(zip(AXES, shape))
    jmesh = local_mesh_for_testing(sizes)
    coords = {int(d.id): c for c, d in np.ndenumerate(jmesh.devices)}
    rows = n * 2
    placed = NamedSharding(jmesh, JP(("slice", "data", "expert"))).devices_indices_map((rows,))
    row_shards = sizes["slice"] * sizes["data"] * sizes["expert"]
    want_row = {int(d.id): (idx[0].start or 0) // (rows // row_shards)
                for d, idx in placed.items()}

    def rank(r):
        m = mesh_lib.build_mesh(mesh_lib.MeshSpec.parse(_text(shape)), "cpu")
        return (r, tuple(m.index(a) for a in AXES), m.row_index, m.row_shards,
                {name: (None if g is None else g.size)
                 for name, g in (("batch", m.batch_group), ("rows", m.rows_group),
                                 ("pipe", m.pipe_group), ("slice", m.slice_group))},
                m.shape)

    for r, idx, row, shards, group_sizes, mshape in collectives.ThreadRanks(n).run(rank):
        assert idx == coords[r], (r, idx, coords[r])
        assert shards == row_shards and row == want_row[r]
        assert mshape == {"data": sizes["data"],
                          **{a: s for a, s in sizes.items() if a != "data" and s > 1}}
        batch = sizes["slice"] * sizes["data"] * sizes["expert"] * sizes["seq"]
        for name, want in (("batch", batch), ("rows", row_shards), ("pipe", sizes["pipe"]),
                           ("slice", sizes["slice"])):
            assert (group_sizes[name] or 1) == want, (name, group_sizes)
