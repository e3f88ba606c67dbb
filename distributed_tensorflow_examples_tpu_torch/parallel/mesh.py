"""The device mesh over the process world: the port of
``distributed_tensorflow_examples_tpu/parallel/mesh.py``.

:class:`MeshSpec` parses the JAX package's ``--mesh`` text (``""``,
``"data=2"``, ``"data=2,expert=2"``, ``"data=2,seq=2,model=2"``,
``"data=2,pipe=4"``, ``"slice=2,data=4"``, ...) with the same axes and
defaults, and :meth:`MeshSpec.resolved` is the JAX one: the single
``-1`` axis takes the rest of the devices, and a product other than the
device count raises ``ValueError``.  :func:`build_mesh` resolves the
spec against the world (one process is one rank and one device,
``parallel/dist.py``) and returns a :class:`Mesh` whose ``shape`` is
``{"data": D}``, with an entry for every other axis larger than 1, and
which carries one group per axis (``parallel/collectives.py``):
``group``, the data group (the ranks of this rank's other indices),
which SyncBN sums over (ghost-batch BN's slice-local statistics);
``slice_group``, the slices of one data index; ``pipe_group``, around
which the GPipe schedule hands each stage's output to the next
(``parallel/pipeline.py``); ``expert_group``, over which the
mixture-of-experts layers trade tokens for experts (``ops/moe.py``);
``seq_group``, around which ring attention rotates k/v and Ulysses
trades sequence for heads; ``model_group``, over which the Megatron
blocks and the vocab-parallel tables sum; ``batch_group``, the slice x
data x expert x seq ranks of its pipe and model indices, over which the
train step averages the gradients and metrics; ``expert_grad_group``,
the slice x data x seq ranks of its pipe, expert and model indices,
over which an expert-sharded leaf's gradient sums; and ``rows_group``,
the slice x data x expert ranks, which hold the batch's row shards
(global BatchNorm statistics, ZeRO-1's chunks).  Rank r sits at
``(slice, data, pipe, expert, seq, model)`` in JAX's ``DEFAULT_AXES``
order, ``model`` innermost.  The batch's rows split over slice x data x
expert jointly, slice major (:attr:`Mesh.row_index`,
:attr:`Mesh.row_shards`), as JAX's ``P(("slice", "data"))`` and
``P(("data", "expert"))`` place them; the pipe ranks of one row shard
hold the same rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import collectives

AXIS_SLICE, AXIS_DATA, AXIS_PIPE = "slice", "data", "pipe"
AXIS_EXPERT, AXIS_SEQ, AXIS_MODEL = "expert", "seq", "model"
#: The JAX package's axis order, outermost first.
DEFAULT_AXES: tuple[str, ...] = (
    AXIS_SLICE, AXIS_DATA, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ, AXIS_MODEL
)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout; ``-1`` on one axis means "all remaining
    devices" (data by default)."""

    data: int = -1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1
    slice: int = 1

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """Parse ``"data=8,model=2"`` (axes omitted default to 1, data to -1)."""
        if not text or not text.strip():
            return MeshSpec()
        kwargs: dict[str, int] = {}
        for part in text.split(","):
            name, _, value = part.partition("=")
            name = name.strip()
            if name not in DEFAULT_AXES:
                raise ValueError(f"unknown mesh axis {name!r}; valid: {DEFAULT_AXES}")
            kwargs[name] = int(value)
        return MeshSpec(**kwargs)

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in DEFAULT_AXES}

    def resolved(self, n_devices: int) -> dict[str, int]:
        """Resolve the single ``-1`` axis against the device count."""
        sizes = self.sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[unknown[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, have {n_devices}"
            )
        return sizes


#: The groups a :class:`Mesh` carries, by field: (the axes each spans).
_GROUP_AXES = {
    "group": (AXIS_DATA,), "slice_group": (AXIS_SLICE,), "pipe_group": (AXIS_PIPE,),
    "expert_group": (AXIS_EXPERT,), "seq_group": (AXIS_SEQ,), "model_group": (AXIS_MODEL,),
    "batch_group": (AXIS_SLICE, AXIS_DATA, AXIS_EXPERT, AXIS_SEQ),
    "expert_grad_group": (AXIS_SLICE, AXIS_DATA, AXIS_SEQ),
    "rows_group": (AXIS_SLICE, AXIS_DATA, AXIS_EXPERT),
}
#: ``collectives.mesh_groups``'s name of each field's group.
_GROUP_NAMES = {"group": "data", "slice_group": "slice", "pipe_group": "pipe",
                "expert_group": "expert", "seq_group": "seq", "model_group": "model",
                "batch_group": "batch", "expert_grad_group": "expert_grad",
                "rows_group": "rows"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's device, the mesh's axes and one group per axis:
    ``shape`` maps ``data`` (and every other axis larger than 1) to its
    size, as ``jax.sharding.Mesh.shape`` reads for the axes the port's
    models ask about; ``group`` is what the data axis sums over, and
    ``slice_group``, ``pipe_group``, ``expert_group``, ``seq_group`` and
    ``model_group`` their axes' (``None``: one rank); ``batch_group`` the
    slice x data x expert x seq ranks of this rank's pipe and model
    indices, over which the train step averages the gradients and
    metrics: each of them takes the gradient of its local token mean (the
    data group when the others are 1); ``expert_grad_group`` the slice x
    data x seq ranks of its expert index (None without an expert axis);
    ``rows_group`` the slice x data x expert ranks.  A group other than
    its axes' size raises ``ValueError``."""

    device: torch.device
    shape: dict = dataclasses.field(default_factory=lambda: {AXIS_DATA: 1})
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)
    seq_group: object = dataclasses.field(default=None, compare=False, repr=False)
    batch_group: object = dataclasses.field(default=None, compare=False, repr=False)
    expert_group: object = dataclasses.field(default=None, compare=False, repr=False)
    expert_grad_group: object = dataclasses.field(default=None, compare=False, repr=False)
    pipe_group: object = dataclasses.field(default=None, compare=False, repr=False)
    slice_group: object = dataclasses.field(default=None, compare=False, repr=False)
    rows_group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        sizes = {a: self.shape.get(a, 1) for a in DEFAULT_AXES}
        for name, axes in _GROUP_AXES.items():
            n = math.prod(sizes[a] for a in axes)
            if name == "expert_grad_group" and sizes[AXIS_EXPERT] == 1:
                n = 1
            g = getattr(self, name)
            have = 1 if g is None else g.size
            if n != have:
                label = " x ".join(axes)
                raise ValueError(
                    f"a mesh whose {label} axis is {n} needs a {label} group of {n} ranks; "
                    f"it was given {have}"
                )

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (0 on an axis of 1)."""
        g = {AXIS_DATA: self.group, AXIS_SLICE: self.slice_group, AXIS_PIPE: self.pipe_group,
             AXIS_EXPERT: self.expert_group, AXIS_SEQ: self.seq_group,
             AXIS_MODEL: self.model_group}.get(axis)
        return 0 if g is None else g.rank

    def axes(self):
        """A context in which the calling thread's axes and groups are
        this mesh's (``collectives.use_group``): code outside a step that
        reads an axis runs in it."""
        return collectives.use_group(
            self.group, model=self.model_group, seq=self.seq_group, expert=self.expert_group,
            batch=self.batch_group, expert_grad=self.expert_grad_group, pipe=self.pipe_group,
            slice=self.slice_group, rows=self.rows_group)

    @property
    def data_index(self) -> int:
        return self.index(AXIS_DATA)

    @property
    def expert_index(self) -> int:
        return self.index(AXIS_EXPERT)

    @property
    def slice_index(self) -> int:
        return self.index(AXIS_SLICE)

    @property
    def pipe_index(self) -> int:
        return self.index(AXIS_PIPE)

    @property
    def row_shards(self) -> int:
        """The shards the batch's rows split over: slice x data x expert."""
        return math.prod(self.shape.get(a, 1) for a in (AXIS_SLICE, AXIS_DATA, AXIS_EXPERT))

    @property
    def row_index(self) -> int:
        """This rank's shard of the batch's rows, slice major, then data
        (JAX's ``P(("slice", "data"))`` and ``P(("data", "expert"))``)."""
        index = 0
        for a in (AXIS_SLICE, AXIS_DATA, AXIS_EXPERT):
            index = index * self.shape.get(a, 1) + self.index(a)
        return index

    @property
    def seq_index(self) -> int:
        return self.index(AXIS_SEQ)

    @property
    def model_index(self) -> int:
        return self.index(AXIS_MODEL)


def build_mesh(spec: MeshSpec | None, device) -> Mesh:
    """The mesh of ``spec`` over the calling thread's world (the process
    group; one rank without a group), seen from the rank on ``device``.
    Raises ``ValueError`` when the spec does not tile the world."""
    spec = spec or MeshSpec()
    bad = {a: s for a, s in spec.sizes().items() if s < 1 and s != -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be >= 1 (or -1 for the rest), got {bad}")
    base = collectives.world()
    sizes = spec.resolved(1 if base is None else base.size)
    groups = collectives.mesh_groups(base, sizes)
    shape = {AXIS_DATA: sizes[AXIS_DATA],
             **{a: n for a, n in sizes.items() if a != AXIS_DATA and n > 1}}
    return Mesh(device=torch.device(device), shape=shape,
                **{field: groups[name] for field, name in _GROUP_NAMES.items()})
