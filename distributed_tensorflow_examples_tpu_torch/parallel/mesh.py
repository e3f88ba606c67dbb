"""The device mesh over the process world: the port of the ``data``,
``expert``, ``seq`` and ``model`` axes of
``distributed_tensorflow_examples_tpu/parallel/mesh.py``.

:class:`MeshSpec` parses the JAX package's ``--mesh`` text (``""``,
``"data=2"``, ``"data=2,expert=2"``, ``"data=2,seq=2,model=2"``, ...) with
the same axes and defaults, and :meth:`MeshSpec.resolved` is the JAX one:
the single ``-1`` axis takes the rest of the devices, and a product other
than the device count raises ``ValueError``.  :func:`build_mesh` resolves
the spec against the world (one process is one rank and one device,
``parallel/dist.py``) and returns a :class:`Mesh` whose ``shape`` is
``{"data": D}``, with ``expert``, ``seq`` and ``model`` entries for those
axes when they are larger than 1, and which carries one group per axis
(``parallel/collectives.py``): ``group``, the data group (the ranks of
this rank's other indices), which SyncBN sums over; ``expert_group``,
over which the mixture-of-experts layers trade tokens for experts
(``ops/moe.py``); ``seq_group``, around which ring attention rotates k/v
and Ulysses trades sequence for heads; ``model_group``, over which the
Megatron blocks and the vocab-parallel tables sum; ``batch_group``, the
data x expert x seq ranks of its model index, over which the train step
averages the gradients and metrics; and ``expert_grad_group``, the data x
seq ranks of its expert and model indices, over which an expert-sharded
leaf's gradient sums.  Rank r sits at ``(data, expert, seq, model)`` in
JAX's ``DEFAULT_AXES`` order, ``model`` innermost: ``r = ((d X + x) S +
s) M + m``.  The batch's rows split over data x expert jointly, data
major (:attr:`Mesh.row_index`, :attr:`Mesh.row_shards`), as JAX's
``P(("data", "expert"))`` places them.  The ``slice`` and ``pipe`` axes
wait for the port's item A8b-2b.
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's device, the mesh's axes and one group per axis:
    ``shape`` maps ``data`` (and ``expert``, ``seq`` and ``model`` when
    they are larger than 1) to its size, as ``jax.sharding.Mesh.shape``
    reads for the axes the port's models ask about; ``group`` is what the
    data axis sums over, ``expert_group`` the expert axis, ``seq_group``
    the seq axis and ``model_group`` the model axis (``None``: one rank);
    ``batch_group`` the data x expert x seq ranks of this rank's model
    index, over which the train step averages the gradients and metrics:
    each of them takes the gradient of its local token mean (the data
    group when the others are 1); ``expert_grad_group`` the data x seq
    ranks of its expert and model indices (None without an expert axis).
    A group other than its axes' size raises ``ValueError``."""

    device: torch.device
    shape: dict = dataclasses.field(default_factory=lambda: {AXIS_DATA: 1})
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)
    seq_group: object = dataclasses.field(default=None, compare=False, repr=False)
    batch_group: object = dataclasses.field(default=None, compare=False, repr=False)
    expert_group: object = dataclasses.field(default=None, compare=False, repr=False)
    expert_grad_group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        d, x, s = (self.shape.get(a, 1) for a in (AXIS_DATA, AXIS_EXPERT, AXIS_SEQ))
        for axis, g, n in ((AXIS_DATA, self.group, d),
                           (AXIS_EXPERT, self.expert_group, x),
                           (AXIS_SEQ, self.seq_group, s),
                           (AXIS_MODEL, self.model_group, self.shape.get(AXIS_MODEL, 1)),
                           ("data x expert x seq", self.batch_group, d * x * s),
                           ("data x seq", self.expert_grad_group, d * s if x > 1 else 1)):
            have = 1 if g is None else g.size
            if n != have:
                raise ValueError(
                    f"a mesh whose {axis} axis is {n} needs a {axis} group of {n} ranks; "
                    f"it was given {have}"
                )

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (0 on an axis of 1)."""
        g = {AXIS_DATA: self.group, AXIS_EXPERT: self.expert_group, AXIS_SEQ: self.seq_group,
             AXIS_MODEL: self.model_group}.get(axis)
        return 0 if g is None else g.rank

    def axes(self):
        """A context in which the calling thread's axes and groups are
        this mesh's (``collectives.use_group``): code outside a step that
        reads an axis runs in it."""
        return collectives.use_group(
            self.group, model=self.model_group, seq=self.seq_group, expert=self.expert_group,
            batch=self.batch_group, expert_grad=self.expert_grad_group)

    @property
    def data_index(self) -> int:
        return self.index(AXIS_DATA)

    @property
    def expert_index(self) -> int:
        return self.index(AXIS_EXPERT)

    @property
    def row_shards(self) -> int:
        """The shards the batch's rows split over: data x expert."""
        return self.shape.get(AXIS_DATA, 1) * self.shape.get(AXIS_EXPERT, 1)

    @property
    def row_index(self) -> int:
        """This rank's shard of the batch's rows, data major (JAX's
        ``P(("data", "expert"))``)."""
        return self.data_index * self.shape.get(AXIS_EXPERT, 1) + self.expert_index

    @property
    def seq_index(self) -> int:
        return self.index(AXIS_SEQ)

    @property
    def model_index(self) -> int:
        return self.index(AXIS_MODEL)


def build_mesh(spec: MeshSpec | None, device) -> Mesh:
    """The mesh of ``spec`` over the calling thread's world (the process
    group; one rank without a group), seen from the rank on ``device``.
    Raises ``ValueError`` when the spec does not tile the world, and
    ``NotImplementedError`` for a ``slice`` or ``pipe`` axis larger than 1
    (A8b-2b)."""
    spec = spec or MeshSpec()
    bad = {a: s for a, s in spec.sizes().items() if s < 1 and s != -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be >= 1 (or -1 for the rest), got {bad}")
    _no_slice_or_pipe(spec.sizes())
    base = collectives.world()
    sizes = spec.resolved(1 if base is None else base.size)
    _no_slice_or_pipe(sizes)
    data, expert = sizes[AXIS_DATA], sizes[AXIS_EXPERT]
    seq, model = sizes[AXIS_SEQ], sizes[AXIS_MODEL]
    groups = collectives.mesh_groups(base, data, expert, seq, model)
    shape = {AXIS_DATA: data, **{a: n for a, n in ((AXIS_EXPERT, expert), (AXIS_SEQ, seq),
                                                  (AXIS_MODEL, model)) if n > 1}}
    return Mesh(device=torch.device(device), shape=shape, group=groups["data"],
                model_group=groups["model"], seq_group=groups["seq"],
                batch_group=groups["batch"], expert_group=groups["expert"],
                expert_grad_group=groups["expert_grad"])


def _no_slice_or_pipe(sizes: dict[str, int]) -> None:
    big = {a: s for a, s in sizes.items() if a in (AXIS_SLICE, AXIS_PIPE) and s > 1}
    if big:
        raise NotImplementedError(
            f"mesh {big}: the port runs the 'data', 'expert', 'seq' and 'model' axes; the "
            "pipeline axis and ghost BN's 'slice' wait for its item A8b-2b"
        )
