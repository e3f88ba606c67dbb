"""The device mesh over the process world: the port of the ``data`` and
``model`` axes of ``distributed_tensorflow_examples_tpu/parallel/mesh.py``.

:class:`MeshSpec` parses the JAX package's ``--mesh`` text (``""``,
``"data=2"``, ``"data=8,model=2"``, ...) with the same axes and defaults,
and :meth:`MeshSpec.resolved` is the JAX one: the single ``-1`` axis takes
the rest of the devices, and a product other than the device count
raises ``ValueError``.  :func:`build_mesh` resolves the spec against the
world (one process is one rank and one device, ``parallel/dist.py``) and
returns a :class:`Mesh` whose ``shape`` is ``{"data": D}``, or
``{"data": D, "model": M}`` with a ``model`` axis, and which carries
one group per axis (``parallel/collectives.py``): ``group``, the data
group (the ranks of this rank's model index), which SyncBN and the train
step's gradient mean sum over, and ``model_group`` (the ranks of its
data index), over which the vocab-parallel tables sum.  Rank r sits at
``data_index = r // M`` and ``model_index = r % M``: ``model`` is the
innermost axis, as in JAX's ``DEFAULT_AXES``.  The ``slice``, ``seq``,
``pipe`` and ``expert`` axes wait for the port's item A8b.
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
    ``shape`` maps ``data`` (and ``model`` when it is larger than 1) to
    its size, as ``jax.sharding.Mesh.shape`` reads for the axes the
    port's models ask about; ``group`` is what the data axis sums over and
    ``model_group`` the model axis (``None``: one rank).  An axis other
    than its group's size raises ``ValueError``."""

    device: torch.device
    shape: dict = dataclasses.field(default_factory=lambda: {AXIS_DATA: 1})
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        for axis, g in ((AXIS_DATA, self.group), (AXIS_MODEL, self.model_group)):
            n = self.shape.get(axis, 1)
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
        g = {AXIS_DATA: self.group, AXIS_MODEL: self.model_group}.get(axis)
        return 0 if g is None else g.rank

    def axes(self):
        """A context in which the calling thread's ``data`` and ``model``
        axes are this mesh's (``collectives.use_group``): code outside a
        step that reads an axis runs in it."""
        return collectives.use_group(self.group, model=self.model_group)

    @property
    def data_index(self) -> int:
        return self.index(AXIS_DATA)

    @property
    def model_index(self) -> int:
        return self.index(AXIS_MODEL)


def build_mesh(spec: MeshSpec | None, device) -> Mesh:
    """The mesh of ``spec`` over the calling thread's world (the process
    group; one rank without a group), seen from the rank on ``device``.
    Raises ``ValueError`` when the
    spec does not tile the world, and ``NotImplementedError`` for a
    ``slice``, ``seq``, ``pipe`` or ``expert`` axis larger than 1 (A8b)."""
    spec = spec or MeshSpec()
    bad = {a: s for a, s in spec.sizes().items() if s < 1 and s != -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be >= 1 (or -1 for the rest), got {bad}")
    _data_and_model_only(spec.sizes())
    base = collectives.world()
    sizes = spec.resolved(1 if base is None else base.size)
    _data_and_model_only(sizes)
    data, model = sizes[AXIS_DATA], sizes[AXIS_MODEL]
    data_group, model_group = collectives.mesh_groups(base, data, model)
    shape = {AXIS_DATA: data, **({AXIS_MODEL: model} if model > 1 else {})}
    return Mesh(device=torch.device(device), shape=shape, group=data_group,
                model_group=model_group)


def _data_and_model_only(sizes: dict[str, int]) -> None:
    big = {a: s for a, s in sizes.items() if a not in (AXIS_DATA, AXIS_MODEL) and s > 1}
    if big:
        raise NotImplementedError(
            f"mesh {big}: the port runs the 'data' and 'model' axes; the sequence, "
            "expert and pipeline axes and ghost BN's 'slice' wait for its item A8b"
        )
