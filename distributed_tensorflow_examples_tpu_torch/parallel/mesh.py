"""The device mesh over the process world: the port of the data-parallel
part of ``distributed_tensorflow_examples_tpu/parallel/mesh.py``.

:class:`MeshSpec` parses the JAX package's ``--mesh`` text (``""``,
``"data=2"``, ``"data=8,model=2"``, ...) with the same axes and defaults,
and :meth:`MeshSpec.resolved` is the JAX one: the single ``-1`` axis takes
the rest of the devices, and a product other than the device count
raises ``ValueError``.  :func:`build_mesh` resolves the spec against the
data group (the world: one process is one rank and one device,
``parallel/dist.py``) and returns a :class:`Mesh` whose ``shape`` is
``{"data": world}`` and whose ``group`` is that group: what the models
read to take the fused BatchNorm statistics path, and what SyncBN and
the train step sum over.  A model-parallel axis larger than 1 waits for
the port's model-parallel slice (A8).
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
    """This rank's device, the mesh's axes and its data group: ``shape``
    maps ``data`` to the group's size (every other axis is 1), as
    ``jax.sharding.Mesh.shape`` reads for the axes the port's models ask
    about; ``group`` is what the data axis sums over (``None``: one rank).
    A data axis other than the group's size raises ``ValueError``."""

    device: torch.device
    shape: dict = dataclasses.field(default_factory=lambda: {AXIS_DATA: 1})
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        n = self.shape.get(AXIS_DATA, 1)
        have = 1 if self.group is None else self.group.size
        if n != have:
            raise ValueError(
                f"a mesh whose data axis is {n} needs a data group of {n} ranks; "
                f"it was given {have}"
            )

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def build_mesh(spec: MeshSpec | None, device) -> Mesh:
    """The mesh of ``spec`` over the calling thread's data group (the
    process world; one rank without a group), seen from the rank on
    ``device``.  Raises ``ValueError`` when the spec does not tile the
    world, and ``NotImplementedError`` for a model-parallel axis larger
    than 1 (A8)."""
    spec = spec or MeshSpec()
    bad = {a: s for a, s in spec.sizes().items() if s < 1 and s != -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be >= 1 (or -1 for the rest), got {bad}")
    _data_only(spec.sizes())
    group = collectives.group()
    sizes = spec.resolved(1 if group is None else group.size)
    _data_only(sizes)
    return Mesh(device=torch.device(device), shape={AXIS_DATA: sizes[AXIS_DATA]}, group=group)


def _data_only(sizes: dict[str, int]) -> None:
    big = {a: s for a, s in sizes.items() if a != AXIS_DATA and s > 1}
    if big:
        raise NotImplementedError(
            f"mesh {big}: the port runs data parallel only; model-parallel axes "
            "(and ghost BN's 'slice') wait for its model-parallel slice (A8)"
        )
