"""The device mesh on one device: the port of the parts of
``distributed_tensorflow_examples_tpu/parallel/mesh.py`` a one-device run
needs.

:class:`MeshSpec` parses the JAX package's ``--mesh`` text (``""``,
``"data=1"``, ``"data=8,model=2"``, ...) with the same axes and defaults.
:func:`build_mesh` resolves it against one device and returns a
:class:`Mesh` whose ``shape`` is ``{"data": 1}``: what the models read to
take the fused BatchNorm statistics path.  A mesh of more than one device
waits for the port's multi-device item (A5: data parallel, NCCL) and its
model-parallel axes for A8.
"""

from __future__ import annotations

import dataclasses

import torch

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device as a mesh: ``shape`` maps every axis of size > 1 (none)
    plus ``data`` to its size, as ``jax.sharding.Mesh.shape`` reads for the
    axes the port's models ask about."""

    device: torch.device
    shape: dict = dataclasses.field(default_factory=lambda: {AXIS_DATA: 1})

    @property
    def size(self) -> int:
        return 1


def build_mesh(spec: MeshSpec | None, device) -> Mesh:
    """The one-device mesh of ``spec`` on ``device``.  Raises
    ``NotImplementedError`` for a spec that needs more than one device."""
    spec = spec or MeshSpec()
    bad = {a: s for a, s in spec.sizes().items() if s < 1 and s != -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be >= 1 (or -1 for the rest), got {bad}")
    sizes = {a: 1 if s == -1 else s for a, s in spec.sizes().items()}
    big = {a: s for a, s in sizes.items() if s != 1}
    if big:
        raise NotImplementedError(
            f"mesh {big}: the port runs on one device so far; data parallel "
            "waits for its multi-device item (A5) and model-parallel axes for "
            "its model-parallel slice (A8)"
        )
    return Mesh(device=torch.device(device))
