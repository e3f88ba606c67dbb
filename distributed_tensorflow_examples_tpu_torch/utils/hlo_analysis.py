"""The per-step collective account: the port of
``distributed_tensorflow_examples_tpu/utils/hlo_analysis.py``.

The JAX package reads its collectives out of the compiled HLO, since
XLA emits them.  The port has no HLO: every tensor collective it runs
is a call of ``parallel/collectives.py`` over one of its groups (a
``ProcessGroup``, or a ``ThreadRanks`` rank), so the account is the
record of the collectives this rank issued while a step ran.  Each call
is one :class:`Collective` in XLA's names (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``collective-permute``, ``all-to-all``) with its HLO
shapes, its bytes, the ``TRAFFIC`` tag it counts under and the global
ranks of its group, numbered as JAX numbers the devices of the same
mesh.  Bytes follow the JAX module's convention, so that a number means
the same thing in both packages: all-reduce and permute the payload,
all-gather the gathered result, reduce-scatter the pre-scatter operand,
all-to-all the whole tensor (``TRAFFIC["seq_a2a_bytes"]`` counts only
the tiles sent to other ranks).  A flat gradient bucket is one
all-reduce with a shape for each leaf it packs, as XLA's variadic
all-reduce has; per-tensor bytes (:func:`max_tensor_bytes`) read those.

A record belongs to the rank whose group made the call, whichever thread
made it: the sums in a custom backward run on autograd's thread, under
the group they hold.  ``all_gather_object`` moves a pickled host object
(the replicas' digests, a checkpoint's gather) and is not recorded.

- :func:`record_collectives` — a context manager that yields the list
  the calling rank's collectives go into while it is open;
- :func:`step_collectives` — one step under the recorder, its records
  (the twin of the JAX module's ``compiled_step_hlo`` plus
  ``parse_collectives``);
- :func:`summarize`, :func:`max_collective_bytes`,
  :func:`max_tensor_bytes` — the JAX module's reductions, over records;
- :func:`by_tag` — count, bytes and groups of each kind under each tag.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from collections import defaultdict

from ..parallel import collectives

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

#: The cross-device collectives, in XLA's names.
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
    "collective-broadcast",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


@dataclasses.dataclass
class Collective:
    kind: str
    shapes: list[str]  # e.g. ["f32[1024,128]"]
    bytes: int  # by the JAX module's convention (module docstring)
    tag: str  # the TRAFFIC tag the call counts under
    #: The global ranks of the call's group; a permutation's
    #: source-target pairs, each a 2-element group.
    groups: list[list[int]]


def _shape_bytes(dtype: str, dims: str) -> int:
    return math.prod(int(d) for d in dims.split(",") if d) * _DTYPE_BYTES.get(dtype, 4)


@contextlib.contextmanager
def record_collectives():
    """Yield a list that collects a :class:`Collective` for every tensor
    collective the calling rank issues until the block ends (a
    ``ThreadRanks`` rank's own, on any thread)."""
    key = collectives.account_key()
    out: list[Collective] = []

    def sink(kind, shapes, nbytes, tag, groups):
        out.append(Collective(kind, shapes, nbytes, tag, groups))

    collectives.RECORDERS.setdefault(key, []).append(sink)
    try:
        yield out
    finally:
        sinks = collectives.RECORDERS[key]
        sinks.remove(sink)
        if not sinks:
            del collectives.RECORDERS[key]


def step_collectives(step_fn, *args) -> list[Collective]:
    """Run ``step_fn(*args)`` once under :func:`record_collectives` and
    return its records."""
    with record_collectives() as out:
        step_fn(*args)
    return out


def summarize(records: list[Collective]) -> dict:
    """{kind: {"count": n, "bytes": total}} + grand totals."""
    agg: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for c in records:
        agg[c.kind]["count"] += 1
        agg[c.kind]["bytes"] += c.bytes
    agg = dict(agg)
    agg["total"] = {
        "count": sum(v["count"] for v in agg.values()),
        "bytes": sum(v["bytes"] for v in agg.values()),
    }
    return agg


def by_tag(records: list[Collective]) -> dict:
    """{tag: {kind: {"count": n, "bytes": total, "groups": [distinct
    groups, in first-seen order]}}}."""
    out: dict = {}
    for c in records:
        row = out.setdefault(c.tag, {}).setdefault(c.kind, {"count": 0, "bytes": 0, "groups": []})
        row["count"] += 1
        row["bytes"] += c.bytes
        if c.groups not in row["groups"]:
            row["groups"].append(c.groups)
    return out


def max_collective_bytes(records: list[Collective], kind: str | None = None) -> int:
    """Largest single collective payload (optionally of one kind)."""
    return max((c.bytes for c in records if kind is None or c.kind == kind), default=0)


def max_tensor_bytes(records: list[Collective], kind: str | None = None) -> int:
    """Largest single TENSOR moved by any collective: a flat bucket's
    leaves count one by one, as XLA's variadic all-reduce's operands do
    (the right unit for 'did a whole table cross the mesh')."""
    best = 0
    for c in records:
        if kind is not None and c.kind != kind:
            continue
        for s in c.shapes:
            m = _SHAPE_RE.match(s)
            if m:
                best = max(best, _shape_bytes(m.group(1), m.group(2)))
    return best

