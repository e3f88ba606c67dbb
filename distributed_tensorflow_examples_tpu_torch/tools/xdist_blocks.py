"""How pytest-xdist's ``--dist load`` first splits a test run over its
workers, and which block holds the most seconds.

The scheduler hands each of the W workers, before any test runs, a block
of ``max((N // W) // 4, 2)`` consecutive tests in collection order (N
the tests collected); a worker keeps its block to the end, and only the
rest is handed out as workers free up.  A block of long tests in a row
therefore runs on one worker alone, and the run cannot end before it.
Given a junit XML of a run (each test's seconds) and the collection
order (``pytest --collect-only -q``'s node ids, one a line), this prints
the seconds of each initial block at N and at the collection sizes
around it::

    python -m pytest tests/ -q --collect-only | grep '::' > order.txt
    python -m distributed_tensorflow_examples_tpu_torch.tools.xdist_blocks \\
        run.xml order.txt --workers 6 --span 200
"""

from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET


def test_seconds(junit_path: str) -> dict[str, float]:
    """node id -> seconds, from a junit XML of a run over ``tests/``."""
    out = {}
    for case in ET.parse(junit_path).getroot().iter("testcase"):
        module = case.get("classname").split(".", 1)[1].replace(".", "/")
        out[f"tests/{module}.py::{case.get('name')}"] = float(case.get("time"))
    return out


def initial_blocks(seconds: list[float], n: int, workers: int) -> list[float]:
    """The seconds of each worker's initial block at ``n`` tests collected
    (the tests past the known ones count 0)."""
    size = max((n // workers) // 4, 2)
    return [sum(seconds[i * size:(i + 1) * size]) for i in range(workers)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("junit")
    p.add_argument("order")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--span", type=int, default=200,
                   help="Collection sizes from N to N + span are printed.")
    args = p.parse_args(argv)
    seconds_by_id = test_seconds(args.junit)
    order = [line.strip() for line in open(args.order) if line.strip()]
    seconds = [seconds_by_id.get(t, 0.0) for t in order]
    n = len(order)
    print(f"N {n}, {sum(seconds):.1f} worker-seconds")
    last = None
    for m in range(n, n + args.span + 1):
        blocks = initial_blocks(seconds, m, args.workers)
        size = max((m // args.workers) // 4, 2)
        if (size, max(blocks)) != last:
            print(f"N {m}: blocks of {size}, the largest {max(blocks):.0f} s "
                  f"({', '.join(f'{b:.0f}' for b in blocks)})")
            last = (size, max(blocks))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
