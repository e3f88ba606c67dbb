"""Attention ops and the hand-written CUDA kernels behind them.

``LAUNCHES`` counts, by kernel name, every launch a kernel wrapper makes on
the card (a wrapper that takes its plain PyTorch version for a CPU tensor
adds nothing), so a run can show that its main path went through the
kernels: reset it, drive the path, read it.  ``TENSOR_CORE_LAUNCHES``
counts, of those, the launches that took a kernel's tensor-core instance
(every flash kernel with bf16 in and out), so a run can show that its
path did not fall onto the CUDA-core one.
"""

from __future__ import annotations

import collections

#: Kernel launches by kernel name (``"flash_fwd"``, ...).
LAUNCHES: collections.Counter = collections.Counter()
#: Of those, the launches of a tensor-core kernel instance, by kernel name.
TENSOR_CORE_LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    TENSOR_CORE_LAUNCHES.clear()
