"""Determinism controls: the port of
``distributed_tensorflow_examples_tpu/utils/determinism.py``.

The JAX ``enable()`` pins partitionable threefry and the highest matmul
precision so that reductions do not vary with tiling.  The port's keys are
threefry already (``utils/threefry.py``) and its data pipelines reshuffle
from ``(seed, epoch)``, so what is left is the GPU's own choices:

- no TF32 in matmuls or cuDNN convolutions (the highest precision);
- cuDNN restricted to deterministic algorithms, no autotuning;
- ``torch.use_deterministic_algorithms(True)``, which makes an operation
  that has no deterministic implementation raise instead of running, with
  the cuBLAS workspace setting it asks for (``CUBLAS_WORKSPACE_CONFIG``,
  set here unless the environment set it already).

The settings are process-wide, as the JAX ones are.  ``--deterministic``
calls :func:`enable` from ``Experiment`` and from the PS emulation, where it
also selects the fixed round-robin interleave (``parallel/async_ps.py``):
two such runs end with bitwise-equal parameters on the card only because
the convolutions' backward algorithms are deterministic.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger("dtx.determinism")

CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def enable() -> None:
    """Turn on run-to-run determinism (the enable_op_determinism analog)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    log.info(
        "determinism on: no TF32, deterministic cuDNN and torch algorithms, "
        "CUBLAS_WORKSPACE_CONFIG=%s", os.environ["CUBLAS_WORKSPACE_CONFIG"],
    )
