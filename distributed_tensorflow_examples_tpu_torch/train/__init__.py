"""Training on one device: state, optimizer, step, hooks, checkpoint,
session and the ``Experiment`` runner (the port of the JAX package's
``train/``; the parameter-server experiment comes with the PS plane)."""

from . import checkpoint, hooks, loop, optim, preemption, state, step  # noqa: F401
from .runner import Experiment  # noqa: F401
