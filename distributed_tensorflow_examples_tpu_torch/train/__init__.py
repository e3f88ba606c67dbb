"""Training on one device: state, optimizer, step, hooks, checkpoint,
session, the ``Experiment`` runner and the parameter-server emulation's
CLI runner (the port of the JAX package's ``train/``)."""

from . import checkpoint, hooks, loop, optim, preemption, state, step  # noqa: F401
from .ps_experiment import array_eval_fn, run_ps_emulation, worker_count  # noqa: F401
from .runner import Experiment  # noqa: F401
