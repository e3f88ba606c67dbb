"""Checkpoints and auto-resume: the port of
``distributed_tensorflow_examples_tpu/train/checkpoint.py``.

The same on-disk layout as the JAX package's orbax manager, one
directory per saved step under the manager's root
(``<log_dir>/ckpt/<step>/``), holding one ``torch.save`` file of the
whole ``TrainState``.  A save writes and fsyncs the file in a temporary
directory, renames that into place and fsyncs the root, so neither a
crashed process nor a crashed host leaves a half-written step under a
step's name; ``max_to_keep`` prunes the oldest.  ``restore_latest``
loads the newest readable step into the template state's tensors and
optimizer, with ``weights_only=True`` (the file holds only dicts,
lists, numbers and tensors).  A step that does not load (a file torn by
a disk fault) is moved aside to ``.unreadable-<step>`` with a warning,
and the step before it is tried.  Saves are synchronous; ``wait``
exists for the hooks' sake.

Under data parallelism every rank calls ``save`` at the same step; the
chief alone writes, and a barrier follows, so every rank may then read
the step.  Every rank restores (the chief alone moves an unreadable step
aside).  With ``row_sharded_state`` the model state is split by rows
over the ranks (the LSTM's carry, which JAX's rules shard over
``data``): ``save`` gathers it into the global layout, rank 0's rows
first, and a restore takes the rank's rows back.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil

import numpy as np
import torch

from ..bridge import _leaves
from ..bridge import flat_params_of as _flat
from ..parallel import collectives, dist, sharding
from .state import TrainState

log = logging.getLogger("dtx.checkpoint")

_FILE = "state.pt"


def flat_params_of(state_or_params) -> np.ndarray:
    """The flat f32 parameter vector of a params tree (or a TrainState —
    its ``params`` half) in registry order: what the model registry
    publishes and a serving replica's ``unflatten`` inverts."""
    return _flat(getattr(state_or_params, "params", state_or_params))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """``save(step, state)`` (deduped, keeps ``max_to_keep``),
    ``restore_latest(template)``, ``latest_step()``."""

    def __init__(self, directory: str, *, max_to_keep: int = 5,
                 row_sharded_state: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.row_sharded_state = row_sharded_state
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit()
            and os.path.exists(os.path.join(self.directory, name, _FILE))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> bool:
        """Save ``state`` as ``step``, unless that step is saved already
        (periodic + final overlap).  Every rank calls it; the chief
        writes; all leave together."""
        step = int(step)
        model_state = state.model_state
        if self.row_sharded_state:
            model_state = _gather_rows(model_state)
        wrote = False
        if dist.is_chief() and self.latest_step() != step:
            self._write(step, state, model_state)
            wrote = True
        dist.barrier(f"checkpoint-{step}")
        return wrote

    def _write(self, step: int, state: TrainState, model_state) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = {
            "step": int(state.step),
            "params": {path: p.detach() for path, p in _leaves(state.params)},
            "opt_state": state.opt_state.state_dict(),
            "model_state": model_state,
            "seed": int(state.seed),
        }
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic: a reader never sees half a step
        _fsync_dir(self.directory)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        log.info("saved checkpoint at step %d", step)

    def _load(self, step: int, device):
        """The saved payload of ``step``, or None (and the step moved
        aside) when its file does not load."""
        path = os.path.join(self.directory, str(step))
        try:
            return torch.load(os.path.join(path, _FILE), map_location=device,
                              weights_only=True)
        except (RuntimeError, EOFError, OSError, pickle.UnpicklingError) as e:
            if not dist.is_chief():
                log.warning("checkpoint at step %d does not load (%s); trying the step "
                            "before it", step, e)
                return None
            aside = os.path.join(self.directory, f".unreadable-{step}")
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(path, aside)
            log.warning("checkpoint at step %d does not load (%s); moved it to "
                        "%s and trying the step before it", step, e, aside)
            return None

    def restore_latest(self, template: TrainState) -> TrainState | None:
        """Load the newest readable step into ``template``'s parameter
        tensors and optimizer (in place) and return the restored state;
        None when there is no checkpoint.  Raises when steps exist but
        none of them loads."""
        steps = self.all_steps()
        if not steps:
            return None
        device = next(p for _path, p in _leaves(template.params)).device
        for step in reversed(steps):
            blob = self._load(step, device)
            if blob is not None:
                break
        else:
            raise RuntimeError(
                f"no checkpoint under {self.directory} loads (steps {steps} "
                "were moved aside as .unreadable-<step>)"
            )
        params = dict(_leaves(template.params))
        if blob["params"].keys() != params.keys():
            raise ValueError(
                f"checkpoint at step {step} holds other parameters than the "
                "template state"
            )
        with torch.no_grad():
            for path, p in params.items():
                p.copy_(blob["params"][path])
        template.opt_state.load_state_dict(blob["opt_state"])
        model_state = blob["model_state"]
        if self.row_sharded_state:
            model_state = _map(sharding.local_rows, model_state)
        log.info("restored checkpoint at step %d", step)
        return TrainState(
            step=int(blob["step"]),
            params=template.params,
            opt_state=template.opt_state,
            model_state=model_state,
            seed=int(blob["seed"]),
        )

    def wait(self) -> None:
        """Saves are synchronous; nothing is pending."""

    def close(self) -> None:
        pass


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _gather_rows(tree):
    """Every leaf of a row-sharded tree as the global tensor: the ranks'
    rows concatenated in rank order (the leaf itself on one rank)."""
    if collectives.axis_size() == 1:
        return tree

    def gather(t):
        parts = collectives.all_gather_object(t.detach().cpu())
        return torch.cat(parts).to(t.device)

    return _map(gather, tree)
