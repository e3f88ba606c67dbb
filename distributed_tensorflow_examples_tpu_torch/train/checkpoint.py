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

    def __init__(self, directory: str, *, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
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
        (periodic + final overlap)."""
        step = int(step)
        if self.latest_step() == step:
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = {
            "step": int(state.step),
            "params": {path: p.detach() for path, p in _leaves(state.params)},
            "opt_state": state.opt_state.state_dict(),
            "model_state": state.model_state,
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
        return True

    def _load(self, step: int, device):
        """The saved payload of ``step``, or None (and the step moved
        aside) when its file does not load."""
        path = os.path.join(self.directory, str(step))
        try:
            return torch.load(os.path.join(path, _FILE), map_location=device,
                              weights_only=True)
        except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
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
        log.info("restored checkpoint at step %d", step)
        return TrainState(
            step=int(blob["step"]),
            params=template.params,
            opt_state=template.opt_state,
            model_state=blob["model_state"],
            seed=int(blob["seed"]),
        )

    def wait(self) -> None:
        """Saves are synchronous; nothing is pending."""

    def close(self) -> None:
        pass
