"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.  Raises
    when CUDA is asked for (or implied) and no card is present: an entry
    point never drops to the CPU unless the caller passed ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def for_drawing(device=None) -> torch.device:
    """Where to draw random initial weights that go back to the host:
    ``device``, or else the card when there is one and the CPU when there
    is not.  The place changes no uniform draw and no random bit
    (``utils/threefry.py``); a normal draw's ``log1p`` may round an ulp
    apart on the two."""
    if device is not None:
        return resolve(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
