"""PyTorch/CUDA port of ``distributed_tensorflow_examples_tpu``.

A package of its own beside the JAX one, which stays the reference: it
imports ``torch`` and numpy, never ``jax`` and nothing of the JAX package.
Its layout mirrors the JAX package's (``ops/``, ``models/``,
``parallel/``, ``serve/``, ``utils/``) so each module's counterpart is
found by name.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; every TPU kernel on a ported path is a hand-written
Hopper kernel (``ops/csrc/``) with a plain PyTorch version for CPU tensors.
Importing the package starts nothing and builds nothing.
"""
