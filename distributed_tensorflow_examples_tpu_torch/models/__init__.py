"""Models of the port (plain functions over dicts of tensors)."""

from . import cnn, layers, lstm, mlp, resnet, transformer, word2vec  # noqa: F401
