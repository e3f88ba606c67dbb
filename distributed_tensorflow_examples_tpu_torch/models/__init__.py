"""Models of the port (plain functions over dicts of tensors)."""

from . import layers, resnet, transformer  # noqa: F401
