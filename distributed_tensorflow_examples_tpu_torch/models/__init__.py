"""Models of the port (plain functions over dicts of tensors)."""

from . import layers, transformer  # noqa: F401
