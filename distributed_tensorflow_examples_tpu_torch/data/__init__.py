"""Input data of the port: the token corpora and the device infeed."""

from . import datasets, pipeline  # noqa: F401
