"""Input data of the port: the image and token datasets, the in-memory
batch stream, the image-source resolution and the device infeed."""

from . import datasets, pipeline, streams  # noqa: F401
