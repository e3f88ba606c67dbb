"""Serving plane of the port: a registry-pinned model replica, its
micro-batcher, the model registry and the serving clients (wire-compatible
with ``distributed_tensorflow_examples_tpu.serve``)."""

from .batcher import DynamicBatcher, Overloaded  # noqa: F401
from .client import (  # noqa: F401
    ServeClient,
    ServeDeadlineError,
    ServeError,
    ServeOverloadError,
    ServePool,
    ServeRejectedError,
    ServeSessionError,
    ServeUnavailableError,
)
from .model_server import ModelReplicaServer, host_serve_task  # noqa: F401
from .registry import ModelRegistry, RegistryError  # noqa: F401
