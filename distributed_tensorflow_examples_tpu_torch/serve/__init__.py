"""Serving plane of the port: a PS-tracking or registry-pinned model
replica, its micro-batcher, the model registry and the serving clients
(wire-compatible with ``distributed_tensorflow_examples_tpu.serve``),
rolling deploys and canary decisions over pinned replicas (``deploy``),
and the autoscaled pool with its lease-following discovery
(``autoscale``)."""

from .autoscale import (  # noqa: F401
    LeaseServeDiscovery,
    ServeAutoscaler,
    make_replica_factory,
)
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
from .deploy import RollingDeploy, canary_verdict, make_pinned_factory  # noqa: F401
from .model_server import ModelReplicaServer, host_serve_task  # noqa: F401
from .registry import ModelRegistry, RegistryError  # noqa: F401
