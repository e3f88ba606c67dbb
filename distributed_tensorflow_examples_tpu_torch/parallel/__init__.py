"""Host-side transport of the port: copies of the JAX package's jax-free
wire, server runtime, tenancy and retry modules (wire bytes identical),
and the in-process parameter-server emulation (``async_ps``)."""

from .async_ps import AsyncPSConfig, AsyncPSTrainer  # noqa: F401
