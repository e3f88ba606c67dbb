"""Host-side transport of the port: copies of the JAX package's jax-free
wire, server runtime, tenancy and retry modules (wire bytes identical)."""
