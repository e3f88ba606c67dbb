"""The port's parallel layer: the process world (``dist``), the mesh over
it (``mesh``), the data-axis collectives and batch sharding
(``collectives``, ``sharding``), the in-process parameter-server
emulation (``async_ps``), and copies of the JAX package's jax-free wire,
server runtime, tenancy and retry modules (wire bytes identical).
Import the modules themselves."""
