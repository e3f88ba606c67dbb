"""Utilities of the port: device choice, telemetry, fault injection,
metrics."""
