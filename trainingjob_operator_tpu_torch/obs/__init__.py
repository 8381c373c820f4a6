"""Observability of the port's workloads: structured logs, the span tracer
and the telemetry emitter (own copies of the JAX package's ``obs``)."""
