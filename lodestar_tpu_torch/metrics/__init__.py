"""Metrics registry (the port's copy of the JAX package's ``metrics``):
the BLS verifier's, the pool's and the chain's metric groups over
``prometheus_client`` when it is installed, no-op metrics otherwise;
``validator_monitor`` tracks registered validators' duties."""

from .registry import HAVE_PROM, Metrics, MetricsRegistry, create_metrics  # noqa: F401
