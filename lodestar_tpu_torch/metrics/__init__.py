"""Metrics registry (the port's copy of the JAX package's ``metrics``):
the BLS verifier's and pool's metric groups over ``prometheus_client``
when it is installed, no-op metrics otherwise."""

from .registry import HAVE_PROM, Metrics, MetricsRegistry, create_metrics  # noqa: F401
