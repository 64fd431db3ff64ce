"""Performance observatory (the port's copy of the JAX package's
``observatory``): what building, loading and capturing the port's
programs cost (``compile_ledger``), whether the cards are busy and how
much memory they hold (``device_sampler``), profiler windows merged with
the span timeline (``xprof``), each batch's time split into queue,
pack, device compute, combine, final exponentiation and bubble
(``attribution``), and the latency ladder with its percentile helpers
(``latency``)."""

from . import device_sampler as _device_sampler
from .attribution import attribute_spans, mesh_scaling_loss, scaling_loss_breakdown
from .compile_ledger import COMPILE_LEDGER, KINDS, CompileLedger
from .device_sampler import DeviceSampler, start_sampler, stop_sampler
from .latency import (
    COMPILE_BUCKETS_S,
    SLO_LATENCY_BUCKETS_S,
    bucket_percentile,
    cumulative_counts,
    nearest_rank,
)
from .xprof import (
    DEVICE_PID_BASE,
    ProfileCapture,
    configure_capture,
    get_capture,
    notify_flush,
    parse_profile_dir,
)

__all__ = [
    "COMPILE_BUCKETS_S",
    "COMPILE_LEDGER",
    "CompileLedger",
    "DEVICE_PID_BASE",
    "DeviceSampler",
    "KINDS",
    "ProfileCapture",
    "SLO_LATENCY_BUCKETS_S",
    "attribute_spans",
    "bucket_percentile",
    "configure_capture",
    "cumulative_counts",
    "get_capture",
    "get_sampler",
    "mesh_scaling_loss",
    "nearest_rank",
    "notify_flush",
    "parse_profile_dir",
    "scaling_loss_breakdown",
    "start_sampler",
    "stop_sampler",
]


def get_sampler():
    """The process-wide DeviceSampler, or None before start_sampler()."""
    return _device_sampler.SAMPLER
