"""Durable store of built kernel libraries (the port's counterpart of the
JAX package's ``aot``): the library nvcc built, kept across processes so
that a restart, or a host without nvcc, loads it instead of building it.
See ``store.py`` for the key schema and the crash-consistency discipline."""

from .store import (  # noqa: F401
    AOT_STORE,
    STORE_ENV,
    AotStoreMiss,
    KernelLibraryStore,
    active_store,
    capability_tag,
    entry_key,
)
