"""Host utilities of the port: the typed error base, the job queue that
``chain/bls_pool`` accumulates batches in, the chain modules' loggers
(``logger.get_logger``), the byte helpers (``bytes``), the retry loop
(``retry``) and the snappy codec of the wire (``snappy``)."""

from .bytes import (  # noqa: F401
    bytes32_equal,
    bytes_to_int,
    from_hex,
    int_to_bytes,
    to_hex,
)
