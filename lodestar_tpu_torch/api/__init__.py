"""Beacon node REST API.

Reference surface: packages/api/src/beacon/routes/ (route definitions and
JSON casing rules) served by beacon-node/src/api/rest/index.ts:36 and
implemented against the chain in api/impl/.  The server here is a
dependency-free asyncio HTTP/1.1 implementation; route payloads follow the
eth2 API JSON conventions (snake_case keys, quoted uint64s, 0x-hex bytes).
"""

from .rest import RestApiServer  # noqa: F401
from .client import ApiClient  # noqa: F401
