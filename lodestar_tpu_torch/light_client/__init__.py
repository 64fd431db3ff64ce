"""Light client package: follow the chain through sync-committee updates.

Reference: packages/light-client/src/index.ts:110 (Lightclient class) and
its spec core (processLightClientUpdate / validateLightClientUpdate).
"""

from .client import LightClient, LightClientError  # noqa: F401
