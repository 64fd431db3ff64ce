"""Execution-layer engine clients (bellatrix Engine API seam).

Reference: packages/beacon-node/src/execution/engine/ — http.ts:64 (the
JSON-RPC Engine API client), mock.ts:23 (accept-everything double used by
dev/test), disabled.ts (pre-merge).
"""

from .engine import (  # noqa: F401
    DisabledExecutionEngine,
    ExecutionEngineHttp,
    ExecutionEngineMock,
    ExecutePayloadStatus,
)
