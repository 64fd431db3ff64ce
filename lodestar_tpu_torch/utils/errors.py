"""Typed errors with structured metadata (the port's copy of the base).

Reference: packages/utils/src/errors.ts (LodestarError carries a typed
``.type`` object with a ``code`` discriminant; getMetadata for logging).
"""

from __future__ import annotations

from typing import Any, Dict


class LodestarError(Exception):
    """Base error carrying a ``type`` dict with a ``code`` discriminant."""

    def __init__(self, type_: Dict[str, Any], message: str | None = None):
        self.type = type_
        self.code = type_.get("code", "ERR_UNKNOWN")
        super().__init__(message or self.code)

    def get_metadata(self) -> Dict[str, Any]:
        return dict(self.type)
