"""ctypes binding for the port's copy of ``hashtree.c``: one merkle layer
of sha256 compressions per call, the layer hash of ``ssz/core.py``.

The counterpart of ``lodestar_tpu/native/hashtree.py``, over the copy of
``hashtree.c`` beside this file, built by ``native/fastbls.build`` as
``fastbls.c`` is: at first use ``cc -O3 -shared -fPIC`` compiles it into
``build/lodestar_tpu_torch/`` under the repository root, named by a hash
of the source and the flags, through a temporary file and an atomic
rename.  Before the library is used its layer hash is checked against
``hashlib`` on a probe.

There is no fallback: a failed build, load or self-check raises, and every
later call raises the same error.  Nothing is built or loaded when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import Optional

from . import fastbls

SOURCES = ("hashtree.c",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None


def build(cc: Optional[str] = None) -> str:
    """The library's path, compiled by ``fastbls.build`` (the same
    compiler, flags, build directory and naming) unless it exists."""
    return fastbls.build(cc, stem="hashtree", sources=SOURCES)


def load() -> ctypes.CDLL:
    """The built, self-checked library (built on the first call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(build())
            lib.hashtree_hash_layer.restype = None
            lib.hashtree_hash_layer.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            # the self-check: two 64-byte blocks against hashlib
            probe = bytes(range(128))
            out = ctypes.create_string_buffer(64)
            lib.hashtree_hash_layer(probe, 2, out)
            want = hashlib.sha256(probe[:64]).digest() + hashlib.sha256(probe[64:]).digest()
            if out.raw != want:
                raise RuntimeError("hashtree: the layer hash disagrees with hashlib; "
                                   "the library is not used")
        except (OSError, RuntimeError) as e:
            _error = e if isinstance(e, RuntimeError) else RuntimeError(f"hashtree: {e}")
            raise _error from e
        _lib = lib
        return lib


def hash_layer(data: bytes) -> bytes:
    """Hash consecutive 64-byte blocks into 32-byte digests (one merkle
    layer step)."""
    if len(data) % 64:
        raise ValueError(f"hashtree: a layer is whole 64-byte blocks, got {len(data)} bytes")
    n = len(data) // 64
    buf = ctypes.create_string_buffer(n * 32)
    load().hashtree_hash_layer(data, n, buf)
    return buf.raw
