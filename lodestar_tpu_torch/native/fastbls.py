"""ctypes binding for the port's copy of ``fastbls.c`` (native BLS12-381 in
portable C): the host final exponentiation of the split dispatch, the
batch verification behind ``crypto/bls/native_verifier.FastBlsVerifier``,
and the key surface of ``crypto/bls/api.py`` (signing, public keys,
aggregation).

The counterpart of ``lodestar_tpu/native/fastbls.py``, over the copies of
``fastbls.c`` and ``fastbls_consts.h`` beside this file.  At first use the
C source is compiled with ``cc -O3 -shared -fPIC`` into
``build/lodestar_tpu_torch/`` under the repository root, named by a hash
of the sources and the flags (an edited source rebuilds, an unchanged one
loads at once), through a temporary file and an atomic rename, so that
concurrent processes never load a half-written library.  ``fb_selftest()``
must pass before the library is used.

There is no fallback: a failed build, load or self-test raises, and every
later call raises the same error.  Nothing is built or loaded when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_REPO, "build", "lodestar_tpu_torch")
SOURCES = ("fastbls.c", "fastbls_consts.h")
CC = "cc"
CFLAGS = ("-O3", "-shared", "-fPIC")
#: bytes of an Fq12 blob: 12 components of 48 big-endian bytes, in tower
#: order (c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1)
FQ12_BYTES = 12 * 48

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None


def library_path(cc: Optional[str] = None, stem: str = "fastbls",
                 sources: Sequence[str] = SOURCES) -> str:
    """Where ``build`` puts the library of ``sources`` (the C file first,
    then the headers it includes) built by ``cc``: named by a hash of the
    compiler, the flags and the sources."""
    h = hashlib.sha256(" ".join((cc or CC,) + CFLAGS).encode())
    for name in sources:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(cc: Optional[str] = None, stem: str = "fastbls",
          sources: Sequence[str] = SOURCES) -> str:
    """Compile the library of ``sources`` (default: this module's) with
    ``cc`` (default ``CC``) unless one of these sources exists; return its
    path.  Raises with the compiler's output when the compiler fails or is
    missing.  ``native/hashtree.py`` builds its library here too."""
    cc = cc or CC
    out = library_path(cc, stem, sources)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cc, *CFLAGS, "-o", tmp, os.path.join(_HERE, sources[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{stem}: cannot run the C compiler {cc!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{stem}: {' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built, self-tested library (built on the first call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(build())
            lib.fb_selftest.restype = ctypes.c_int
            lib.fb_selftest.argtypes = []
            lib.fb_final_exp_is_one.restype = ctypes.c_int
            lib.fb_final_exp_is_one.argtypes = [ctypes.c_char_p]
            lib.fb_final_exp.restype = ctypes.c_int
            lib.fb_final_exp.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.fb_batch_verify.restype = ctypes.c_int
            lib.fb_batch_verify.argtypes = [
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.fb_sign.restype = ctypes.c_int
            lib.fb_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
            lib.fb_sign_ct.restype = ctypes.c_int
            lib.fb_sign_ct.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_size_t]
            lib.fb_sk_to_pk.restype = ctypes.c_int
            lib.fb_sk_to_pk.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.fb_sign_aggregate.restype = ctypes.c_int
            lib.fb_sign_aggregate.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                                              ctypes.c_char_p, ctypes.c_size_t]
            lib.fb_aggregate_sigs.restype = ctypes.c_int
            lib.fb_aggregate_sigs.argtypes = [ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p]
            lib.fb_aggregate_pubkeys_c.restype = ctypes.c_int
            lib.fb_aggregate_pubkeys_c.argtypes = [ctypes.c_size_t, ctypes.c_char_p,
                                                   ctypes.c_char_p]
            if lib.fb_selftest() != 1:
                raise RuntimeError("fastbls: fb_selftest failed; the library is not used")
        except (OSError, RuntimeError) as e:
            _error = e if isinstance(e, RuntimeError) else RuntimeError(f"fastbls: {e}")
            raise _error from e
        _lib = lib
        return lib


def _check(blob: bytes) -> None:
    if len(blob) != FQ12_BYTES:
        raise ValueError(f"fastbls: an Fq12 blob is {FQ12_BYTES} bytes, got {len(blob)}")


def final_exp_is_one(blob: bytes) -> bool:
    """f^(3 (p^12 - 1) / r) == 1 for the Fq12 f in ``blob`` (the cube of
    the final exponentiation: the verdict is the same, as gcd(3, r) = 1).
    Raises on a component that is not a canonical residue."""
    _check(blob)
    rc = load().fb_final_exp_is_one(blob)
    if rc < 0:
        raise ValueError("fastbls: an Fq12 component is not below p")
    return rc == 1


def final_exp(blob: bytes) -> bytes:
    """f^(3 (p^12 - 1) / r) as a blob of the same layout."""
    _check(blob)
    out = ctypes.create_string_buffer(FQ12_BYTES)
    if load().fb_final_exp(out, blob) < 0:
        raise ValueError("fastbls: an Fq12 component is not below p")
    return out.raw


def batch_verify(sets: Sequence[Tuple[List[bytes], bytes, bytes]],
                 coeffs: Sequence[int]) -> bool:
    """Random-linear-combination batch verification in C
    (``fb_batch_verify``), as the JAX binding's ``batch_verify``.  ``sets``:
    (compressed public keys, 32-byte signing root, 96-byte compressed
    signature); ``coeffs``: odd 64-bit coefficients, one per set.  False on
    malformed inputs or a failed verification; the library's build or
    self-test failure raises."""
    lib = load()
    n = len(sets)
    if n == 0:
        return False
    pk_blob = b"".join(pk for pks, _, _ in sets for pk in pks)
    counts = (ctypes.c_uint32 * n)(*[len(pks) for pks, _, _ in sets])
    msgs = b"".join(m for _, m, _ in sets)
    sigs = b"".join(sig for _, _, sig in sets)
    if len(msgs) != 32 * n or len(sigs) != 96 * n:
        return False
    c_arr = (ctypes.c_uint64 * n)(*[c & 0xFFFFFFFFFFFFFFFF for c in coeffs])
    return lib.fb_batch_verify(n, pk_blob, counts, msgs, sigs, c_arr) == 1


def _sk(sk32: bytes) -> bytes:
    if len(sk32) != 32:
        raise ValueError(f"fastbls: a secret key is 32 bytes, got {len(sk32)}")
    return sk32


def sign(sk32: bytes, msg: bytes) -> bytes:
    """sk * H(msg) as a compressed 96-byte signature by the variable-time
    sliding ladder (``fb_sign``: its branches follow the key's bits; for
    interop and test keys).  Raises for a scalar outside [1, r)."""
    out = ctypes.create_string_buffer(96)
    if load().fb_sign(out, _sk(sk32), msg, len(msg)) != 1:
        raise ValueError("fastbls: fb_sign refused the secret key")
    return out.raw


def sign_ct(sk32: bytes, msg: bytes) -> bytes:
    """The same bytes as ``sign`` by the fixed-length double-and-always-add
    ladder (``fb_sign_ct``: one operation sequence for every key)."""
    out = ctypes.create_string_buffer(96)
    if load().fb_sign_ct(out, _sk(sk32), msg, len(msg)) != 1:
        raise ValueError("fastbls: fb_sign_ct refused the secret key")
    return out.raw


def sign_aggregate(sks: Sequence[bytes], msg: bytes) -> Optional[bytes]:
    """One signature by n keys over one message (``fb_sign_aggregate``:
    one hash, one scalar multiplication by the keys' sum; variable time).
    None when the library refuses the keys: none given, one outside
    [1, r), or a sum of 0 mod r."""
    blob = b"".join(_sk(sk) for sk in sks)
    out = ctypes.create_string_buffer(96)
    if not sks or load().fb_sign_aggregate(out, blob, len(sks), msg, len(msg)) != 1:
        return None
    return out.raw


def sk_to_pk(sk32: bytes) -> bytes:
    """sk * g1 as a compressed 48-byte public key (``fb_sk_to_pk``)."""
    out = ctypes.create_string_buffer(48)
    if load().fb_sk_to_pk(out, _sk(sk32)) != 1:
        raise ValueError("fastbls: fb_sk_to_pk refused the secret key")
    return out.raw


def aggregate_sigs(sigs: Sequence[bytes]) -> Optional[bytes]:
    """The sum of compressed signatures, compressed (``fb_aggregate_sigs``);
    None when the library rejects one of them as no point of E2."""
    blob = b"".join(sigs)
    if len(blob) != 96 * len(sigs):
        raise ValueError("fastbls: a compressed signature is 96 bytes")
    out = ctypes.create_string_buffer(96)
    if load().fb_aggregate_sigs(len(sigs), blob, out) != 1:
        return None
    return out.raw


def aggregate_pks(pks: Sequence[bytes]) -> Optional[bytes]:
    """The sum of compressed public keys, compressed
    (``fb_aggregate_pubkeys_c``); None when the library rejects one of them
    as no point of E1."""
    blob = b"".join(pks)
    if len(blob) != 48 * len(pks):
        raise ValueError("fastbls: a compressed public key is 48 bytes")
    out = ctypes.create_string_buffer(48)
    if load().fb_aggregate_pubkeys_c(len(pks), blob, out) != 1:
        return None
    return out.raw
