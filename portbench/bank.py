"""Keys, signatures and the plain reference's pairing checks, in the frozen
C library beside this file (``native/fastbls.c``, a copy of the port's
``native/fastbls.c`` at the time the benchmark was written, kept here so
that no later change to the port moves the yardstick).

The library is built with ``cc`` into ``.build/`` inside this directory,
named by a hash of its sources and flags, through a temporary file and an
atomic rename; a run after the first loads it at once.  Nothing here
imports the port, ``jax`` or ``lodestar_tpu``.

The work runs in a pool of ``spawn`` worker processes (``worker_pool``):
``sign_tasks`` (one signature per task: a key, or the sum of several
keys, over one 32-byte root), ``public_keys`` (compressed keys of the
interop bank) and ``verify_tasks`` (each set's pairing equation alone,
exact: the plain reference).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import multiprocessing
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(HERE, "native")
BUILD_DIR = os.path.join(HERE, ".build")
SOURCES = ("fastbls.c", "fastbls_consts.h")
CFLAGS = ("-O3", "-shared", "-fPIC")

#: the subgroup order of BLS12-381
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(("cc",) + CFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpbfastbls_{h.hexdigest()[:16]}.so")


def build() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["cc", *CFLAGS, "-o", tmp, os.path.join(NATIVE_DIR, SOURCES[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The built library, self-tested (built on the first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        c = ctypes.CDLL(build())
        b = ctypes.c_char_p
        sz = ctypes.c_size_t
        for name, args in (
            ("fb_selftest", []),
            ("fb_sign", [b, b, b, sz]),
            ("fb_sign_aggregate", [b, b, sz, b, sz]),
            ("fb_sk_to_pk", [b, b]),
            ("fb_verify_one", [b, b, b]),
            ("fb_aggregate_sigs", [sz, b, b]),
            ("fb_batch_verify", [sz, b, ctypes.POINTER(ctypes.c_uint32), b, b,
                                 ctypes.POINTER(ctypes.c_uint64)]),
        ):
            fn = getattr(c, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        if c.fb_selftest() != 1:
            raise RuntimeError("portbench fastbls: fb_selftest failed")
        _lib = c
        return c


# -- keys -------------------------------------------------------------------


def interop_sk(index: int) -> int:
    """The eth2 interop secret key of ``index``: int(LE(sha256(LE32(i))))
    mod r."""
    digest = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return int.from_bytes(digest, "little") % R


def sk_bytes(sk: int) -> bytes:
    return sk.to_bytes(32, "big")


def sk_to_pk(sk: int) -> bytes:
    out = ctypes.create_string_buffer(48)
    if lib().fb_sk_to_pk(out, sk_bytes(sk)) != 1:
        raise ValueError("fb_sk_to_pk refused the key")
    return out.raw


def sign(sk: int, root: bytes) -> bytes:
    out = ctypes.create_string_buffer(96)
    if lib().fb_sign(out, sk_bytes(sk), root, len(root)) != 1:
        raise ValueError("fb_sign refused the key")
    return out.raw


def sign_sum(sks: Sequence[int], root: bytes) -> bytes:
    """One signature by the sum of ``sks`` over ``root``: byte-identical to
    the aggregate of each key's signature."""
    if len(sks) == 1:
        return sign(sks[0], root)
    blob = b"".join(sk_bytes(k) for k in sks)
    out = ctypes.create_string_buffer(96)
    if lib().fb_sign_aggregate(out, blob, len(sks), root, len(root)) != 1:
        raise ValueError("fb_sign_aggregate refused the keys")
    return out.raw


def add_signatures(sigs: Sequence[bytes]) -> bytes:
    out = ctypes.create_string_buffer(96)
    if lib().fb_aggregate_sigs(len(sigs), b"".join(sigs), out) != 1:
        raise ValueError("fb_aggregate_sigs refused a signature")
    return out.raw


def negate_signature(sig: bytes) -> bytes:
    """-S in the ZCash compressed encoding: the y-sign flag flipped (S not
    at infinity)."""
    if sig[0] & 0x40:
        raise ValueError("the point at infinity has no sign to flip")
    return bytes([sig[0] ^ 0x20]) + sig[1:]


def verify_one(pk: bytes, root: bytes, sig: bytes) -> bool:
    """e(pk, H(root)) == e(g1, sig), exact: one set's equation alone, no
    random coefficient (a malformed key or signature reads False)."""
    return lib().fb_verify_one(pk, root, sig) == 1


def verify_sum(sets: Sequence[Tuple[Sequence[bytes], bytes, bytes]],
               coeffs: Sequence[int]) -> bool:
    """prod e(c_i pk_i, H(m_i)) == e(g1, sum c_i sig_i) over ``sets`` of
    (compressed keys, root, signature), pk_i the sum of set i's keys: the
    random linear combination with the given coefficients (a malformed
    key or signature reads False)."""
    n = len(sets)
    if n == 0:
        return False
    counts = (ctypes.c_uint32 * n)(*[len(s[0]) for s in sets])
    c_arr = (ctypes.c_uint64 * n)(*[c & 0xFFFFFFFFFFFFFFFF for c in coeffs])
    return lib().fb_batch_verify(
        n, b"".join(pk for s in sets for pk in s[0]), counts,
        b"".join(s[1] for s in sets), b"".join(s[2] for s in sets), c_arr) == 1


# -- worker tasks (module level: a spawn worker imports them) ---------------

_SKS: dict = {}


def _sk(index: int) -> int:
    sk = _SKS.get(index)
    if sk is None:
        sk = _SKS[index] = interop_sk(index)
    return sk


def public_keys(indices: Sequence[int]) -> List[bytes]:
    """The compressed public keys of interop keys ``indices``."""
    return [sk_to_pk(_sk(i)) for i in indices]


def sign_tasks(tasks: Sequence[Tuple[Tuple[int, ...], bytes]]) -> List[bytes]:
    """One signature per (key indices, root): the keys' sum signs."""
    return [sign_sum([_sk(i) for i in keys], root) for keys, root in tasks]


def verify_tasks(tasks: Sequence[Tuple[Tuple[int, ...], bytes, bytes]]) -> List[bool]:
    """The plain reference, per (key indices, root, signature): the set's
    public key is worked out again from the secret keys (the sum of an
    aggregate's keys, times g1), and its pairing equation is checked
    alone."""
    out = []
    for keys, root, sig in tasks:
        total = sum(_sk(i) for i in keys) % R
        out.append(total != 0 and verify_one(sk_to_pk(total), root, sig))
    return out


def _warm(_=None) -> int:
    lib()
    return os.getpid()


def worker_pool(workers: int) -> concurrent.futures.ProcessPoolExecutor:
    """A pool of ``workers`` spawn processes with the library loaded (the
    parent builds it first, so that the workers only load it)."""
    build()
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    list(pool.map(_warm, range(workers)))
    return pool


def run_chunked(pool, fn, items: Sequence, chunks: int) -> list:
    """``fn`` over ``items`` in ``chunks`` slices on ``pool``, the results
    in order."""
    if not items:
        return []
    step = max(1, -(-len(items) // chunks))
    futs = [pool.submit(fn, items[i:i + step]) for i in range(0, len(items), step)]
    out: list = []
    for f in futs:
        out.extend(f.result())
    return out
