"""SSZ: SimpleSerialize codec + merkleization.

The state representation layer — the analog of @chainsafe/ssz +
@chainsafe/persistent-merkle-tree (+ as-sha256 WASM hashing) that the whole
reference stands on (SURVEY.md §2.9; packages/types/src/sszTypes.ts
consumes it).  Redesign notes vs the reference:

- The reference's ViewDU persistent-tree views exist to make *mutation*
  cheap in a GC'd runtime.  This package keeps hot state columns in flat
  numpy arrays inside the state-transition caches instead (SURVEY §7 hard
  part 3); SSZ here is the canonical codec + hashing layer, not the mutable
  working representation.
- Merkleization hashes layer-by-layer over contiguous byte buffers, so the
  inner loop is a flat sequence of sha256 compressions, one C call a layer
  (``native/hashtree.c``, built at the first hash; a failed build or
  self-check raises).  ``set_hash_backend`` installs another layer hash.

Types are *type objects* (instances of SszType subclasses); values are
plain Python data (int/bool/bytes/list/Fields).  Every type implements:
serialize, deserialize, hash_tree_root, default, is_fixed_size/fixed_size.

Spec: consensus-spec ssz/simple-serialize.md (v1.1.10, same as the
reference's README.md:10 pin).
"""

from __future__ import annotations

import hashlib
import io
import struct
from typing import Any, Dict, List as PyList, Optional, Sequence, Tuple

from ..native import hashtree as _native_hashtree

BYTES_PER_CHUNK = 32
OFFSET_SIZE = 4


# ---------------------------------------------------------------------------
# hashing backend (the native layer hash; pluggable)
# ---------------------------------------------------------------------------

#: the layer hash: ``native/hashtree.hash_layer`` (built and self-checked at
#: its first call, so importing this module starts no compiler; a failed
#: build or self-check raises)
_hash_layer = _native_hashtree.hash_layer


def set_hash_backend(fn) -> None:
    """Install a layer-hash backend: fn(bytes of concatenated 64-byte
    pairs) -> bytes of concatenated 32-byte digests."""
    global _hash_layer
    _hash_layer = fn


def hash_pair(a: bytes, b: bytes) -> bytes:
    return _hash_layer(a + b)


# zero-subtree hashes: ZERO_HASHES[d] = root of an all-zero depth-d tree
ZERO_HASHES: PyList[bytes] = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest())


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Merkle root of chunks, virtually padded with zero chunks to
    next_pow2(limit or len).  Zero subtrees are folded in via ZERO_HASHES —
    a list with limit 2^40 costs its live chunks only."""
    count = len(chunks)
    if limit is not None and count > limit:
        raise ValueError(f"too many chunks: {count} > limit {limit}")
    width = next_pow2(limit if limit is not None else count)
    depth = (width - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    layer = b"".join(chunks)
    for d in range(depth):
        n = len(layer) // 32
        if n % 2:
            layer += ZERO_HASHES[d]
            n += 1
        layer = _hash_layer(layer)
    return layer


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))


def _pack_basic_list(elem: "SszType", value) -> bytes:
    """Serialize a homogeneous basic-type list to its packed byte body.
    uint64 lists (balances: 250k+ entries every state root) go through a
    single numpy tobytes instead of 250k int.to_bytes calls."""
    if value and isinstance(elem, Uint) and elem.byte_len == 8:
        import numpy as _np

        try:
            return _np.asarray(value, dtype=_np.uint64).tobytes()
        except (OverflowError, TypeError, ValueError):
            pass  # odd inputs (e.g. mixed types) take the slow path
    return b"".join(elem.serialize(v) for v in value)


def pack_bytes(data: bytes) -> PyList[bytes]:
    """Right-pad to a chunk multiple and split into 32-byte chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i : i + 32] for i in range(0, len(data), 32)]


# ---------------------------------------------------------------------------
# type objects
# ---------------------------------------------------------------------------


class SszType:
    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError

    # equality helper for tests
    def value_eq(self, a, b) -> bool:
        return self.serialize(a) == self.serialize(b)


class Uint(SszType):
    def __init__(self, byte_len: int):
        if byte_len not in (1, 2, 4, 8, 16, 32):
            raise ValueError("invalid uint size")
        self.byte_len = byte_len

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.byte_len

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.byte_len, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.byte_len:
            raise ValueError("uint length mismatch")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self) -> int:
        return 0


class Boolean(SszType):
    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean encoding")

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self) -> bool:
        return False


class ByteVector(SszType):
    def __init__(self, length: int):
        self.length = length

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.length

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}] got {len(value)} bytes")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise ValueError("ByteVector length mismatch")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length


class ByteList(SszType):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = self.serialize(value)
        limit_chunks = (self.limit + 31) // 32
        return mix_in_length(merkleize(pack_bytes(value), limit_chunks), len(value))

    def default(self) -> bytes:
        return b""


class Vector(SszType):
    def __init__(self, elem: SszType, length: int):
        if length <= 0:
            raise ValueError("Vector length must be positive")
        self.elem = elem
        self.length = length

    def is_fixed_size(self):
        return self.elem.is_fixed_size()

    def fixed_size(self):
        return self.elem.fixed_size() * self.length

    def serialize(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("Vector length mismatch")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        return _deserialize_homogeneous(self.elem, data, exact_count=self.length)

    def hash_tree_root(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("Vector length mismatch")
        if isinstance(self.elem, (Uint, Boolean)):
            return merkleize(pack_bytes(_pack_basic_list(self.elem, value)))
        return merkleize([self.elem.hash_tree_root(v) for v in value])

    def default(self):
        return [self.elem.default() for _ in range(self.length)]


class List(SszType):
    def __init__(self, elem: SszType, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("List over limit")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_homogeneous(self.elem, data, exact_count=None)
        if len(out) > self.limit:
            raise ValueError("List over limit")
        return out

    def hash_tree_root(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("List over limit")
        if isinstance(self.elem, (Uint, Boolean)):
            body = _pack_basic_list(self.elem, value)
            limit_chunks = (self.limit * self.elem.fixed_size() + 31) // 32
            root = merkleize(pack_bytes(body), limit_chunks)
        else:
            root = merkleize([self.elem.hash_tree_root(v) for v in value], self.limit)
        return mix_in_length(root, len(value))

    def default(self):
        return []


class Bitvector(SszType):
    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("Bitvector length must be positive")
        self.length = length

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def serialize(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("Bitvector length mismatch")
        out = bytearray((self.length + 7) // 8)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size():
            raise ValueError("Bitvector length mismatch")
        if self.length % 8:
            if data[-1] >> (self.length % 8):
                raise ValueError("Bitvector has bits beyond length")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(self.length)]

    def hash_tree_root(self, value) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self):
        return [False] * self.length


class Bitlist(SszType):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("Bitlist over limit")
        n = len(value)
        out = bytearray(n // 8 + 1)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        out[n // 8] |= 1 << (n % 8)  # delimiter bit
        return bytes(out)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("Bitlist needs at least the delimiter byte")
        if data[-1] == 0:
            raise ValueError("Bitlist missing delimiter bit")
        last = data[-1]
        top = last.bit_length() - 1
        n = (len(data) - 1) * 8 + top
        if n > self.limit:
            raise ValueError("Bitlist over limit")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(n)]

    def hash_tree_root(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("Bitlist over limit")
        out = bytearray((len(value) + 7) // 8)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        limit_chunks = (self.limit + 255) // 256
        return mix_in_length(merkleize(pack_bytes(bytes(out)), limit_chunks), len(value))

    def default(self):
        return []


class Fields:
    """Container value: attribute access over an ordered field dict.

    ``_htr`` memoizes the hash-tree-root for SCALAR-ONLY containers
    (Container.hash_tree_root decides eligibility): any attribute/item
    write invalidates it.  This is the flat-value answer to the
    reference's persistent-merkle-tree structural sharing — a 250k-entry
    validator registry re-roots in the hashes of its few dirty entries
    instead of all of them."""

    __slots__ = ("_d", "_htr")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_d", dict(kwargs))
        object.__setattr__(self, "_htr", None)

    def __getattr__(self, k):
        # robust under copy/pickle: _d may not exist yet, and dunder probes
        # (__deepcopy__, __getstate__, ...) must fail cleanly
        try:
            d = object.__getattribute__(self, "_d")
        except AttributeError:
            raise AttributeError(k) from None
        try:
            return d[k]
        except KeyError:
            raise AttributeError(k) from None

    def __getstate__(self):
        return object.__getattribute__(self, "_d")

    def __setstate__(self, state):
        object.__setattr__(self, "_d", state)
        object.__setattr__(self, "_htr", None)

    def __setattr__(self, k, v):
        self._d[k] = v
        object.__setattr__(self, "_htr", None)

    def __delattr__(self, k):
        try:
            del self._d[k]
        except KeyError:
            raise AttributeError(k) from None
        object.__setattr__(self, "_htr", None)

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v
        object.__setattr__(self, "_htr", None)

    def __contains__(self, k):
        return k in self._d

    def keys(self):
        return self._d.keys()

    def copy(self) -> "Fields":
        return Fields(**self._d)

    def __repr__(self):  # pragma: no cover
        inner = ", ".join(f"{k}={v!r}" for k, v in list(self._d.items())[:6])
        more = "..." if len(self._d) > 6 else ""
        return f"Fields({inner}{more})"


class Container(SszType):
    def __init__(self, name: str, fields: Sequence[Tuple[str, SszType]]):
        self.name = name
        self.fields = list(fields)

    def is_fixed_size(self):
        return all(t.is_fixed_size() for _, t in self.fields)

    def fixed_size(self):
        return sum(t.fixed_size() for _, t in self.fields)

    def serialize(self, value) -> bytes:
        fixed_parts: PyList[Optional[bytes]] = []
        variable_parts: PyList[bytes] = []
        for fname, ftype in self.fields:
            v = value[fname] if not isinstance(value, dict) else value[fname]
            if ftype.is_fixed_size():
                fixed_parts.append(ftype.serialize(v))
                variable_parts.append(b"")
            else:
                fixed_parts.append(None)
                variable_parts.append(ftype.serialize(v))
        fixed_len = sum(len(p) if p is not None else OFFSET_SIZE for p in fixed_parts)
        out = io.BytesIO()
        offset = fixed_len
        for p, vp in zip(fixed_parts, variable_parts):
            if p is not None:
                out.write(p)
            else:
                out.write(struct.pack("<I", offset))
                offset += len(vp)
        for vp in variable_parts:
            out.write(vp)
        return out.getvalue()

    def deserialize(self, data: bytes):
        pos = 0
        offsets: PyList[Tuple[str, SszType, int]] = []
        values: Dict[str, Any] = {}
        for fname, ftype in self.fields:
            if ftype.is_fixed_size():
                size = ftype.fixed_size()
                values[fname] = ftype.deserialize(data[pos : pos + size])
                pos += size
            else:
                (off,) = struct.unpack("<I", data[pos : pos + 4])
                offsets.append((fname, ftype, off))
                pos += 4
        if offsets:
            if offsets[0][2] != pos:
                raise ValueError("first offset does not point at end of fixed part")
            ends = [off for _, _, off in offsets[1:]] + [len(data)]
            for (fname, ftype, off), end in zip(offsets, ends):
                if end < off:
                    raise ValueError("offsets not monotonic")
                values[fname] = ftype.deserialize(data[off:end])
        elif pos != len(data):
            raise ValueError("trailing bytes in fixed-size container")
        return Fields(**values)

    def hash_tree_root(self, value) -> bytes:
        # memoized fast path: a Fields whose values are ALL scalars
        # (int/bytes/bool) cannot be mutated behind our back — nested
        # lists/Fields could, so only the leaf-container shape is cached
        cacheable = isinstance(value, Fields)
        if cacheable:
            cached = object.__getattribute__(value, "_htr")
            if cached is not None and cached[0] is self:
                return cached[1]
        roots = [ftype.hash_tree_root(value[fname]) for fname, ftype in self.fields]
        root = merkleize(roots)
        if cacheable and all(
            isinstance(v, (int, bytes, bool))
            for v in object.__getattribute__(value, "_d").values()
        ):
            object.__setattr__(value, "_htr", (self, root))
        return root

    def get_field_proof(self, value, field_name: str):
        """Merkle branch proving `field_name`'s subtree root against this
        container's hash_tree_root.

        Returns (field_root, branch) with branch bottom-up — the sibling
        hashes along the path in the zero-padded power-of-two tree of field
        roots (the light-client protocol's proof shape; spec
        is_valid_merkle_branch consumes it as-is)."""
        idx = next(i for i, (f, _) in enumerate(self.fields) if f == field_name)
        roots = [ftype.hash_tree_root(value[fname]) for fname, ftype in self.fields]
        n = 1
        while n < len(roots):
            n *= 2
        layer = roots + [ZERO_HASHES[0]] * (n - len(roots))
        field_root = roots[idx]
        branch = []
        pos = idx
        depth = 0
        while len(layer) > 1:
            branch.append(layer[pos ^ 1])
            nxt = []
            for i in range(0, len(layer), 2):
                nxt.append(hashlib.sha256(layer[i] + layer[i + 1]).digest())
            layer = nxt
            pos //= 2
            depth += 1
        return field_root, branch

    def default(self) -> Fields:
        return Fields(**{fname: ftype.default() for fname, ftype in self.fields})


class Union(SszType):
    """SSZ union: value is a (selector, inner_value) tuple."""

    def __init__(self, options: Sequence[Optional[SszType]]):
        if not options or len(options) > 128:
            raise ValueError("invalid union arity")
        if options[0] is None and len(options) == 1:
            raise ValueError("None-only union")
        self.options = list(options)

    def is_fixed_size(self):
        return False

    def serialize(self, value) -> bytes:
        sel, inner = value
        opt = self.options[sel]
        if opt is None:
            if inner is not None:
                raise ValueError("None option with a value")
            return bytes([sel])
        return bytes([sel]) + opt.serialize(inner)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("empty union")
        sel = data[0]
        if sel >= len(self.options):
            raise ValueError("union selector out of range")
        opt = self.options[sel]
        if opt is None:
            if len(data) != 1:
                raise ValueError("trailing bytes after None option")
            return (sel, None)
        return (sel, opt.deserialize(data[1:]))

    def hash_tree_root(self, value) -> bytes:
        sel, inner = value
        opt = self.options[sel]
        root = b"\x00" * 32 if opt is None else opt.hash_tree_root(inner)
        return mix_in_selector(root, sel)

    def default(self):
        opt = self.options[0]
        return (0, None if opt is None else opt.default())


# ---------------------------------------------------------------------------
# homogeneous sequence helpers
# ---------------------------------------------------------------------------


def _serialize_homogeneous(elem: SszType, values) -> bytes:
    if elem.is_fixed_size():
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    out = io.BytesIO()
    offset = OFFSET_SIZE * len(parts)
    for p in parts:
        out.write(struct.pack("<I", offset))
        offset += len(p)
    for p in parts:
        out.write(p)
    return out.getvalue()


def _deserialize_homogeneous(elem: SszType, data: bytes, exact_count: Optional[int]):
    if elem.is_fixed_size():
        size = elem.fixed_size()
        if len(data) % size:
            raise ValueError("sequence length not a multiple of element size")
        n = len(data) // size
        if exact_count is not None and n != exact_count:
            raise ValueError("fixed sequence count mismatch")
        return [elem.deserialize(data[i * size : (i + 1) * size]) for i in range(n)]
    if not data:
        if exact_count not in (None, 0):
            raise ValueError("empty data for non-empty vector")
        return []
    (first_off,) = struct.unpack("<I", data[:4])
    if first_off % OFFSET_SIZE or first_off == 0:
        raise ValueError("bad first offset")
    n = first_off // OFFSET_SIZE
    if exact_count is not None and n != exact_count:
        raise ValueError("variable sequence count mismatch")
    offsets = [struct.unpack("<I", data[i * 4 : i * 4 + 4])[0] for i in range(n)]
    offsets.append(len(data))
    out = []
    for i in range(n):
        if offsets[i + 1] < offsets[i]:
            raise ValueError("offsets not monotonic")
        out.append(elem.deserialize(data[offsets[i] : offsets[i + 1]]))
    return out


# common instances
uint8 = Uint(1)
uint16 = Uint(2)
uint32 = Uint(4)
uint64 = Uint(8)
uint128 = Uint(16)
uint256 = Uint(32)
boolean = Boolean()
Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)
Root = Bytes32
