"""SSZ codec + merkleization (see core.py).

Reference analog: @chainsafe/ssz consumed by packages/types
(packages/types/src/sszTypes.ts:1-8) and everything above it.
"""

from .core import (  # noqa: F401
    BYTES_PER_CHUNK,
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    Fields,
    List,
    Root,
    SszType,
    Uint,
    Union,
    Vector,
    ZERO_HASHES,
    boolean,
    hash_pair,
    merkleize,
    mix_in_length,
    mix_in_selector,
    next_pow2,
    pack_bytes,
    set_hash_backend,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
