"""Repository: typed access to one bucket keyspace.

Reference: packages/db/src/abstractRepository.ts (get/put/has/delete/
getMany/keys/values with SSZ encode/decode at the boundary).
"""

from __future__ import annotations

from typing import Callable, Generic, Iterator, List, Optional, Tuple, TypeVar

from .controller import IDatabaseController
from .schema import Bucket, encode_key

T = TypeVar("T")


class Repository(Generic[T]):
    def __init__(
        self,
        db: IDatabaseController,
        bucket: Bucket,
        encode_value: Callable[[T], bytes],
        decode_value: Callable[[bytes], T],
    ):
        self.db = db
        self.bucket = bucket
        self.encode_value = encode_value
        self.decode_value = decode_value

    def _key(self, id_: bytes) -> bytes:
        return encode_key(self.bucket, id_)

    def get(self, id_: bytes) -> Optional[T]:
        raw = self.db.get(self._key(id_))
        return self.decode_value(raw) if raw is not None else None

    def get_binary(self, id_: bytes) -> Optional[bytes]:
        return self.db.get(self._key(id_))

    def has(self, id_: bytes) -> bool:
        return self.db.get(self._key(id_)) is not None

    def put(self, id_: bytes, value: T) -> None:
        self.db.put(self._key(id_), self.encode_value(value))

    def put_binary(self, id_: bytes, value: bytes) -> None:
        self.db.put(self._key(id_), value)

    def delete(self, id_: bytes) -> None:
        self.db.delete(self._key(id_))

    def batch_put(self, items: List[Tuple[bytes, T]]) -> None:
        self.db.batch_put([(self._key(i), self.encode_value(v)) for i, v in items])

    def batch_delete(self, ids: List[bytes]) -> None:
        self.db.batch_delete([self._key(i) for i in ids])

    def entries(self, reverse: bool = False, limit: Optional[int] = None) -> Iterator[Tuple[bytes, T]]:
        prefix = encode_key(self.bucket, b"")
        end = bytes([int(self.bucket) + 1])
        for k, v in self.db.entries(gte=prefix, lt=end, reverse=reverse, limit=limit):
            yield k[1:], self.decode_value(v)

    def keys(self, reverse: bool = False, limit: Optional[int] = None) -> Iterator[bytes]:
        for k, _ in self.entries(reverse=reverse, limit=limit):
            yield k

    def values(self, reverse: bool = False, limit: Optional[int] = None) -> Iterator[T]:
        for _, v in self.entries(reverse=reverse, limit=limit):
            yield v

    def first_value(self) -> Optional[T]:
        for v in self.values(limit=1):
            return v
        return None

    def last_value(self) -> Optional[T]:
        for v in self.values(reverse=True, limit=1):
            return v
        return None
