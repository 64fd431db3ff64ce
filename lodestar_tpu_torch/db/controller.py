"""Database controllers: the IDatabaseController seam + two backends.

Reference: packages/db/src/controller/interface.ts:35 (get/put/delete/
batch/keys/values/entries with range filters) and controller/level.ts:31.
"""

from __future__ import annotations

import bisect
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Protocol, Sequence, Tuple


class IDatabaseController(Protocol):
    def get(self, key: bytes) -> Optional[bytes]: ...

    def put(self, key: bytes, value: bytes) -> None: ...

    def delete(self, key: bytes) -> None: ...

    def batch_put(self, items: Sequence[Tuple[bytes, bytes]]) -> None: ...

    def batch_delete(self, keys: Sequence[bytes]) -> None: ...

    def entries(
        self,
        gte: Optional[bytes] = None,
        lt: Optional[bytes] = None,
        reverse: bool = False,
        limit: Optional[int] = None,
    ) -> Iterator[Tuple[bytes, bytes]]: ...

    def close(self) -> None: ...


class MemoryDbController:
    """Sorted in-memory backend (tests / ephemeral dev chains)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        if key in self._data:
            del self._data[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def batch_put(self, items: Sequence[Tuple[bytes, bytes]]) -> None:
        for k, v in items:
            self.put(k, v)

    def batch_delete(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            self.delete(k)

    def entries(self, gte=None, lt=None, reverse=False, limit=None):
        lo = bisect.bisect_left(self._keys, gte) if gte is not None else 0
        hi = bisect.bisect_left(self._keys, lt) if lt is not None else len(self._keys)
        sel = self._keys[lo:hi]
        if reverse:
            sel = list(reversed(sel))
        if limit is not None:
            sel = sel[:limit]
        for k in sel:
            yield k, self._data[k]

    def close(self) -> None:
        pass


class MeteredDbController:
    """IDatabaseController decorator timing every operation into the
    metrics registry (lodestar.ts dbReadReq/dbWriteReq/dbReadItems
    analog) — wraps any backend without touching it."""

    def __init__(self, inner: IDatabaseController, metrics):
        self._inner = inner
        self._m = metrics

    def _timed(self, op: str, fn, *a):
        import time

        t0 = time.monotonic()
        try:
            return fn(*a)
        finally:
            self._m.db_ops_total.labels(op=op).inc()
            self._m.db_op_seconds.labels(op=op).observe(time.monotonic() - t0)

    def get(self, key):
        return self._timed("get", self._inner.get, key)

    def put(self, key, value):
        return self._timed("put", self._inner.put, key, value)

    def delete(self, key):
        return self._timed("delete", self._inner.delete, key)

    def batch_put(self, items):
        return self._timed("batch_put", self._inner.batch_put, items)

    def batch_delete(self, keys):
        return self._timed("batch_delete", self._inner.batch_delete, keys)

    def entries(self, gte=None, lt=None, reverse=False, limit=None):
        # materialize inside the timing window: generator pulls otherwise
        # escape the measurement entirely
        rows = self._timed(
            "entries", lambda: list(self._inner.entries(gte, lt, reverse, limit))
        )
        return iter(rows)

    def close(self) -> None:
        self._inner.close()


class SqliteDbController:
    """sqlite3-backed persistent backend.

    One WITHOUT ROWID table keyed on the raw bucket-prefixed key gives
    LevelDB-equivalent ordered iteration; WAL mode for concurrent readers.
    """

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
        )
        self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (key, value),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def batch_put(self, items: Sequence[Tuple[bytes, bytes]]) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                list(items),
            )
            self._conn.commit()

    def batch_delete(self, keys: Sequence[bytes]) -> None:
        with self._lock:
            self._conn.executemany("DELETE FROM kv WHERE k = ?", [(k,) for k in keys])
            self._conn.commit()

    def entries(self, gte=None, lt=None, reverse=False, limit=None):
        q = "SELECT k, v FROM kv"
        cond, params = [], []
        if gte is not None:
            cond.append("k >= ?")
            params.append(gte)
        if lt is not None:
            cond.append("k < ?")
            params.append(lt)
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY k DESC" if reverse else " ORDER BY k ASC"
        if limit is not None:
            q += f" LIMIT {int(limit)}"
        with self._lock:
            rows = self._conn.execute(q, params).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def close(self) -> None:
        with self._lock:
            self._conn.close()
