"""Key-value database abstraction + beacon repositories.

Reference: packages/db (controller/interface.ts:35 IDatabaseController,
controller/level.ts LevelDbController, abstractRepository.ts, schema.ts)
and packages/beacon-node/src/db (BeaconDb + 17 repositories).

Backend choice: the reference binds LevelDB (C++).  Here the persistent
backend is sqlite3 (the C storage engine shipped with CPython): same
ordered-key semantics (BTree), real durability, zero external deps.  A
memory backend serves tests and ephemeral dev chains.
"""

from .controller import IDatabaseController, MemoryDbController, SqliteDbController  # noqa: F401
from .schema import Bucket  # noqa: F401
from .repository import Repository  # noqa: F401
from .beacon import BeaconDb  # noqa: F401
