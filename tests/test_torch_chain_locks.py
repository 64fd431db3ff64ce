"""The chain's locks under the port's lock audit: the SQLite controller's
lock guards every statement on its shared connection (and stripping it
from one write turns the audit red), and the chain's import lock
serializes concurrent block imports in arrival order."""

import asyncio

from lodestar_tpu_torch.analysis import lock_audit
from lodestar_tpu_torch.analysis.report import format_report
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.config.chain_config import ChainConfig
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
from lodestar_tpu_torch.node.dev_chain import DevChain
from lodestar_tpu_torch.params import MINIMAL

CFG = ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                  MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16)


def test_db_controller_audit_is_clean(tmp_path):
    vs = lock_audit.audit_db_controller(str(tmp_path / "db.sqlite"))
    assert vs == [], format_report(vs)


def test_an_unlocked_put_on_the_shared_connection_is_flagged(tmp_path):
    def strip_put_lock(db):
        def unlocked_put(key, value):
            db._conn.execute("INSERT INTO kv (k, v) VALUES (?, ?) ON CONFLICT(k) DO UPDATE "
                             "SET v=excluded.v", (key, value))
            with db._lock:
                db._conn.commit()

        db.put = unlocked_put

    vs = lock_audit.audit_db_controller(str(tmp_path / "db.sqlite"),
                                        controller_mutator=strip_put_lock)
    # the unguarded statement is flagged at its first run (the race it
    # opens may also break a worker's statement: a harness error beside it)
    flagged = [v for v in vs if v.rule == "lock-unguarded-mutation"]
    assert [v.path for v in flagged] == ["lock-audit:SqliteDbController._conn"], \
        format_report(vs)
    assert flagged[0].message.startswith("execute")
    assert {v.rule for v in vs} <= {"lock-unguarded-mutation", "lock-audit-error"}


def test_the_import_lock_serializes_concurrent_imports_in_arrival_order():
    async def run():
        pool = BlsBatchPool(FastBlsVerifier(), max_buffer_wait=0.005)
        producer = DevChain(MINIMAL, CFG, 16, pool)
        blocks = [await producer.produce_and_import_block(slot) for slot in (1, 2, 3)]
        consumer = DevChain(MINIMAL, CFG, 16, pool)
        # each import awaits the pool while it holds the lock; the child
        # waits for its parent's import instead of failing on it
        roots = await asyncio.gather(*(consumer.chain.process_block(b) for b in blocks))
        assert roots[-1] == producer.chain.head_root == consumer.chain.head_root
        assert len(set(roots)) == 3
        pool.close()

    asyncio.run(run())
