"""The chain: ``beacon_chain.BeaconChain`` (block import with one
signature-set job a block, range-sync segments, fork choice, the state
caches and regen, the op pools) over the scheduling layer above the
verifier boundary, ``bls_pool.BlsBatchPool``, which merges concurrent
verification jobs into batches."""
