"""The node's scheduling layer above the verifier boundary:
``bls_pool.BlsBatchPool`` merges concurrent verification jobs into batches."""
