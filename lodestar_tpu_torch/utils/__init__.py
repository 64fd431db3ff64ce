"""Host utilities of the port: the typed error base and the job queue that
``chain/bls_pool`` accumulates batches in."""
