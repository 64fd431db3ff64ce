"""Host utilities of the port: the typed error base, the job queue that
``chain/bls_pool`` accumulates batches in, and the chain modules'
loggers (``logger.get_logger``)."""
