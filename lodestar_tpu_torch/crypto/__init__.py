"""Host-side cryptography of the port: the BLS oracle and verifier boundary."""
