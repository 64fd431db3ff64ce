"""FastBlsVerifier: the native-C CPU verifier behind the verifier boundary
(the port's copy of the JAX package's ``crypto/bls/native_verifier.py``).

The blst-class CPU path over the port's copy of ``fastbls.c``
(``native/fastbls``): random-linear-combination batch verification of
signature sets in portable C.  It is the CLI's ``--bls-verifier native``
choice.  There is no fallback: the library is built and self-tested when
the verifier is made, and a failed build raises there (the JAX verifier
falls back to the Python oracle instead).
"""

from __future__ import annotations

import secrets
from typing import Sequence

from ...native import fastbls
from .verifier import AggregatedSignatureSet, SignatureSet, SingleSignatureSet


class FastBlsVerifier:
    """The verifier boundary over ``native/fastbls.batch_verify``."""

    def __init__(self) -> None:
        fastbls.load()  # a failed build or self-test raises here
        self.batch_retries = 0
        self.sets_verified = 0

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        if not sets:
            # the boundary's contract (TorchBlsVerifier, PyBlsVerifier and
            # BlsBatchPool raise too; the reference throws)
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        packed = []
        for s in sets:
            if isinstance(s, SingleSignatureSet):
                pks = [s.pubkey.to_bytes()]
            elif isinstance(s, AggregatedSignatureSet):
                if not s.pubkeys:
                    return False
                pks = [pk.to_bytes() for pk in s.pubkeys]
            else:  # pragma: no cover - defensive
                return False
            if len(s.signing_root) != 32 or len(s.signature) != 96:
                return False
            packed.append((pks, s.signing_root, s.signature))
        coeffs = [secrets.randbits(64) | 1 for _ in packed]
        out = fastbls.batch_verify(packed, coeffs)
        if out:
            self.sets_verified += len(packed)
        else:
            self.batch_retries += 1
        return out

    def close(self) -> None:
        return None
