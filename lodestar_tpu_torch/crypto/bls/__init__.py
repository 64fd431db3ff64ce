"""BLS12-381 for the ETH2 proof-of-possession ciphersuite (the port's copy
of the bigint oracle) and the CUDA-backed ``TorchBlsVerifier``
(``crypto/bls/torch_verifier.py``, imported from there)."""

from .api import PublicKey, SecretKey, Signature, interop_secret_key
from .verifier import (
    AggregatedSignatureSet,
    PointCache,
    SignatureSet,
    SingleSignatureSet,
    get_aggregated_pubkey,
)

__all__ = [
    "PublicKey",
    "SecretKey",
    "Signature",
    "interop_secret_key",
    "AggregatedSignatureSet",
    "PointCache",
    "SignatureSet",
    "SingleSignatureSet",
    "get_aggregated_pubkey",
]
