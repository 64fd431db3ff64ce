"""TorchBlsVerifier: batched BLS signature-set verification on CUDA cards.

The port's verifier boundary (``verify_signature_sets(sets) -> bool``): the
host packs a batch into padded digit arrays (``pack``), and the device runs
one of two programs, both with the final exponentiation on the card:

- ``fused=True`` (the default): the fused program
  (``ops/fused_verify.verify_signature_sets_fused``);
- ``fused=False``: the XLA-graph program
  (``ops/batch_verify.verify_signature_sets_kernel``), which the JAX
  package runs on every backend but a TPU.

With ``devices=[...]`` (a card may repeat: logical shards) the verifier
has two tiers, as the JAX verifier's pool does: a batch whose bucket is at
least ``sharded_min_batch`` and divisible by the shard count rides the
sharded tier (``ops/sharded_verify``, one batch split over every shard);
any other batch runs whole on one card, round-robin over the distinct
cards.  The choices are the caller's.  A failed launch raises; there is no
other path or tier to fall back to.
"""

from __future__ import annotations

import secrets
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ...ops import limbs as fl
from ...ops.batch_verify import verify_signature_sets_kernel
from ...ops.fused_verify import from_packed, verify_signature_sets_fused
from ...ops.htc import hash_to_field_limbs
from ...ops.sharded_verify import verify_signature_sets_sharded
from .curve import g2_from_bytes, to_affine_batch
from .verifier import PointCache, SignatureSet, SingleSignatureSet, get_aggregated_pubkey

# Padding buckets: the smallest that fits the batch is used.  128 is the
# node's MAX_SIGNATURE_SETS_PER_JOB; larger buckets amortize sync batches.
BUCKETS = (4, 16, 64, 128, 256)


class TorchBlsVerifier:
    """Verifies signature sets on ``device`` (the card unless the caller
    asks for ``"cpu"``, which runs the kernels' plain versions), or on the
    shards of ``devices``.

    ``fused``: the fused program (True) or the XLA-graph program (False).
    ``rng``: a ``numpy.random.Generator`` for the RLC coefficients, for
    reproducible runs; None (the default) draws them from ``secrets``.
    ``devices``: the shards of the sharded tier, in mesh order (None: the
    single ``device``).  ``sharded``: the tier on or off (None: on when
    ``devices`` has two or more entries).  ``sharded_min_batch``: the
    smallest bucket the tier takes (None: the largest bucket).
    ``sharded_combine``: ``"all_gather"`` or ``"ring"``."""

    def __init__(self, device="cuda", rng: Optional[np.random.Generator] = None,
                 fused: bool = True, devices: Optional[Sequence] = None,
                 sharded: Optional[bool] = None, sharded_min_batch: Optional[int] = None,
                 sharded_combine: str = "all_gather"):
        self.point_cache = PointCache()
        self.rng = rng
        self.fused = fused
        if devices is None:
            self.devices = [resolve_device(device)]
        elif not devices:
            raise ValueError("devices: at least one device")
        else:
            self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        self.sharded = len(self.devices) >= 2 if sharded is None else bool(sharded)
        self.sharded_min_batch = BUCKETS[-1] if sharded_min_batch is None else sharded_min_batch
        self._mesh_program = (
            verify_signature_sets_sharded(self.devices, fused, sharded_combine)
            if self.sharded else None
        )
        #: the shard count of the sharded tier (0 when it is off)
        self.mesh_devices = len(self.devices) if self.sharded else 0
        #: batches the sharded tier verified
        self.sharded_batches = 0
        # the per-card tier: the distinct cards of ``devices``, in order
        self._cards = list(dict.fromkeys(self.devices))
        self._next_card = 0

    def verify_signature_sets(self, sets: Sequence[SignatureSet]) -> bool:
        """True iff every set verifies.  Batches above the largest bucket
        are verified in chunks of that size; every chunk is enqueued before
        any verdict is read."""
        if not sets:
            raise ValueError("verify_signature_sets: empty batch of signature sets")
        largest = BUCKETS[-1]
        chunks = [sets[i : i + largest] for i in range(0, len(sets), largest)]
        verdicts = []
        for chunk in chunks:
            packed = self.pack(chunk)
            if packed is None:
                return False  # malformed bytes or a point at infinity
            verdicts.append(self.dispatch(packed))
        return all(bool(v) for v in verdicts)

    def sharded_eligible(self, bucket: int) -> bool:
        """A bucket rides the sharded tier: the tier is on, the bucket is at
        least ``sharded_min_batch`` and splits evenly over the shards."""
        return (self.sharded and bucket >= self.sharded_min_batch
                and bucket % len(self.devices) == 0)

    @property
    def shard_enqueue_walls(self) -> List[float]:
        """Host seconds each shard took to enqueue its slice of the last
        sharded batch (empty when the tier is off or has not run)."""
        return list(self._mesh_program.mesh.enqueue_walls) if self._mesh_program else []

    def dispatch(self, packed) -> torch.Tensor:
        """Enqueue one packed batch; returns the verdict as a bool scalar
        tensor on the card that holds it (reading it is the only
        synchronisation)."""
        if self.sharded_eligible(packed[0].shape[0]):
            self.sharded_batches += 1
            return self._mesh_program(*packed)
        dev = self._cards[self._next_card % len(self._cards)]
        self._next_card += 1
        program = verify_signature_sets_fused if self.fused else verify_signature_sets_kernel
        return program(*from_packed(packed, dev))

    def _coefficients(self, b: int) -> np.ndarray:
        """b fresh odd 64-bit RLC coefficients."""
        if self.rng is None:
            coeffs = np.frombuffer(secrets.token_bytes(8 * b), dtype=np.uint64)
        else:
            coeffs = self.rng.integers(0, np.iinfo(np.uint64).max, size=b,
                                       dtype=np.uint64, endpoint=True)
        return coeffs | np.uint64(1)

    def pack(self, sets: Sequence[SignatureSet]):
        """Host packing: the 7-tuple (pk_x, pk_y, sig_x, sig_y, msg_u, bits,
        mask) of numpy arrays padded to the bucket, or None when a set is
        malformed (bad bytes, a key or signature at infinity).

        Affine coordinates come from ``point_cache`` or, on a miss, from one
        batch inversion per coordinate family.  Signatures are decompressed
        without a subgroup check: the device does that check, batched."""
        n = len(sets)
        if n > BUCKETS[-1]:
            raise ValueError(f"pack: {n} sets exceed the largest bucket {BUCKETS[-1]}")
        b = next(b for b in BUCKETS if n <= b)
        cache = self.point_cache
        pk_vals: List[Optional[tuple]] = [None] * n
        sig_vals: List[Optional[tuple]] = [None] * n
        pk_miss: List[tuple] = []  # (index, jacobian point, cache key | None)
        sig_miss: List[tuple] = []
        msgs: List[bytes] = []
        for i, s in enumerate(sets):
            if isinstance(s, SingleSignatureSet):
                pk_key = s.pubkey._raw
                if pk_key is not None:
                    pk_key = b"P" + pk_key
            else:
                pk_key = b"A" + b"".join(m.to_bytes() for m in s.pubkeys)
            hit = cache.get(pk_key) if pk_key is not None else None
            if hit is not None:
                pk_vals[i] = hit
            else:
                pk = get_aggregated_pubkey(s)
                if pk.is_infinity():
                    return None
                pk_miss.append((i, pk.point, pk_key))
            raw = s.signature
            hit = cache.get(b"S" + raw)
            if hit is not None:
                sig_vals[i] = hit
            else:
                try:
                    sig_pt = g2_from_bytes(raw, subgroup_check=False)
                except ValueError:
                    return None
                if sig_pt.is_infinity():
                    return None
                sig_miss.append((i, sig_pt, b"S" + raw))
            msgs.append(s.signing_root)
        for missed, vals in ((pk_miss, pk_vals), (sig_miss, sig_vals)):
            aff = to_affine_batch([pt for _, pt, _ in missed])
            for (i, _pt, key), (x, y) in zip(missed, aff):
                if hasattr(x, "n"):  # Fq (G1 pubkey)
                    val = (x.n, y.n)
                else:  # Fq2 (G2 signature)
                    val = (x.c0, x.c1, y.c0, y.c1)
                vals[i] = val
                if key is not None:
                    cache.put(key, val)
        pk_limbs = fl.ints_to_limbs([c for v in pk_vals for c in v]).reshape(n, 2, fl.NLIMBS)
        sig_limbs = fl.ints_to_limbs([c for v in sig_vals for c in v]).reshape(n, 2, 2, fl.NLIMBS)
        pk_x = np.zeros((b, fl.NLIMBS), dtype=fl.NP_DTYPE)
        pk_y = np.zeros((b, fl.NLIMBS), dtype=fl.NP_DTYPE)
        sig_x = np.zeros((b, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
        sig_y = np.zeros((b, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
        pk_x[:n], pk_y[:n] = pk_limbs[:, 0], pk_limbs[:, 1]
        sig_x[:n], sig_y[:n] = sig_limbs[:, 0], sig_limbs[:, 1]
        # padding lanes copy lane 0 (valid coordinates keep the algebra
        # non-degenerate; the mask keeps them out of the verdict)
        if b > n:
            pk_x[n:], pk_y[n:] = pk_x[0], pk_y[0]
            sig_x[n:], sig_y[n:] = sig_x[0], sig_y[0]
            msgs += [b""] * (b - n)
        msg_u = hash_to_field_limbs(msgs)
        coeffs = self._coefficients(b)
        bits = (
            (coeffs[:, None] >> np.arange(64, dtype=np.uint64)[None, :]) & np.uint64(1)
        ).astype(fl.NP_DTYPE)
        mask = np.zeros(b, dtype=bool)
        mask[:n] = True
        return (pk_x, pk_y, sig_x, sig_y, msg_u, bits, mask)
