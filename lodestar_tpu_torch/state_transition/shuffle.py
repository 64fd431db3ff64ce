"""Swap-or-not shuffling (consensus spec compute_shuffled_index / the
reference's list-optimized unshuffleList, state-transition/src/util/shuffle.ts:15).

The list form is vectorized with numpy: each of SHUFFLE_ROUND_COUNT rounds
computes every index's flip partner and selection bit from one round of
sha256 draws — columnar, branch-free, and the same shape a device kernel
would use (the reference's per-index bit-twiddling loop becomes three array
ops).
"""

from __future__ import annotations

import hashlib

import numpy as np


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_shuffled_index(index: int, count: int, seed: bytes, rounds: int) -> int:
    """Spec scalar form (forward permutation)."""
    if not 0 <= index < count:
        raise ValueError("index out of range")
    for r in range(rounds):
        pivot = int.from_bytes(_sha(seed + bytes([r]))[:8], "little") % count
        flip = (pivot + count - index) % count
        pos = max(index, flip)
        src = _sha(seed + bytes([r]) + (pos // 256).to_bytes(4, "little"))
        bit = (src[(pos % 256) // 8] >> (pos % 8)) & 1
        if bit:
            index = flip
    return index


def shuffle_list(values: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Forward-shuffle a whole array: out[shuffled_index(i)] = values[i].

    Equivalent to applying compute_shuffled_index to every index, done as
    `rounds` vectorized swap-or-not passes (in reverse round order, the
    inverse of unshuffling — matching the reference's unshuffleList with
    the round direction flipped)."""
    return _swap_or_not(values, seed, rounds, forward=True)


def unshuffle_list(values: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Inverse permutation (the one committee computation uses: the
    reference unshuffles the full index list once per epoch)."""
    return _swap_or_not(values, seed, rounds, forward=False)


def _swap_or_not(values: np.ndarray, seed: bytes, rounds: int, forward: bool) -> np.ndarray:
    count = len(values)
    if count <= 1:
        return values.copy()
    out = values.copy()
    idx = np.arange(count, dtype=np.int64)
    round_order = range(rounds) if forward else reversed(range(rounds))
    for r in round_order:
        pivot = int.from_bytes(_sha(seed + bytes([r]))[:8], "little") % count
        flip = (pivot - idx) % count
        pos = np.maximum(idx, flip)
        # one hash per 256 positions
        n_blocks = (count + 255) // 256
        blocks = [
            _sha(seed + bytes([r]) + blk.to_bytes(4, "little")) for blk in range(n_blocks)
        ]
        src = np.frombuffer(b"".join(blocks), dtype=np.uint8)
        bits = (src[pos // 8] >> (pos % 8).astype(np.uint8)) & 1
        # swap-or-not: where bit set, element moves to its flip position.
        # Perform as a gather: new[i] = old[flip[i]] if bit else old[i]
        gather = np.where(bits.astype(bool), flip, idx)
        out = out[gather]
    return out
