"""The plain reference again, in pure Python: each set's pairing equation
alone, from the secret keys, with nothing of the C library
(``portbench/native/fastbls.c``) on its path.  Run on a sample of each
window's sets, it checks the C reference that decides every verdict."""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from .curve import G1_GEN, g2_from_bytes
from .fields import R
from .hash_to_curve import hash_to_g2
from .pairing import multi_pairing


def interop_sk(index: int) -> int:
    """The eth2 interop secret key of ``index``: int(LE(sha256(LE32(i))))
    mod r."""
    digest = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return int.from_bytes(digest, "little") % R


def verify_tasks(tasks: Sequence[Tuple[Tuple[int, ...], bytes, bytes]]) -> List[bool]:
    """Per (key indices, root, compressed signature): the keys' summed
    secret key times g1 is the public key, and e(pk, H(root)) = e(g1,
    sig), with the signature's subgroup checked."""
    out = []
    for keys, root, sig in tasks:
        total = sum(interop_sk(i) for i in keys) % R
        try:
            point = g2_from_bytes(sig)
        except ValueError:
            out.append(False)
            continue
        out.append(total != 0 and multi_pairing(
            [(-G1_GEN, point), (G1_GEN * total, hash_to_g2(root))]).is_one())
    return out
