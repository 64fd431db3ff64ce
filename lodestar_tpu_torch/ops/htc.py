"""Hash-to-G2 constants and its host stage.

The host does expand_message_xmd (sha256) and hash_to_field; the device
(``fused_htc``) does SSWU, the 3-isogeny and the point add.  Constants come
from the port's oracle (``crypto/bls/hash_to_curve.py``)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..crypto.bls import hash_to_curve as H
from . import limbs as fl
from . import tower as tw

ISO_A = tw.fq2_const(H.ISO_A)
ISO_B = tw.fq2_const(H.ISO_B)
SSWU_Z = tw.fq2_const(H.SSWU_Z)
NEG_B_OVER_A = tw.fq2_const(-H.ISO_B * H.ISO_A.inv())
B_OVER_ZA = tw.fq2_const(H.ISO_B * (H.SSWU_Z * H.ISO_A).inv())

K1 = [tw.fq2_const(c) for c in H._K1]  # x_num, degree 3
K2 = [tw.fq2_const(c) for c in H._K2]  # x_den, degree 2 monic
K3 = [tw.fq2_const(c) for c in H._K3]  # y_num, degree 3
K4 = [tw.fq2_const(c) for c in H._K4]  # y_den, degree 3 monic


def hash_to_field_limbs(msgs: List[bytes], dst: bytes = H.DST_G2) -> np.ndarray:
    """sha256 expand + reduce for each message, packed as (N, 2, 2, 50):
    two Fq2 draws per message."""
    out = np.zeros((len(msgs), 2, 2, fl.NLIMBS), dtype=fl.NP_DTYPE)
    for i, m in enumerate(msgs):
        u0, u1 = H.hash_to_field_fq2(m, 2, dst)
        out[i, 0] = tw.fq2_const(u0)
        out[i, 1] = tw.fq2_const(u1)
    return out
