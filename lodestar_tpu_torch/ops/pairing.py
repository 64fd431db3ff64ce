"""Static exponent patterns of the pairing (numpy), from the BLS parameter."""

from __future__ import annotations

import numpy as np

from ..crypto.bls.fields import BLS_X
from . import limbs as fl

# bits of |BLS_X| after the leading 1, MSB first (the Miller loop's steps)
_X_BITS = np.array([int(c) for c in bin(abs(BLS_X))[3:]], dtype=fl.NP_DTYPE)

# base-4 digits of |BLS_X|, MSB first (the 2-bit windows of pow-by-x)
_X_WINDOWS = np.array([int(c, 4) for c in np.base_repr(abs(BLS_X), 4)], dtype=np.int32)
