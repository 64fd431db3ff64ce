"""Known-bad fixture for ``torch-limb-overflow``: importable, traced by
tests/test_torch_analysis.py through ``limb_interval.analyze``.  Each bad
program keeps the digit format's shapes and breaks a magnitude contract:
float32 would round past 2^24, silently (the port of the JAX fixture
``tests/analysis_fixtures/bad_limb_overflow.py``).

``BAD_PROGRAMS`` / ``GOOD_PROGRAMS``: (fn, shapes, intervals)."""

import torch

NLIMBS = 50
STRICT = (0.0, 256.0)


def scaled_product_no_finalize(a, b):
    row = a * b  # fine: 256 * 256 = 2^16
    scaled = row * 65025.0  # VIOLATION: 2^16 * 255^2 > 2^24
    return scaled * 0.0 + row


def lazy_add_ladder(x):
    acc = x
    for _ in range(17):
        acc = acc + acc  # VIOLATION: 2^8 << 17 = 2^25 > 2^24
    return acc


def anti_diagonal_over_accumulation(a, b):
    z = torch.zeros((NLIMBS,))
    for _ in range(NLIMBS):
        row = a * b
        z = z + row * row  # VIOLATION: 50 digit-squared products
    return z


def carried_mac_chain(a, b):
    """GOOD: 50 products of strict digits, < 50 * 2^16 < 2^22."""
    z = torch.zeros((NLIMBS,))
    for _ in range(NLIMBS):
        z = z + a * b
    return z


def split_idiom(d):
    """GOOD: the carry's split, d - 256 floor(d / 256), is d mod 256."""
    d = d.clone()
    hi = torch.div(d, 256, rounding_mode="floor")
    d.add_(hi, alpha=-256)
    return d + hi * 0.0


BAD_PROGRAMS = [
    (scaled_product_no_finalize, [(NLIMBS,), (NLIMBS,)], [STRICT, STRICT]),
    (lazy_add_ladder, [(NLIMBS,)], [STRICT]),
    (anti_diagonal_over_accumulation, [(NLIMBS,), (NLIMBS,)], [STRICT, STRICT]),
]

GOOD_PROGRAMS = [
    (carried_mac_chain, [(NLIMBS,), (NLIMBS,)], [STRICT, STRICT]),
    (split_idiom, [(NLIMBS,)], [(0.0, float((1 << 24) - 1))]),
]
