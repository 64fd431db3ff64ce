"""Hash-to-curve for G2: BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380 §8.8.2).

The port's copy of the oracle: the host stage of the device hash
(``ops/htc.hash_to_field_limbs``) calls ``hash_to_field_fq2`` and the
device SSWU/isogeny constants are converted from the values below.

Pipeline: expand_message_xmd(sha256) -> hash_to_field(Fq2, count=2) ->
simplified-SWU onto the 3-isogenous curve E' -> 3-isogeny to E2 ->
clear cofactor (psi-endomorphism method, curve.g2_clear_cofactor).

E': y^2 = x^3 + A'x + B' with A' = 240*u, B' = 1012*(1+u), Z = -(2+u).

The 3-isogeny coefficients are validated at import time: ~16 random points of
E' are mapped and checked to land on E2. A degree-3 rational map taking E' to
E2 and infinity to infinity is automatically an isogeny (a morphism of
elliptic curves fixing O), so curve-preservation over random points pins the
constants to negligible error probability.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from .curve import B2, Point, g2_clear_cofactor
from .fields import Fq2, P

# Ethereum consensus signature DST (proof-of-possession scheme)
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

L = 64  # bytes per field element draw: ceil((381 + 128) / 8)

ISO_A = Fq2(0, 240)
ISO_B = Fq2(1012, 1012)
SSWU_Z = Fq2(-2, -1)  # -(2 + u)

# ---------------------------------------------------------------------------
# 3-isogeny E' -> E2 coefficients (RFC 9380 Appendix E.3), validated below.
# x = x_num(x') / x_den(x'); y = y' * y_num(x') / y_den(x') — coeffs ascending.
# ---------------------------------------------------------------------------

_K1 = [  # x_num, degree 3
    Fq2(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    Fq2(
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fq2(
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]

_K2 = [  # x_den, degree 2 (monic)
    Fq2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    Fq2(
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
    Fq2(1, 0),
]

_K3 = [  # y_num, degree 3
    Fq2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fq2(
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fq2(
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]

_K4 = [  # y_den, degree 3 (monic)
    Fq2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fq2(
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    Fq2(
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
    Fq2(1, 0),
]


def _eval_poly(coeffs: List[Fq2], x: Fq2) -> Fq2:
    acc = Fq2.zero()
    for c in reversed(coeffs):
        acc = acc * x + c
    return acc


def _iso_map(x: Fq2, y: Fq2) -> Tuple[Fq2, Fq2]:
    x_num = _eval_poly(_K1, x)
    x_den = _eval_poly(_K2, x)
    y_num = _eval_poly(_K3, x)
    y_den = _eval_poly(_K4, x)
    return x_num * x_den.inv(), y * y_num * y_den.inv()


def _gprime(x: Fq2) -> Fq2:
    """g'(x) = x^3 + A'x + B' on the isogenous curve."""
    return x.square() * x + ISO_A * x + ISO_B


def _verify_iso_constants() -> None:
    """Map random E' points through the isogeny; all must land on E2."""
    import random

    rng = random.Random(0xB15C0)
    checked = 0
    while checked < 16:
        x = Fq2(rng.randrange(P), rng.randrange(P))
        y = _gprime(x).sqrt()
        if y is None:
            continue
        xm, ym = _iso_map(x, y)
        if ym.square() != xm.square() * xm + B2:
            raise AssertionError(
                "3-isogeny constants failed curve-preservation check "
                "(hash_to_curve iso table is wrong)"
            )
        checked += 1


_verify_iso_constants()


# ---------------------------------------------------------------------------
# expand_message_xmd / hash_to_field (RFC 9380 §5)
# ---------------------------------------------------------------------------


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        raise ValueError("DST too long")
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * 64  # sha256 block size
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = bytearray(bi)
    for i in range(2, ell + 1):
        tmp = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hashlib.sha256(tmp + bytes([i]) + dst_prime).digest()
        out += bi
    return bytes(out[:len_in_bytes])


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = DST_G2) -> List[Fq2]:
    len_in_bytes = count * 2 * L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append(Fq2(coords[0], coords[1]))
    return out


# ---------------------------------------------------------------------------
# Simplified SWU (RFC 9380 §6.6.2, non-uniform branches are fine off-TPU)
# ---------------------------------------------------------------------------


def map_to_curve_sswu(u: Fq2) -> Tuple[Fq2, Fq2]:
    tv1 = SSWU_Z.square() * u.pow(4) + SSWU_Z * u.square()
    if tv1.is_zero():
        x1 = ISO_B * (SSWU_Z * ISO_A).inv()
    else:
        x1 = (-ISO_B) * ISO_A.inv() * (Fq2.one() + tv1.inv())
    gx1 = _gprime(x1)
    if gx1.is_square():
        x, y = x1, gx1.sqrt()
    else:
        x2 = SSWU_Z * u.square() * x1
        gx2 = _gprime(x2)
        y = gx2.sqrt()
        if y is None:
            raise AssertionError("SSWU: neither gx1 nor gx2 is square (impossible)")
        x = x2
    assert y is not None
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def map_to_curve_g2(u: Fq2) -> Point[Fq2]:
    x, y = map_to_curve_sswu(u)
    xm, ym = _iso_map(x, y)
    return Point.from_affine(xm, ym, B2)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2) -> Point[Fq2]:
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    return g2_clear_cofactor(q0 + q1)
