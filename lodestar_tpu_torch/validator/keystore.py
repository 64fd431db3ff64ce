"""EIP-2335 keystores: scrypt/pbkdf2 KDF + AES-128-CTR, plus keystore
directory loading for the validator client.

Reference: packages/cli/src/cmds/account/ (eth2 wallet/keystore manager)
and the @chainsafe/bls-keystore dep it builds on.  The cipher is a
self-contained AES-128-CTR (the payload is one 32-byte secret — two
blocks; a C cipher would be overkill, and it needs no dependency).
Vectors: the EIP-2335 spec test keystores (scrypt + pbkdf2) pass
round-trip in tests/test_torch_keystore.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets as _secrets
import unicodedata
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# AES-128 (encrypt-only core; CTR mode needs no decrypt direction)
# ---------------------------------------------------------------------------

_SBOX = None


def _build_sbox() -> bytes:
    # multiplicative inverse in GF(2^8) + affine transform (FIPS-197)
    inv = [0] * 256
    p, q = 1, 1
    while True:
        # p *= 3 in GF(2^8)
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q /= 3
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    inv[0] = 0
    sbox = bytearray(256)
    for i in range(256):
        x = inv[i] if i else 0
        x = x ^ ((x << 1) | (x >> 7)) & 0xFF ^ ((x << 2) | (x >> 6)) & 0xFF \
            ^ ((x << 3) | (x >> 5)) & 0xFF ^ ((x << 4) | (x >> 4)) & 0xFF ^ 0x63
        sbox[i] = x & 0xFF
    return bytes(sbox)


def _sbox() -> bytes:
    global _SBOX
    if _SBOX is None:
        _SBOX = _build_sbox()
        # FIPS-197 KAT pins the table construction
        assert _SBOX[0x00] == 0x63 and _SBOX[0x53] == 0xED and _SBOX[0xFF] == 0x16
    return _SBOX


def _xtime(b: int) -> int:
    return ((b << 1) ^ 0x1B) & 0xFF if b & 0x80 else b << 1


def _aes128_key_schedule(key: bytes) -> List[bytes]:
    sbox = _sbox()
    words = [key[i : i + 4] for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        tmp = words[i - 1]
        if i % 4 == 0:
            tmp = bytes(
                (sbox[tmp[1]] ^ (rcon if j == 0 else 0)) if j == 0 else sbox[tmp[(j + 1) % 4]]
                for j in range(4)
            )
            rcon = _xtime(rcon)
        words.append(bytes(a ^ b for a, b in zip(words[i - 4], tmp)))
    return [b"".join(words[4 * r : 4 * r + 4]) for r in range(11)]


def _aes128_encrypt_block(rks: List[bytes], block: bytes) -> bytes:
    sbox = _sbox()
    s = bytearray(a ^ b for a, b in zip(block, rks[0]))
    for rnd in range(1, 11):
        # SubBytes
        s = bytearray(sbox[b] for b in s)
        # ShiftRows (state is column-major: s[r + 4c])
        t = bytearray(16)
        for c in range(4):
            for r in range(4):
                t[r + 4 * c] = s[r + 4 * ((c + r) % 4)]
        s = t
        # MixColumns (skipped in the final round)
        if rnd != 10:
            m = bytearray(16)
            for c in range(4):
                a = s[4 * c : 4 * c + 4]
                m[4 * c + 0] = _xtime(a[0]) ^ (_xtime(a[1]) ^ a[1]) ^ a[2] ^ a[3]
                m[4 * c + 1] = a[0] ^ _xtime(a[1]) ^ (_xtime(a[2]) ^ a[2]) ^ a[3]
                m[4 * c + 2] = a[0] ^ a[1] ^ _xtime(a[2]) ^ (_xtime(a[3]) ^ a[3])
                m[4 * c + 3] = (_xtime(a[0]) ^ a[0]) ^ a[1] ^ a[2] ^ _xtime(a[3])
            s = m
        s = bytearray(a ^ b for a, b in zip(s, rks[rnd]))
    return bytes(s)


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CTR keystream XOR (works both directions)."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("aes-128-ctr needs 16-byte key and iv")
    rks = _aes128_key_schedule(key)
    counter = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(data), 16):
        ks = _aes128_encrypt_block(rks, counter.to_bytes(16, "big"))
        counter = (counter + 1) % (1 << 128)
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


# ---------------------------------------------------------------------------
# EIP-2335
# ---------------------------------------------------------------------------


class KeystoreError(Exception):
    pass


def _normalize_password(password: str) -> bytes:
    # EIP-2335: NFKD normalize, strip C0/C1/Delete control codes
    norm = unicodedata.normalize("NFKD", password)
    return "".join(
        c for c in norm if not (ord(c) < 0x20 or 0x7F <= ord(c) <= 0x9F)
    ).encode()


def _kdf(crypto: dict, password: bytes) -> bytes:
    kdf = crypto["kdf"]
    params = kdf["params"]
    salt = bytes.fromhex(params["salt"])
    if kdf["function"] == "scrypt":
        return hashlib.scrypt(
            password, salt=salt, n=params["n"], r=params["r"], p=params["p"],
            dklen=params["dklen"], maxmem=2**31 - 1,
        )
    if kdf["function"] == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeystoreError(f"unsupported prf {params.get('prf')}")
        return hashlib.pbkdf2_hmac("sha256", password, salt, params["c"], params["dklen"])
    raise KeystoreError(f"unsupported kdf {kdf['function']}")


def decrypt_keystore(keystore: dict, password: str) -> bytes:
    """Returns the 32-byte BLS secret (EIP-2335 decrypt)."""
    crypto = keystore["crypto"]
    dk = _kdf(crypto, _normalize_password(password))
    cipher_msg = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + cipher_msg).hexdigest()
    if checksum != crypto["checksum"]["message"]:
        raise KeystoreError("wrong password (checksum mismatch)")
    if crypto["cipher"]["function"] != "aes-128-ctr":
        raise KeystoreError(f"unsupported cipher {crypto['cipher']['function']}")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return aes128_ctr(dk[:16], iv, cipher_msg)


def create_keystore(
    secret: bytes, password: str, *, path: str = "m/12381/3600/0/0/0",
    kdf: str = "scrypt", pubkey: Optional[bytes] = None,
) -> dict:
    """EIP-2335 encrypt (account-manager `create` flow)."""
    if len(secret) != 32:
        raise KeystoreError("BLS secret must be 32 bytes")
    salt = _secrets.token_bytes(32)
    pw = _normalize_password(password)
    if kdf == "scrypt":
        params = {"dklen": 32, "n": 262144, "r": 8, "p": 1, "salt": salt.hex()}
        dk = hashlib.scrypt(
            pw, salt=salt, n=params["n"], r=params["r"], p=params["p"],
            dklen=32, maxmem=2**31 - 1,
        )
        kdf_obj = {"function": "scrypt", "params": params, "message": ""}
    else:
        params = {"dklen": 32, "c": 262144, "prf": "hmac-sha256", "salt": salt.hex()}
        dk = hashlib.pbkdf2_hmac("sha256", pw, salt, params["c"], 32)
        kdf_obj = {"function": "pbkdf2", "params": params, "message": ""}
    iv = _secrets.token_bytes(16)
    cipher_msg = aes128_ctr(dk[:16], iv, secret)
    if pubkey is None:
        from ..crypto.bls.api import SecretKey

        pubkey = SecretKey.from_bytes(secret).to_public_key().to_bytes()
    return {
        "version": 4,
        "uuid": _uuid4(),
        "path": path,
        "pubkey": pubkey.hex(),
        "description": "",
        "crypto": {
            "kdf": kdf_obj,
            "checksum": {
                "function": "sha256",
                "params": {},
                "message": hashlib.sha256(dk[16:32] + cipher_msg).hexdigest(),
            },
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": cipher_msg.hex(),
            },
        },
    }


def _uuid4() -> str:
    b = bytearray(_secrets.token_bytes(16))
    b[6] = (b[6] & 0x0F) | 0x40
    b[8] = (b[8] & 0x3F) | 0x80
    h = bytes(b).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def load_keystores_dir(
    directory: str, password: str
) -> Dict[bytes, bytes]:
    """pubkey -> secret for every keystore-*.json in `directory`
    (cmds/validator keystore import flow).  The password may also be a
    path to a file holding it (one per line matched in order is NOT
    supported — one shared password, the common lodestar setup)."""
    out: Dict[bytes, bytes] = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(directory, name)) as f:
            ks = json.load(f)
        if "crypto" not in ks:
            continue
        secret = decrypt_keystore(ks, password)
        pk = bytes.fromhex(ks["pubkey"]) if ks.get("pubkey") else None
        if pk is None:
            from ..crypto.bls.api import SecretKey

            pk = SecretKey.from_bytes(secret).to_public_key().to_bytes()
        out[pk] = secret
    return out
