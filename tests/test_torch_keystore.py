"""The port's EIP-2335 keystores (``validator/keystore.py``) against the
JAX package's: the AES-128-CTR cipher on the NIST SP 800-38A known answer
and on seeded data, the EIP-2335 specification's scrypt and pbkdf2
vectors, keystores made by each package (with the same seeded salt, iv and
uuid) equal as JSON and decrypted by the other, wrong passwords refused
alike, and the directory loader's pubkey -> secret map.  Every comparison
is exact (bytes and JSON).  The two spec vectors cost about 2 s of KDF
each."""

import json

import numpy as np
import pytest

from lodestar_tpu.validator import keystore as jax_ks
from lodestar_tpu_torch.validator import keystore as port_ks

PACKAGES = {"jax": jax_ks, "port": port_ks}

EIP2335_PASSWORD = ("\U0001d531\U0001d522\U0001d530\U0001d531\U0001d52d\U0001d51e\U0001d530"
                    "\U0001d530\U0001d534\U0001d52c\U0001d52f\U0001d521\U0001f511")
EIP2335_SECRET = bytes.fromhex("000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")
EIP2335_SALT = "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"
EIP2335_PUBKEY = ("9612d7a727c9d0a22e185a1c768478dfe919cada9266988cb32359c11f2b7b27f4ae4040"
                  "902382ae2910c15e2b420d07")


def _vector(kdf: dict, checksum: str, message: str) -> dict:
    return {"crypto": {"kdf": kdf,
                       "checksum": {"function": "sha256", "params": {}, "message": checksum},
                       "cipher": {"function": "aes-128-ctr",
                                  "params": {"iv": "264daa3f303d7259501c93d997d84fe6"},
                                  "message": message}},
            "pubkey": EIP2335_PUBKEY, "version": 4}


VECTORS = {
    "scrypt": _vector({"function": "scrypt", "message": "",
                       "params": {"dklen": 32, "n": 262144, "p": 1, "r": 8,
                                  "salt": EIP2335_SALT}},
                      "d2217fe5f3e9a1e34581ef8a78f7c9928e436d36dacc5e846690a5581e8ea484",
                      "06ae90d55fe0a6e9c5c3bc5b170827b2e5cce3929ed3f116c2811e6366dfe20f"),
    "pbkdf2": _vector({"function": "pbkdf2", "message": "",
                       "params": {"dklen": 32, "c": 262144, "prf": "hmac-sha256",
                                  "salt": EIP2335_SALT}},
                      "8a9f5d9912ed7e75ea794bc5a89bca5f193721d30868ade6f73043c6ea6febf1",
                      "cee03fde2af33149775b7223e7845e4fb2c8ae1792e5f99fe9ecf474cc8c16ad"),
}


def test_aes128_ctr_fips_kat_and_seeded_data_equal_the_jax_cipher():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")
    assert port_ks.aes128_ctr(key, iv, pt).hex() == "874d6191b620e3261bef6864990db6ce"
    rng = np.random.default_rng(2335)
    for n in (0, 1, 15, 16, 17, 32, 100):
        key, iv, data = (rng.bytes(16), rng.bytes(16), rng.bytes(n))
        # the counter wraps at 2**128: an iv of all ones crosses it
        for v in (iv, b"\xff" * 16):
            got = port_ks.aes128_ctr(key, v, data)
            assert got == jax_ks.aes128_ctr(key, v, data)
            assert port_ks.aes128_ctr(key, v, got) == data


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
def test_eip2335_vectors_decrypt_to_the_spec_secret(kdf):
    assert port_ks.decrypt_keystore(VECTORS[kdf], EIP2335_PASSWORD) == EIP2335_SECRET
    with pytest.raises(port_ks.KeystoreError, match="checksum"):
        port_ks.decrypt_keystore(VECTORS[kdf], "wrong")


@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_keystores_made_by_each_package_are_equal_and_open_in_the_other(kdf, monkeypatch):
    secret = bytes(range(1, 33))
    made = {}
    for pkg in ("jax", "port"):
        rng = np.random.default_rng(20)
        # each package's module holds its own ``secrets`` name: pin the
        # one the module uses, one stream per package
        monkeypatch.setattr(PACKAGES[pkg], "_secrets",
                            type("S", (), {"token_bytes": staticmethod(lambda n, r=rng: r.bytes(n))}))
        made[pkg] = PACKAGES[pkg].create_keystore(secret, "hunter2hunter2", kdf=kdf)
    assert json.dumps(made["port"], sort_keys=True) == json.dumps(made["jax"], sort_keys=True)
    assert port_ks.decrypt_keystore(made["jax"], "hunter2hunter2") == secret
    assert jax_ks.decrypt_keystore(made["port"], "hunter2hunter2") == secret
    for pkg, mod in PACKAGES.items():
        with pytest.raises(mod.KeystoreError):
            mod.decrypt_keystore(made["port" if pkg == "jax" else "jax"], "wrong")


def test_unsupported_kdf_and_cipher_refused_alike():
    base = json.loads(json.dumps(VECTORS["pbkdf2"]))
    base["crypto"]["kdf"]["params"]["c"] = 2  # cheap
    bad_kdf = json.loads(json.dumps(base))
    bad_kdf["crypto"]["kdf"]["function"] = "argon2"
    bad_prf = json.loads(json.dumps(base))
    bad_prf["crypto"]["kdf"]["params"]["prf"] = "hmac-sha512"
    for doc in (bad_kdf, bad_prf):
        errors = []
        for mod in PACKAGES.values():
            with pytest.raises(mod.KeystoreError) as e:
                mod.decrypt_keystore(doc, "x")
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_password_normalisation_equals_the_jax_packages():
    for pw in (EIP2335_PASSWORD, "a\x00b\x7fc\x9fd", "ﬃ́ ok", ""):
        assert port_ks._normalize_password(pw) == jax_ks._normalize_password(pw)


def test_load_keystores_dir_reads_either_packages_files(tmp_path):
    secrets = [bytes([i + 1]) * 32 for i in range(2)]
    for i, (mod, secret) in enumerate(zip(PACKAGES.values(), secrets)):
        ks = mod.create_keystore(secret, "pw", kdf="pbkdf2")
        (tmp_path / f"keystore-{i}.json").write_text(json.dumps(ks))
    (tmp_path / "notes.txt").write_text("not a keystore")
    (tmp_path / "other.json").write_text(json.dumps({"no": "crypto"}))
    got = port_ks.load_keystores_dir(str(tmp_path), "pw")
    assert got == jax_ks.load_keystores_dir(str(tmp_path), "pw")
    assert sorted(got.values()) == sorted(secrets) and all(len(pk) == 48 for pk in got)
    assert port_ks.load_keystores_dir(str(tmp_path / "missing"), "pw") == {}
