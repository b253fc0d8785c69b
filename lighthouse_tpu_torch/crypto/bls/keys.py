"""Secret keys, signing, and single-signature verification (pure-Python path).

Mirrors the capability of the reference's TSecretKey/TSignature traits
(crypto/bls/src/generic_secret_key.rs, generic_signature.rs): keygen per the
BLS standard (HKDF-based, as in EIP-2333's derive-from-IKM), sign = sk * H(m),
verify = pairing check e(pk, H(m)) == e(g1, sig).
"""

from __future__ import annotations

import hashlib
import hmac

from .constants import R, SECRET_KEY_BYTES_LEN
from .curve import AffinePoint, g1_generator
from .hash_to_curve import hash_to_g2
from .pairing import miller_loop, final_exponentiation


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """RFC-standard BLS KeyGen (also EIP-2333 HKDF_mod_r). Returns sk as int."""
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def sk_from_bytes(data: bytes) -> int:
    if len(data) != SECRET_KEY_BYTES_LEN:
        raise ValueError("bad secret key length")
    sk = int.from_bytes(data, "big")
    if sk == 0 or sk >= R:
        raise ValueError("secret key out of range")
    return sk


def sk_to_bytes(sk: int) -> bytes:
    return sk.to_bytes(SECRET_KEY_BYTES_LEN, "big")


def sk_to_pk_point(sk: int) -> AffinePoint:
    return g1_generator().mul(sk)


def sign_point(sk: int, message: bytes) -> AffinePoint:
    """Core signing: sk * hash_to_g2(message)."""
    return hash_to_g2(message).mul(sk)


def verify_point(pk: AffinePoint, message: bytes, sig: AffinePoint) -> bool:
    """Single verification: e(pk, H(m)) * e(-g1, sig) == 1."""
    if pk.infinity:
        return False
    h = hash_to_g2(message)
    f = miller_loop(pk, h) * miller_loop(g1_generator().neg(), sig)
    return final_exponentiation(f).is_one()
