"""Hash-to-curve for BLS12-381 G2 (RFC 9380 suite BLS12381G2_XMD:SHA-256_SSWU_RO_).

expand_message_xmd -> hash_to_field(Fp2, count=2, L=64) -> simplified SWU on
the 3-isogenous curve E2' -> 3-isogeny to E2 -> cofactor clearing.

The reference client gets this from blst's hash_to_g2 with the DST at
crypto/bls/src/impls/blst.rs:14. SHA-256 runs host-side (hashlib); the field
math here is the oracle for the batched TPU SSWU kernel.
"""

from __future__ import annotations

import hashlib

from .constants import (
    DST,
    H2F_L,
    ISO3_X_DEN,
    ISO3_X_NUM,
    ISO3_Y_DEN,
    ISO3_Y_NUM,
    P,
    SSWU_A2,
    SSWU_B2,
    SSWU_Z2,
)
from .curve import AffinePoint, FQ2_B2, clear_cofactor_g2
from .fields import Fq2

_SHA256_BLOCK = 64
_SHA256_OUT = 32

_A = Fq2.from_tuple(SSWU_A2)
_B = Fq2.from_tuple(SSWU_B2)
_Z = Fq2.from_tuple(SSWU_Z2)

_XNUM = [Fq2.from_tuple(c) for c in ISO3_X_NUM]
_XDEN = [Fq2.from_tuple(c) for c in ISO3_X_DEN]
_YNUM = [Fq2.from_tuple(c) for c in ISO3_Y_NUM]
_YDEN = [Fq2.from_tuple(c) for c in ISO3_Y_DEN]


# The Z_pad prefix is one full zero SHA-256 block shared by every
# message: hash it once and .copy() the midstate per call (measured on
# the e2e critical path — expand dominates host assembly at S=4096).
_ZPAD_STATE = hashlib.sha256(bytes(_SHA256_BLOCK))


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    if len(dst) > 255:
        raise ValueError("DST too long")
    ell = (len_in_bytes + _SHA256_OUT - 1) // _SHA256_OUT
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    h0 = _ZPAD_STATE.copy()
    h0.update(msg + l_i_b_str + b"\x00" + dst_prime)
    b_0 = h0.digest()
    b0_int = int.from_bytes(b_0, "big")
    b = [hashlib.sha256(b_0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        xored = (b0_int ^ int.from_bytes(b[-1], "big")).to_bytes(32, "big")
        b.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = DST) -> list[Fq2]:
    """RFC 9380 §5.2 hash_to_field with m=2, L=64."""
    m = 2
    len_in_bytes = count * m * H2F_L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(m):
            off = H2F_L * (j + i * m)
            coeffs.append(int.from_bytes(uniform[off : off + H2F_L], "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


def sswu_map_fq2(u: Fq2) -> tuple[Fq2, Fq2]:
    """Simplified SWU (RFC 9380 §6.6.2) onto E2': y^2 = x^3 + A x + B."""
    u2 = u.square()
    z_u2 = _Z * u2
    tv1 = z_u2.square() + z_u2        # Z^2 u^4 + Z u^2
    if tv1.is_zero():
        x1 = _B * (_Z * _A).inv()
    else:
        x1 = (-_B) * _A.inv() * (Fq2.one() + tv1.inv())
    gx1 = (x1.square() + _A) * x1 + _B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = z_u2 * x1
        gx2 = (x2.square() + _A) * x2 + _B
        y2 = gx2.sqrt()
        if y2 is None:  # impossible for valid SSWU parameters
            raise ArithmeticError("SSWU: neither gx1 nor gx2 is square")
        x, y = x2, y2
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def _horner(coeffs: list[Fq2], x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def iso3_map(x: Fq2, y: Fq2) -> AffinePoint:
    """Apply the 3-isogeny E2' -> E2."""
    x_num = _horner(_XNUM, x)
    x_den = _horner(_XDEN, x)
    y_num = _horner(_YNUM, x)
    y_den = _horner(_YDEN, x)
    if x_den.is_zero() or y_den.is_zero():
        # Exceptional inputs map to the point at infinity.
        return AffinePoint.infinity_point(Fq2, FQ2_B2)
    return AffinePoint(x_num * x_den.inv(), y * y_num * y_den.inv(), False, FQ2_B2)


def map_to_curve_g2(u: Fq2) -> AffinePoint:
    x, y = sswu_map_fq2(u)
    return iso3_map(x, y)


def hash_to_g2(msg: bytes, dst: bytes = DST) -> AffinePoint:
    """Full hash_to_curve: the point all signatures live under."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    return clear_cofactor_g2(q0.add(q1))
