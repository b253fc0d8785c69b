"""BLS12-381 G1/G2 group arithmetic, serialization, and subgroup checks.

Pure-Python oracle layer. Serialization follows the ZCash/IETF compressed
format used across Ethereum consensus (reference: crypto/bls/src/
generic_public_key.rs, generic_signature.rs for lengths and infinity
encodings; blst's key_validate for the decompress-time subgroup/infinity
policy at crypto/bls/src/impls/blst.rs:126-136).
"""

from __future__ import annotations

from .constants import B1, B2, G1_X, G1_Y, G2_X, G2_Y, P, R, X
from .fields import Fq, Fq2, _FROB6_C1, _FROB12_C1  # noqa: F401


class AffinePoint:
    """Affine point on y^2 = x^3 + b over a generic field (Fq or Fq2).

    ``infinity`` points carry zeroed coordinates. All group ops are the
    textbook affine formulas — clarity over speed; the batched Jacobian
    versions live in lighthouse_tpu/ops/.
    """

    __slots__ = ("x", "y", "infinity", "b")

    def __init__(self, x, y, infinity: bool, b):
        self.x, self.y, self.infinity, self.b = x, y, infinity, b

    # -- constructors ------------------------------------------------------
    @classmethod
    def infinity_point(cls, field, b):
        return cls(field.zero(), field.zero(), True, b)

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y.square() == self.x.square() * self.x + self.b

    # -- equality ----------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, AffinePoint):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity and other.infinity
        return self.x == other.x and self.y == other.y

    def __repr__(self):
        if self.infinity:
            return "Point(infinity)"
        return f"Point({self.x}, {self.y})"

    # -- group law ---------------------------------------------------------
    def neg(self) -> "AffinePoint":
        if self.infinity:
            return self
        return AffinePoint(self.x, -self.y, False, self.b)

    def double(self) -> "AffinePoint":
        if self.infinity or self.y.is_zero():
            return AffinePoint.infinity_point(type(self.x), self.b)
        three_x2 = self.x.square().mul_scalar(3)
        lam = three_x2 * (self.y.mul_scalar(2)).inv()
        x3 = lam.square() - self.x.mul_scalar(2)
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(x3, y3, False, self.b)

    def add(self, other: "AffinePoint") -> "AffinePoint":
        if self.infinity:
            return other
        if other.infinity:
            return self
        if self.x == other.x:
            if self.y == other.y:
                return self.double()
            return AffinePoint.infinity_point(type(self.x), self.b)
        lam = (other.y - self.y) * (other.x - self.x).inv()
        x3 = lam.square() - self.x - other.x
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(x3, y3, False, self.b)

    def mul(self, k: int) -> "AffinePoint":
        """Scalar multiplication via a Jacobian-coordinate ladder (one field
        inversion total, vs one per affine add — the batched device versions
        live in lighthouse_tpu/ops/points.py)."""
        if k < 0:
            return self.neg().mul(-k)
        if k == 0 or self.infinity:
            return AffinePoint.infinity_point(type(self.x), self.b)

        field = type(self.x)
        one = field.one()
        zero = field.zero()

        def jac_double(X1, Y1, Z1):
            # dbl-2009-l
            A = X1.square()
            B = Y1.square()
            C = B.square()
            D = ((X1 + B).square() - A - C).mul_scalar(2)
            E = A.mul_scalar(3)
            X3 = E.square() - D.mul_scalar(2)
            Y3 = E * (D - X3) - C.mul_scalar(8)
            Z3 = (Y1 * Z1).mul_scalar(2)
            return X3, Y3, Z3

        # Jacobian accumulator (X, Y, Z); Z == zero means infinity.
        X1, Y1, Z1 = zero, one, zero
        x2, y2 = self.x, self.y

        for bit in bin(k)[2:]:
            if not Z1.is_zero():
                X1, Y1, Z1 = jac_double(X1, Y1, Z1)
            if bit == "1":
                # mixed add, madd-2007-bl (Jacobian += affine)
                if Z1.is_zero():
                    X1, Y1, Z1 = x2, y2, one
                else:
                    Z1Z1 = Z1.square()
                    U2 = x2 * Z1Z1
                    S2 = y2 * Z1 * Z1Z1
                    H = U2 - X1
                    r = (S2 - Y1).mul_scalar(2)
                    if H.is_zero():
                        if r.is_zero():
                            X1, Y1, Z1 = jac_double(X1, Y1, Z1)
                        else:
                            X1, Y1, Z1 = zero, one, zero
                    else:
                        HH = H.square()
                        I = HH.mul_scalar(4)
                        J = H * I
                        V = X1 * I
                        X3 = r.square() - J - V.mul_scalar(2)
                        Y3 = r * (V - X3) - (Y1 * J).mul_scalar(2)
                        Z3 = (Z1 + H).square() - Z1Z1 - HH
                        X1, Y1, Z1 = X3, Y3, Z3

        if Z1.is_zero():
            return AffinePoint.infinity_point(field, self.b)
        zinv = Z1.inv()
        zinv2 = zinv.square()
        return AffinePoint(X1 * zinv2, Y1 * zinv2 * zinv, False, self.b)


FQ_B1 = Fq(B1)
FQ2_B2 = Fq2.from_tuple(B2)


def g1_generator() -> AffinePoint:
    return AffinePoint(Fq(G1_X), Fq(G1_Y), False, FQ_B1)


def g2_generator() -> AffinePoint:
    return AffinePoint(Fq2.from_tuple(G2_X), Fq2.from_tuple(G2_Y), False, FQ2_B2)


def g1_infinity() -> AffinePoint:
    return AffinePoint.infinity_point(Fq, FQ_B1)


def g2_infinity() -> AffinePoint:
    return AffinePoint.infinity_point(Fq2, FQ2_B2)


# ----------------------------------------------------------------- psi / checks

# Untwist-Frobenius-twist endomorphism constants, derived at import:
#   psi(x, y) = (cx * conj(x), cy * conj(y))
#   cx = 1 / xi^((p-1)/3),  cy = 1 / xi^((p-1)/2)
_PSI_CX = _FROB6_C1.inv()
_PSI_CY = (Fq2(1, 1).pow((P - 1) // 2)).inv()


def psi(pt: AffinePoint) -> AffinePoint:
    """The G2 endomorphism used for fast cofactor clearing."""
    if pt.infinity:
        return pt
    return AffinePoint(pt.x.conj() * _PSI_CX, pt.y.conj() * _PSI_CY, False, pt.b)


def g1_subgroup_check(pt: AffinePoint) -> bool:
    return pt.mul(R).infinity


def g2_subgroup_check(pt: AffinePoint) -> bool:
    return pt.mul(R).infinity


def clear_cofactor_g2(pt: AffinePoint) -> AffinePoint:
    """Multiply by the effective G2 cofactor h_eff (RFC 9380 §8.8.2).

    Uses the Budroni-Pintore endomorphism decomposition, which equals plain
    scalar multiplication by h_eff:
        h_eff * P = (x^2 - x - 1) P + (x - 1) psi(P) + psi(psi(2 P))
    """
    x_sq = X * X
    t0 = pt.mul(x_sq - X - 1)
    t1 = psi(pt.mul(X - 1))
    t2 = psi(psi(pt.double()))
    return t0.add(t1).add(t2)


# ---------------------------------------------------------------- serialization

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_Y_SIGN = 0x20


def _fq_to_bytes(n: int) -> bytes:
    return n.to_bytes(48, "big")


def _y_is_lexically_largest_fq(y: int) -> bool:
    return y > P - y if y != 0 else False


def _y_is_lexically_largest_fq2(y: Fq2) -> bool:
    # Lexicographic on (c1, c0): compare imaginary part first (ZCash convention).
    if y.c1 != 0:
        return y.c1 > P - y.c1
    return y.c0 > P - y.c0 if y.c0 != 0 else False


def g1_to_compressed(pt: AffinePoint) -> bytes:
    if pt.infinity:
        out = bytearray(48)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    out = bytearray(_fq_to_bytes(pt.x.n))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_lexically_largest_fq(pt.y.n):
        out[0] |= _FLAG_Y_SIGN
    return bytes(out)


def g2_to_compressed(pt: AffinePoint) -> bytes:
    if pt.infinity:
        out = bytearray(96)
        out[0] = _FLAG_COMPRESSED | _FLAG_INFINITY
        return bytes(out)
    # c1 first, then c0 (ZCash convention).
    out = bytearray(_fq_to_bytes(pt.x.c1) + _fq_to_bytes(pt.x.c0))
    out[0] |= _FLAG_COMPRESSED
    if _y_is_lexically_largest_fq2(pt.y):
        out[0] |= _FLAG_Y_SIGN
    return bytes(out)


class DeserializeError(ValueError):
    pass


def _check_flags(data: bytes, expected_len: int):
    if len(data) != expected_len:
        raise DeserializeError(f"invalid length {len(data)} != {expected_len}")
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise DeserializeError("uncompressed form not accepted here")
    return flags


def g1_from_compressed(data: bytes, *, allow_infinity: bool = True) -> AffinePoint:
    flags = _check_flags(data, 48)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if flags & _FLAG_INFINITY:
        if any(body) or (flags & _FLAG_Y_SIGN):
            raise DeserializeError("malformed infinity encoding")
        if not allow_infinity:
            raise DeserializeError("infinity point not allowed")
        return g1_infinity()
    x = int.from_bytes(body, "big")
    if x >= P:
        raise DeserializeError("x not in field")
    rhs = Fq(x).square() * Fq(x) + FQ_B1
    y = rhs.sqrt()
    if y is None:
        raise DeserializeError("x not on curve")
    y_large = _y_is_lexically_largest_fq(y.n)
    want_large = bool(flags & _FLAG_Y_SIGN)
    if y_large != want_large:
        y = -y
    return AffinePoint(Fq(x), y, False, FQ_B1)


def g2_from_compressed(data: bytes, *, allow_infinity: bool = True) -> AffinePoint:
    flags = _check_flags(data, 96)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if flags & _FLAG_INFINITY:
        if any(body) or (flags & _FLAG_Y_SIGN):
            raise DeserializeError("malformed infinity encoding")
        if not allow_infinity:
            raise DeserializeError("infinity point not allowed")
        return g2_infinity()
    c1 = int.from_bytes(body[:48], "big")
    c0 = int.from_bytes(body[48:], "big")
    if c0 >= P or c1 >= P:
        raise DeserializeError("x not in field")
    x = Fq2(c0, c1)
    rhs = x.square() * x + FQ2_B2
    y = rhs.sqrt()
    if y is None:
        raise DeserializeError("x not on curve")
    y_large = _y_is_lexically_largest_fq2(y)
    want_large = bool(flags & _FLAG_Y_SIGN)
    if y_large != want_large:
        y = -y
    return AffinePoint(x, y, False, FQ2_B2)
