"""Pure-Python BLS12-381 tower-field arithmetic.

This is the host-side oracle: slow, obviously-correct big-integer arithmetic
used (a) as the trusted reference the JAX/TPU kernels are property-tested
against, and (b) as the CPU fallback path for singleton verifications.

Tower construction (standard for BLS12-381):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

Capability parity: the reference client gets this arithmetic from the blst
native library (reference: crypto/bls/src/impls/blst.rs); we own it so it can
be re-expressed as batched limb arithmetic on TPU (see lighthouse_tpu/ops/).
"""

from __future__ import annotations

from .constants import P


# --------------------------------------------------------------------------- Fq

def fq_add(a: int, b: int) -> int:
    return (a + b) % P


def fq_sub(a: int, b: int) -> int:
    return (a - b) % P


def fq_mul(a: int, b: int) -> int:
    return (a * b) % P


def fq_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Fq")
    # Extended-gcd modular inverse (CPython fast path) — ~30x cheaper than
    # the Fermat pow(a, P-2, P) ladder for 381-bit P.
    return pow(a, -1, P)


def fq_neg(a: int) -> int:
    return (-a) % P


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p % 4 == 3 so a^((p+1)/4) works); None if a is a QNR."""
    r = pow(a, (P + 1) // 4, P)
    if (r * r) % P != a % P:
        return None
    return r


def fq_sgn0(a: int) -> int:
    """RFC 9380 sgn0 for Fp: parity of the canonical representative."""
    return a % 2


class Fq:
    """Thin wrapper over int mod P so curve code is generic over Fq/Fq2."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)

    def is_zero(self) -> bool:
        return self.n == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fq) and self.n == other.n

    def __hash__(self):
        return hash(("Fq", self.n))

    def __repr__(self):
        return f"Fq({hex(self.n)})"

    def __add__(self, o: "Fq") -> "Fq":
        return Fq(self.n + o.n)

    def __sub__(self, o: "Fq") -> "Fq":
        return Fq(self.n - o.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def __mul__(self, o: "Fq") -> "Fq":
        return Fq(self.n * o.n)

    def mul_scalar(self, k: int) -> "Fq":
        return Fq(self.n * k)

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inv(self) -> "Fq":
        return Fq(fq_inv(self.n))

    def pow(self, e: int) -> "Fq":
        if e < 0:
            return self.inv().pow(-e)
        return Fq(pow(self.n, e, P))

    def sqrt(self) -> "Fq | None":
        r = fq_sqrt(self.n)
        return Fq(r) if r is not None else None

    def sgn0(self) -> int:
        return self.n % 2


# -------------------------------------------------------------------------- Fq2

class Fq2:
    """c0 + c1*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    # -- constructors
    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    @staticmethod
    def from_tuple(t) -> "Fq2":
        return Fq2(t[0], t[1])

    def tuple(self):
        return (self.c0, self.c1)

    # -- predicates
    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fq2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"

    # -- arithmetic
    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def mul_scalar(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        t0 = (self.c0 + self.c1) * (self.c0 - self.c1)
        t1 = 2 * self.c0 * self.c1
        return Fq2(t0, t1)

    def inv(self) -> "Fq2":
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        n_inv = fq_inv(norm)
        return Fq2(self.c0 * n_inv, -self.c1 * n_inv)

    def conj(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def mul_by_xi(self) -> "Fq2":
        """Multiply by xi = 1 + u."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def pow(self, e: int) -> "Fq2":
        if e < 0:
            return self.inv().pow(-e)
        acc = Fq2.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 via the complex method; None if not a QR."""
        if self.is_zero():
            return Fq2.zero()
        if self.c1 == 0:
            r = fq_sqrt(self.c0)
            if r is not None:
                return Fq2(r, 0)
            # -1 is a QNR in Fp (p = 3 mod 4), so c0 QNR => -c0 is a QR and
            # sqrt = sqrt(-c0) * u.
            r = fq_sqrt((-self.c0) % P)
            return Fq2(0, r) if r is not None else None
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        d = fq_sqrt(norm)
        if d is None:
            return None
        two_inv = fq_inv(2)
        for dd in (d, (-d) % P):
            x0 = fq_sqrt(((self.c0 + dd) * two_inv) % P)
            if x0 is None or x0 == 0:
                continue
            x1 = (self.c1 * fq_inv(2 * x0)) % P
            cand = Fq2(x0, x1)
            if cand.square() == self:
                return cand
        return None

    def sgn0(self) -> int:
        """RFC 9380 sgn0 for Fp2 (lexicographic)."""
        sign_0 = self.c0 % 2
        zero_0 = self.c0 == 0
        sign_1 = self.c1 % 2
        return sign_0 or (zero_0 and sign_1)

    def frobenius(self) -> "Fq2":
        return self.conj()


XI = Fq2(1, 1)

# Frobenius constants, computed rather than memorized so they are self-evidently
# consistent with the tower definition.
_FROB6_C1 = XI.pow((P - 1) // 3)          # xi^((p-1)/3)
_FROB6_C2 = XI.pow(2 * (P - 1) // 3)      # xi^(2(p-1)/3)
_FROB12_C1 = XI.pow((P - 1) // 6)         # xi^((p-1)/6)


# -------------------------------------------------------------------------- Fq6

class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Fq6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_v(self) -> "Fq6":
        """Multiply by v: (c0, c1, c2) -> (c2*xi, c0, c1)."""
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def mul_by_fq2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def inv(self) -> "Fq6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_xi()
        t1 = c.square().mul_by_xi() - a * b
        t2 = b.square() - a * c
        denom = a * t0 + (c * t1 + b * t2).mul_by_xi()
        d_inv = denom.inv()
        return Fq6(t0 * d_inv, t1 * d_inv, t2 * d_inv)

    def frobenius(self) -> "Fq6":
        return Fq6(
            self.c0.conj(),
            self.c1.conj() * _FROB6_C1,
            self.c2.conj() * _FROB6_C2,
        )


# ------------------------------------------------------------------------- Fq12

class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, other) -> bool:
        return isinstance(other, Fq12) and self.c0 == other.c0 and self.c1 == other.c1

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c0 = t0 + t1.mul_by_v()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        # (a + bw)^2 = (a^2 + b^2 v) + 2ab w, via Karatsuba-ish.
        t0 = self.c0 * self.c1
        c0 = (self.c0 + self.c1) * (self.c0 + self.c1.mul_by_v()) - t0 - t0.mul_by_v()
        c1 = t0 + t0
        return Fq12(c0, c1)

    def inv(self) -> "Fq12":
        denom = (self.c0.square() - self.c1.square().mul_by_v()).inv()
        return Fq12(self.c0 * denom, -(self.c1 * denom))

    def conj(self) -> "Fq12":
        """Conjugation over Fq6 = raising to p^6 (cyclotomic inverse)."""
        return Fq12(self.c0, -self.c1)

    def frobenius(self) -> "Fq12":
        c0 = self.c0.frobenius()
        c1f = self.c1.frobenius()
        c1 = Fq6(c1f.c0 * _FROB12_C1, c1f.c1 * _FROB12_C1, c1f.c2 * _FROB12_C1)
        return Fq12(c0, c1)

    def frobenius_n(self, n: int) -> "Fq12":
        out = self
        for _ in range(n % 12):
            out = out.frobenius()
        return out

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        acc = Fq12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def cyclotomic_pow(self, e: int) -> "Fq12":
        """pow for elements of the cyclotomic subgroup; negative e uses conj."""
        if e < 0:
            return self.conj().cyclotomic_pow(-e)
        return self.pow(e)
