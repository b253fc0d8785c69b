"""BLS12-381 optimal-ate pairing — pure-Python oracle.

The Miller loop follows the standard optimal-ate construction for BLS curves
(loop over bits of |x|, conjugate at the end since x < 0). The final
exponentiation uses the (p^12-1)/r factorization into easy part
(p^6-1)(p^2+1) and the Hayashida-Hayasaka-Teruya hard-part chain
    (p^4 - p^2 + 1)/r = (x-1)^2 (x + p) (x^2 + p^2 - 1) + 3
both of which are asserted against the plain integer exponent in the tests.

The reference client performs these operations inside blst
(crypto/bls/src/impls/blst.rs: verify_multiple_aggregate_signatures); here the
math is explicit so the TPU kernels in lighthouse_tpu/ops/pairing.py can be
property-checked term by term.
"""

from __future__ import annotations

from .constants import P, X
from .curve import AffinePoint
from .fields import Fq2, Fq6, Fq12

# Bits of |x| from the second-most-significant down to 0.
_X_ABS = -X
_X_BITS = [int(b) for b in bin(_X_ABS)[3:]]


def _line_eval(t: AffinePoint, q: AffinePoint, p_g1: AffinePoint) -> tuple[Fq12, AffinePoint]:
    """Evaluate the line through T,Q (tangent when T==Q) at the G1 point P.

    Returns (line value in Fq12, T+Q). Works in affine coordinates — the
    oracle favors clarity. The line l(x, y) = (y_P - y_T) - lam * (x_P - x_T)
    is embedded into Fq12 using the twist: for the M-twist convention used
    here, a G1 coordinate x_P multiplies the w^2-component and y_P the
    w^3-component.
    """
    # Compute slope in Fq2.
    if t == q:
        lam = t.x.square().mul_scalar(3) * (t.y.mul_scalar(2)).inv()
    else:
        lam = (q.y - t.y) * (q.x - t.x).inv()
    r = t.add(q)
    # Line: l = lam * x_P * w^2 - y_P * w^3 + (y_T - lam * x_T)  — but we keep
    # the standard sparse embedding: l(P) has components in 1, w^2, w^3 slots
    # of Fq12 viewed as Fq2[w]/(w^6 - xi). In our Fq6/Fq12 tower:
    #   w^2 -> v (Fq6 c1 slot of c0), w^3 -> v*w (Fq6 c1 slot of c1).
    c_const = t.y - lam * t.x           # Fq2
    c_x = lam                           # multiplies x_P
    # Build Fq12 element: c0 = (c_const, c_x * x_P, 0), c1 = (0, -y_P, 0)
    xp = Fq2(p_g1.x.n, 0)
    yp = Fq2(p_g1.y.n, 0)
    c0 = Fq6(c_const, c_x * xp, Fq2.zero())
    c1 = Fq6(Fq2.zero(), -yp, Fq2.zero())
    return Fq12(c0, c1), r


def miller_loop(p_g1: AffinePoint, q_g2: AffinePoint) -> Fq12:
    """Miller loop f_{|x|,Q}(P), conjugated for x < 0."""
    if p_g1.infinity or q_g2.infinity:
        return Fq12.one()
    f = Fq12.one()
    t = q_g2
    for bit in _X_BITS:
        f = f.square()
        line, t = _line_eval(t, t, p_g1)
        f = f * line
        if bit:
            line, t = _line_eval(t, q_g2, p_g1)
            f = f * line
    # x < 0: f_{-|x|} = conj(f_{|x|}) after final exp; conjugate here.
    return f.conj()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^(3 * (p^12 - 1) / r) via easy part + HHT hard-part chain.

    Note the factor 3: the Hayashida-Hayasaka-Teruya chain computes the
    exponent 3d, d = (p^4-p^2+1)/r, which is the standard trick — cubing is a
    bijection on the order-r target subgroup (3 does not divide r), so all
    pairing *equality* checks (everything BLS verification does) are
    unaffected, and the chain is shorter. Asserted against the integer
    exponent in tests/test_bls_pairing.py.
    """
    # Easy part: f^(p^6 - 1) then ^(p^2 + 1).
    f = f.conj() * f.inv()
    f = f.frobenius_n(2) * f
    # Hard part: 3*(p^4 - p^2 + 1)/r = (x-1)^2 (x+p)(x^2+p^2-1) + 3.
    # After the easy part f is in the cyclotomic subgroup, so inverse == conj.
    a = _cyc_pow_x_minus_1(f)
    a = _cyc_pow_x_minus_1(a)
    b = _cyc_pow_x(a) * a.frobenius()             # a^(x+p)
    c = _cyc_pow_x(_cyc_pow_x(b))                 # b^(x^2)
    c = c * b.frobenius_n(2) * b.conj()           # b^(x^2 + p^2 - 1)
    return c * f.square() * f                     # * f^3


def _cyc_pow_x(f: Fq12) -> Fq12:
    """f^x for the (negative) BLS parameter x, cyclotomic subgroup only."""
    acc = Fq12.one()
    for bit in bin(_X_ABS)[2:]:
        acc = acc.square()
        if bit == "1":
            acc = acc * f
    return acc.conj()  # x < 0


def _cyc_pow_x_minus_1(f: Fq12) -> Fq12:
    return _cyc_pow_x(f) * f.conj()


def pairing(p_g1: AffinePoint, q_g2: AffinePoint) -> Fq12:
    """Full pairing e(P, Q)."""
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(pairs: list[tuple[AffinePoint, AffinePoint]]) -> Fq12:
    """prod_i e(P_i, Q_i) with a single shared final exponentiation."""
    f = Fq12.one()
    for p_g1, q_g2 in pairs:
        f = f * miller_loop(p_g1, q_g2)
    return final_exponentiation(f)
