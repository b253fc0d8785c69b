"""Batched hash-to-G2 (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_) on tensors.

Port of ``lighthouse_tpu/ops/htc.py``: the host step and the classic
pipeline, in the port's batch-major layout (Fp2 ``[n, 2, 48]``, masks
``bool[n]``):

    host:   expand_message_xmd (SHA-256, hashlib) -> hash_to_field
            -> u as Montgomery limbs                  [n, 2 (u0/u1), 2, 48]
    device: simplified SWU onto E2'                  (one Fq2 sqrt per u)
            3-isogeny E2' -> E2 (denominator-free Jacobian output)
            Q0 + Q1, Budroni-Pintore cofactor clearing via psi,
            one batched affine normalization.

Fq2 square roots use the q = 9 (mod 16) candidate method (RFC 9380 §I.3):
ONE exponentiation, then a first-hit choice among root-of-unity multiples,
uniform over every edge case (u = 0, non-residues).

This classic pipeline is plain torch on ``ops/tower.py`` and
``ops/points.py``: the independent reference that the plain versions of the
hash kernels K12-K14 (``ops/tkernel_htc.py``, the kernels' own schedule) are
held to. Equality is pinned at canonical affine outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls.constants import (
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
    X as X_PARAM,
)
from ..crypto.bls.fields import Fq2
from ..crypto.bls.hash_to_curve import expand_message_xmd
from . import field, tower
from .field import const
from .points import (
    FP2_OPS,
    PSI_CX_DEV,
    PSI_CY_DEV,
    pt_add,
    pt_double,
    pt_neg,
    pt_scalar_mul_const,
    pt_to_affine,
)
from .tower import fp2_add, fp2_mul, fp2_neg, fp2_sqr

# ------------------------------------------------------------- constants

_Q = P * P  # |Fq2|; q % 16 == 9


def sswu_derived_constants():
    """SSWU constants as oracle Fq2 values: (A, B, Z, sqrt candidates
    [1, u, sqrt(u), sqrt(-u)])."""
    root_u = Fq2(0, 1).sqrt()
    root_nu = Fq2(0, P - 1).sqrt()
    assert root_u is not None and root_nu is not None
    return (Fq2(*SSWU_A2), Fq2(*SSWU_B2), Fq2(*SSWU_Z2),
            (Fq2(1, 0), Fq2(0, 1), root_u, root_nu))


_A, _B, _Z, _SQRT_CANDS = sswu_derived_constants()

# sqrt_ratio machinery (q = p^2 = 9 mod 16). For t = u*v^7*(u*v^15)^E with
# E = (q-9)/16: t^2*v/u is a 4th root of unity when u/v is square, so one
# of t*{1, w, sqrt(w), sqrt(-w)} (w = sqrt(-1)) is sqrt(u/v); when u/v is
# NOT square, Z*u/v is (Z is a non-residue), and sqrt(Z*u/v) = C_Z*t*cand
# with the constant C_Z = Z^(1+E). This is the RFC 9380 F.2.1 contract
# ((True, sqrt(u/v)) | (False, sqrt(Z*u/v))) with ONE exponentiation.
SQRT_RATIO_E = (_Q - 9) // 16
_C_Z = _Z.pow(1 + SQRT_RATIO_E)
SQRT_RATIO_BITS = np.asarray([int(b) for b in bin(SQRT_RATIO_E)[2:]], np.int32)

A_DEV = tower.fq2_to_dev(_A)
B_DEV = tower.fq2_to_dev(_B)
Z_DEV = tower.fq2_to_dev(_Z)
C_Z_DEV = tower.fq2_to_dev(_C_Z)
SQRT_CANDS_DEV = np.stack([tower.fq2_to_dev(c) for c in _SQRT_CANDS])  # [4, 2, 48]


def _f2c(c) -> np.ndarray:
    return tower.fp2_to_dev(c[0] % P, c[1] % P)


ISO_XNUM = np.stack([_f2c(c) for c in ISO3_X_NUM])  # [4, 2, 48]
ISO_XDEN = np.stack([_f2c(c) for c in ISO3_X_DEN])  # [3, 2, 48]
ISO_YNUM = np.stack([_f2c(c) for c in ISO3_Y_NUM])  # [4, 2, 48]
ISO_YDEN = np.stack([_f2c(c) for c in ISO3_Y_DEN])  # [4, 2, 48]

# Budroni-Pintore scalars (X_PARAM < 0).
_K_X2 = X_PARAM * X_PARAM - X_PARAM - 1  # x^2 - x - 1 > 0
_K_X1 = X_PARAM - 1                      # negative: [x - 1]Q = [1 - x](-Q)


def _c(arr, like: torch.Tensor) -> torch.Tensor:
    """A module-level numpy Fp2 constant [2, 48] broadcast to ``like``'s
    shape (``const`` caches by the array's identity: never pass a slice)."""
    return const(arr, like.device).expand(like.shape)


# ------------------------------------------------------------ field bits


def fp2_pow_const(a, e_bits: np.ndarray):
    """a^e for a constant exponent bit string (MSB first), batched: square
    and multiply, the leading bit consuming a. A zero bit skips the product
    that the reference computes and then discards by select: same limbs."""
    acc = a
    for bit in e_bits[1:]:
        acc = fp2_sqr(acc)
        if bit:
            acc = fp2_mul(acc, a)
    return acc


def sqrt_ratio(u, v):
    """Batched RFC 9380 F.2.1 sqrt_ratio: (is_square, y) with y = sqrt(u/v)
    when u/v is a square, else y = sqrt(Z*u/v). Division-free, ONE
    exponentiation. The first candidate that hits wins."""
    v2 = fp2_sqr(v)
    v4 = fp2_sqr(v2)
    v7 = fp2_mul(fp2_mul(v4, v2), v)
    uv7 = fp2_mul(u, v7)
    uv15 = fp2_mul(uv7, fp2_mul(v4, v4))
    t = fp2_mul(uv7, fp2_pow_const(uv15, SQRT_RATIO_BITS))

    cands = const(SQRT_CANDS_DEV, t.device)

    def first_hit(base, target, ok, root):
        """The first base * cand whose square times v is target, on lanes
        where nothing hit yet."""
        for i in range(4):
            cand = fp2_mul(base, cands[i].expand(t.shape))
            hit = tower.fp2_eq(fp2_mul(fp2_sqr(cand), v), target) & ~ok
            root = FP2_OPS.select(hit, cand, root)
            ok = ok | hit
        return ok, root

    no_hit = torch.zeros(t.shape[:-2], dtype=torch.bool, device=t.device)
    is_sq, root = first_hit(t, u, no_hit, torch.zeros_like(t))
    zu = fp2_mul(_c(Z_DEV, u), u)
    _, root = first_hit(fp2_mul(t, _c(C_Z_DEV, t)), zu, is_sq, root)
    return is_sq, root


def fp2_sgn0(a):
    """RFC 9380 sgn0 for Fp2 (m = 2) on Montgomery limbs -> int32[...]:
    the parity of c0's canonical standard form, or c1's when c0 == 0."""
    c0 = field.from_mont(a[..., 0, :])
    c1 = field.from_mont(a[..., 1, :])
    sign0 = c0[..., 0] & 1
    zero0 = (c0 == 0).all(-1).to(torch.int32)
    sign1 = c1[..., 0] & 1
    return sign0 | (zero0 & sign1)


# ------------------------------------------------------------------ SSWU


def sswu_fq2(u):
    """Simplified SWU onto E2' (RFC 9380 §6.6.2), batched and
    division-free: u [..., 2, 48] -> (x_num, x_den, y) with affine
    x = x_num/x_den on y^2 = x^3 + A'x + B'.

    x1 = (-B/A)(1 + 1/(Z^2u^4 + Zu^2)) = num1/den with num1 = B(tv2+1),
    den = -A*tv2 (tv2 = Z^2u^4 + Zu^2); the exceptional tv2 == 0 lane gets
    den = Z*A, so x1 = B/(Z*A). gx1 = gxn/gxd with gxn = num1^3 +
    A*num1*den^2 + B*den^3, gxd = den^3. In the non-square case
    x2 = Z*u^2*x1 and y2 = Z*u^2*u*y1."""
    a, b, z = _c(A_DEV, u), _c(B_DEV, u), _c(Z_DEV, u)
    one = _c(tower.FP2_ONE, u)
    tv1 = fp2_mul(z, fp2_sqr(u))  # Z u^2
    tv2 = fp2_add(fp2_sqr(tv1), tv1)
    exc = tower.fp2_is_zero(tv2)
    num1 = fp2_mul(b, fp2_add(tv2, one))
    den = FP2_OPS.select(exc, fp2_mul(z, a), fp2_neg(fp2_mul(a, tv2)))
    den2 = fp2_sqr(den)
    gxn = fp2_add(
        fp2_add(fp2_mul(fp2_sqr(num1), num1), fp2_mul(fp2_mul(a, num1), den2)),
        fp2_mul(b, fp2_mul(den2, den)),
    )
    gxd = fp2_mul(den2, den)
    is_sq, y1 = sqrt_ratio(gxn, gxd)

    x_num = FP2_OPS.select(is_sq, num1, fp2_mul(tv1, num1))
    y = FP2_OPS.select(is_sq, y1, fp2_mul(fp2_mul(tv1, u), y1))
    flip = fp2_sgn0(u) != fp2_sgn0(y)
    y = FP2_OPS.select(flip, fp2_neg(y), y)
    return x_num, den, y


def _poly_frac(coeffs, npows, dpows, deg: int):
    """A degree-``deg`` polynomial at the fraction n/d, scaled by d^deg:
    sum_i c_i * n^i * d^(deg-i). npows/dpows are power tables."""
    table = const(coeffs, npows[1].device)
    acc = None
    for i in range(deg + 1):
        term = fp2_mul(table[i].expand(npows[1].shape),
                       fp2_mul(npows[i], dpows[deg - i]))
        acc = term if acc is None else fp2_add(acc, term)
    return acc


def iso3_jacobian(xn_in, xd_in, y):
    """3-isogeny E2' -> E2 on a fractional x = xn_in/xd_in, no inversions.

    Each rational map scaled by xd_in^deg is a polynomial in (xn_in,
    xd_in); x_iso = Xn/(d*Xd) and y_iso = y*Yn/Yd pack into Jacobian
    coordinates with Z = (d*Xd)*Yd (a zero denominator gives infinity, the
    oracle's exceptional-case rule)."""
    one = _c(tower.FP2_ONE, xn_in)
    npows = [one, xn_in, fp2_sqr(xn_in)]
    npows.append(fp2_mul(npows[2], xn_in))
    dpows = [one, xd_in, fp2_sqr(xd_in)]
    dpows.append(fp2_mul(dpows[2], xd_in))

    Xn = _poly_frac(ISO_XNUM, npows, dpows, 3)
    Xd = _poly_frac(ISO_XDEN, npows, dpows, 2)
    Yn = _poly_frac(ISO_YNUM, npows, dpows, 3)
    Yd = _poly_frac(ISO_YDEN, npows, dpows, 3)

    xd2 = fp2_mul(xd_in, Xd)
    Z = fp2_mul(xd2, Yd)
    X = fp2_mul(Xn, fp2_mul(xd2, fp2_sqr(Yd)))
    Y = fp2_mul(fp2_mul(y, Yn), fp2_mul(fp2_mul(xd2, fp2_sqr(xd2)), fp2_sqr(Yd)))
    return (X, Y, Z)


# -------------------------------------------------------------- cofactor


def psi_jacobian(Q):
    """psi on Jacobian coordinates: conj is an Fp2 automorphism, so applying
    it coordinate-wise and scaling by the affine twist constants commutes
    with x = X/Z^2, y = Y/Z^3 (crypto/bls/curve.py psi)."""
    X, Y, Z = Q
    return (
        fp2_mul(tower.fp2_conj(X), _c(PSI_CX_DEV, X)),
        fp2_mul(tower.fp2_conj(Y), _c(PSI_CY_DEV, Y)),
        tower.fp2_conj(Z),
    )


def clear_cofactor(Q):
    """h_eff * Q via Budroni-Pintore (crypto/bls/curve.py clear_cofactor_g2):
    (x^2-x-1) Q + (x-1) psi(Q) + psi(psi(2Q))."""
    t0 = pt_scalar_mul_const(FP2_OPS, Q, _K_X2)
    t1m = pt_scalar_mul_const(FP2_OPS, pt_neg(FP2_OPS, Q), -_K_X1)
    t1 = psi_jacobian(t1m)
    t2 = psi_jacobian(psi_jacobian(pt_double(FP2_OPS, Q)))
    return pt_add(FP2_OPS, pt_add(FP2_OPS, t0, t1), t2)


# -------------------------------------------------------------- pipeline


def map_to_g2(u):
    """The classic pipeline: u [n, 2, 2, 48] (two Fq2 per message,
    Montgomery) -> canonical affine (x, y, inf) G2 batch."""
    xn0, xd0, y0 = sswu_fq2(u[:, 0])
    xn1, xd1, y1 = sswu_fq2(u[:, 1])
    Q = pt_add(FP2_OPS, iso3_jacobian(xn0, xd0, y0), iso3_jacobian(xn1, xd1, y1))
    return pt_to_affine(FP2_OPS, clear_cofactor(Q))


# ------------------------------------------------------------- host side


def hash_to_field_dev(msgs, dst: bytes = DST) -> np.ndarray:
    """Host: messages -> u [n, 2, 2, 48] (Montgomery limbs).

    expand_message_xmd runs in hashlib; the 64-byte-to-field reduction uses
    Python big ints. Repeated messages inside one batch are hashed once and
    their rows copied (power-of-two padding repeats a batch's first
    message); hash_to_field is a pure function of (msg, dst), so the copy
    equals a recomputation."""
    out = np.empty((len(msgs), 2, 2, 48), np.int32)
    first_row: dict[bytes, int] = {}
    for i, msg in enumerate(msgs):
        j0 = first_row.setdefault(bytes(msg), i)
        if j0 != i:
            out[i] = out[j0]
            continue
        uniform = expand_message_xmd(msg, dst, 4 * H2F_L)
        for j in range(2):
            for k in range(2):
                off = H2F_L * (k + j * 2)
                v = int.from_bytes(uniform[off : off + H2F_L], "big") % P
                out[i, j, k] = tower.fp_to_dev(v)  # standard -> Montgomery
    return out


def hash_to_g2_batch(msgs, dst: bytes = DST):
    """The classic batched hash_to_curve on the CPU: messages -> canonical
    affine (x[n,2,48], y[n,2,48], inf[n])."""
    return map_to_g2(torch.from_numpy(hash_to_field_dev(msgs, dst)))
