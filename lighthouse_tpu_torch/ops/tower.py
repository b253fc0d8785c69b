"""Batched BLS12-381 tower-field arithmetic (Fp2 / Fp6 / Fp12) on tensors.

Port of ``lighthouse_tpu/ops/tower.py``: the same construction
(Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v))
and the same representation, coefficient axes stacked ahead of the limbs:

    Fp   : int32[..., 48]
    Fp2  : int32[..., 2, 48]          (c0, c1)
    Fp6  : int32[..., 3, 2, 48]       (c0, c1, c2 -- each Fp2)
    Fp12 : int32[..., 2, 3, 2, 48]    (c0, c1 -- each Fp6)

The reference's multiplication stacking is kept: all independent Fp
products of a tower multiplication go to ONE ``mont_mul`` call (one
``fp2_mul`` per ``fp6_mul``, one ``mont_mul`` per ``fp2_mul``), so the card
sees few, wide K1 launches. Independent additions at one level are stacked
the same way; the add/sub primitives are elementwise, so the limbs are
those of the reference call by call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls.constants import P
from . import field
from .field import add, add_sub, const, double, mont_inv, mont_mul, neg, sub

# ------------------------------------------------------------- host helpers


def fp_to_dev(x: int) -> np.ndarray:
    """Host int (standard domain) -> Montgomery-form limb vector [48]."""
    return field.int_to_limbs((x % P) * field.R_MONT % P)


def fp_from_dev(a) -> int:
    """Montgomery-form limbs -> host int in [0, p)."""
    v = field.limbs_to_int(np.asarray(a))
    return v * pow(field.R_MONT, -1, P) % P


def fp2_to_dev(c0: int, c1: int) -> np.ndarray:
    return np.stack([fp_to_dev(c0), fp_to_dev(c1)])


def fp2_from_dev(a) -> tuple[int, int]:
    a = np.asarray(a)
    return (fp_from_dev(a[..., 0, :]), fp_from_dev(a[..., 1, :]))


def fp6_to_dev(coeffs) -> np.ndarray:
    """coeffs: three (c0, c1) int pairs."""
    return np.stack([fp2_to_dev(*c) for c in coeffs])


def fp12_to_dev(c0_coeffs, c1_coeffs) -> np.ndarray:
    return np.stack([fp6_to_dev(c0_coeffs), fp6_to_dev(c1_coeffs)])


def fq2_to_dev(x) -> np.ndarray:
    """Oracle Fq2 -> limb array [2, 48]."""
    return fp2_to_dev(x.c0, x.c1)


def fq12_to_dev(f) -> np.ndarray:
    """Oracle Fq12 -> limb array [2, 3, 2, 48]."""
    return fp12_to_dev(
        [(x.c0, x.c1) for x in (f.c0.c0, f.c0.c1, f.c0.c2)],
        [(x.c0, x.c1) for x in (f.c1.c0, f.c1.c1, f.c1.c2)],
    )


# --------------------------------------------------------------- constants

def _c2(i: int):
    from ..crypto.bls.fields import _FROB6_C1, _FROB6_C2, _FROB12_C1

    return (_FROB6_C1, _FROB6_C2, _FROB12_C1)[i]


FROB6_C1 = fq2_to_dev(_c2(0))   # xi^((p-1)/3)
FROB6_C2 = fq2_to_dev(_c2(1))   # xi^(2(p-1)/3)
FROB12_C1 = fq2_to_dev(_c2(2))  # xi^((p-1)/6)

FP2_ZERO = fp2_to_dev(0, 0)
FP2_ONE = fp2_to_dev(1, 0)
FP12_ONE = fp12_to_dev([(1, 0), (0, 0), (0, 0)], [(0, 0), (0, 0), (0, 0)])


def _stk2(*xs):
    """Stack Fp2 elements: new axis just before the (coeff, limb) axes."""
    return torch.stack(torch.broadcast_tensors(*xs), dim=-3)


def _stk6(*xs):
    """Stack Fp6 elements: new axis just before the (v, coeff, limb) axes."""
    return torch.stack(torch.broadcast_tensors(*xs), dim=-4)


def _pair(op, x0, y0, x1, y1):
    """(op(x0, y0), op(x1, y1)) as one stacked call."""
    out = op(torch.stack(torch.broadcast_tensors(x0, x1)),
             torch.stack(torch.broadcast_tensors(y0, y1)))
    return out[0], out[1]


# --------------------------------------------------------------------- Fp2
# Elementwise ops (add/sub/neg/double) act on the trailing limb axis and
# broadcast over (c0, c1).

fp2_add = add
fp2_sub = sub
fp2_neg = neg
fp2_double = double


def fp2_mul(a, b):
    """Karatsuba: one stacked mont_mul of 3 products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    sa, sb = _pair(add, a0, a1, b0, b1)
    t = mont_mul(
        torch.stack(torch.broadcast_tensors(a0, a1, sa), dim=-2),
        torch.stack(torch.broadcast_tensors(b0, b1, sb), dim=-2),
    )
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    c0, d = _pair(sub, t0, t1, t2, t0)
    return torch.stack((c0, sub(d, t1)), dim=-2)


def fp2_sqr(a):
    """(a0+a1)(a0-a1) + 2*a0*a1*u: one stacked mont_mul of 2 products."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s, d = add_sub(a0, a1)
    t = mont_mul(torch.stack((s, a0), dim=-2), torch.stack((d, a1), dim=-2))
    return torch.stack((t[..., 0, :], double(t[..., 1, :])), dim=-2)


def fp2_mul_fp(a, k):
    """Fp2 * Fp (k: [..., 48], broadcast over the coefficient axis)."""
    return mont_mul(a, k.unsqueeze(-2))


def fp2_mul_by_xi(a):
    """Multiply by xi = 1 + u: (c0 - c1, c0 + c1)."""
    s, d = add_sub(a[..., 0, :], a[..., 1, :])
    return torch.stack((d, s), dim=-2)


def fp2_conj(a):
    return torch.stack((a[..., 0, :], neg(a[..., 1, :])), dim=-2)


def fp2_triple(a):
    return add(double(a), a)


def fp2_inv(a):
    """1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2); 0 -> 0."""
    s = mont_mul(a, a)  # (c0^2, c1^2) stacked for free on the coeff axis
    norm_inv = mont_inv(add(s[..., 0, :], s[..., 1, :]))
    return torch.stack(
        (
            mont_mul(a[..., 0, :], norm_inv),
            mont_mul(neg(a[..., 1, :]), norm_inv),
        ),
        dim=-2,
    )


def fp2_is_zero(a):
    return field.is_zero(a).all(-1)


def fp2_eq(a, b):
    return field.eq(a, b).all(-1)


# --------------------------------------------------------------------- Fp6

fp6_neg = neg


def _fp6_c(a, i):
    return a[..., i, :, :]


def fp6_mul(a, b):
    """Toom/Karatsuba 6-product schedule, one stacked fp2_mul."""
    a0, a1, a2 = (_fp6_c(a, i) for i in range(3))
    b0, b1, b2 = (_fp6_c(b, i) for i in range(3))
    s = add(_stk2(a1, a0, a0, b1, b0, b0), _stk2(a2, a1, a2, b2, b1, b2))
    x = _stk2(a0, a1, a2, s[..., 0, :, :], s[..., 1, :, :], s[..., 2, :, :])
    y = _stk2(b0, b1, b2, s[..., 3, :, :], s[..., 4, :, :], s[..., 5, :, :])
    t = fp2_mul(x, y)
    t0, t1, t2, s12, s01, s02 = (t[..., i, :, :] for i in range(6))
    # c0 = xi*((s12 - t1) - t2) + t0, c1 = ((s01 - t0) - t1) + xi*t2,
    # c2 = ((s02 - t0) - t2) + t1
    u = sub(_stk2(s12, s01, s02), _stk2(t1, t0, t0))
    u = sub(u, _stk2(t2, t1, t2))
    xi = fp2_mul_by_xi(_stk2(u[..., 0, :, :], t2))
    return add(
        _stk2(xi[..., 0, :, :], u[..., 1, :, :], u[..., 2, :, :]),
        _stk2(t0, xi[..., 1, :, :], t1),
    )


def fp6_mul_by_v(a):
    """(c0, c1, c2) -> (xi*c2, c0, c1)."""
    return _stk2(fp2_mul_by_xi(_fp6_c(a, 2)), _fp6_c(a, 0), _fp6_c(a, 1))


def fp6_mul_fp2(a, k):
    """Fp6 * Fp2 (k broadcast over the v-coefficient axis)."""
    return fp2_mul(a, k.unsqueeze(-3))


def fp6_inv(a):
    """Oracle formula (fields.py Fq6.inv), stacked: 6 + 3 + 3 products."""
    c0, c1, c2 = (_fp6_c(a, i) for i in range(3))
    m = fp2_mul(_stk2(c0, c1, c2, c0, c1, c0), _stk2(c0, c2, c2, c1, c1, c2))
    a_sq, bc, c_sq, ab, b_sq, ac = (m[..., i, :, :] for i in range(6))
    xi = fp2_mul_by_xi(_stk2(bc, c_sq))
    t = sub(_stk2(a_sq, xi[..., 1, :, :], b_sq), _stk2(xi[..., 0, :, :], ab, ac))
    t0, t1, t2 = (t[..., i, :, :] for i in range(3))
    n = fp2_mul(_stk2(c0, c2, c1), t)
    denom = add(n[..., 0, :, :], fp2_mul_by_xi(add(n[..., 1, :, :], n[..., 2, :, :])))
    d_inv = fp2_inv(denom)
    return fp2_mul(t, d_inv.unsqueeze(-3))


def fp6_frobenius(a):
    c = fp2_conj(a)
    k = const(FROB6_C1, a.device), const(FROB6_C2, a.device)
    return _stk2(c[..., 0, :, :], *fp2_mul(c[..., 1:, :, :], torch.stack(k)).unbind(-3))


# -------------------------------------------------------------------- Fp12

def _w(a, i):
    return a[..., i, :, :, :]


def fp12_mul(a, b):
    """Karatsuba over Fp6: one stacked fp6_mul of 3 products."""
    a0, a1 = _w(a, 0), _w(a, 1)
    b0, b1 = _w(b, 0), _w(b, 1)
    sa, sb = _pair(add, a0, a1, b0, b1)
    t = fp6_mul(_stk6(a0, a1, sa), _stk6(b0, b1, sb))
    t0, t1, s = (t[..., i, :, :, :] for i in range(3))
    c0 = add(t0, fp6_mul_by_v(t1))
    c1 = sub(sub(s, t0), t1)
    return _stk6(c0, c1)


def fp12_sqr(a):
    """Oracle formula: c0=(a0+a1)(a0+v a1)-t0-v t0, c1=2 t0, t0=a0*a1."""
    a0, a1 = _w(a, 0), _w(a, 1)
    s = add(_stk6(a0, a0), _stk6(a1, fp6_mul_by_v(a1)))
    t = fp6_mul(_stk6(a0, s[..., 0, :, :, :]), _stk6(a1, s[..., 1, :, :, :]))
    t0, s = t[..., 0, :, :, :], t[..., 1, :, :, :]
    c0 = sub(sub(s, t0), fp6_mul_by_v(t0))
    c1 = double(t0)
    return _stk6(c0, c1)


def fp12_conj(a):
    """Conjugation over Fp6 (= raising to p^6, cyclotomic inverse)."""
    return _stk6(_w(a, 0), fp6_neg(_w(a, 1)))


def fp12_inv(a):
    a0, a1 = _w(a, 0), _w(a, 1)
    s = fp6_mul(_stk6(a0, a1), _stk6(a0, a1))  # squares, stacked
    denom = sub(s[..., 0, :, :, :], fp6_mul_by_v(s[..., 1, :, :, :]))
    d_inv = fp6_inv(denom)
    o = fp6_mul(_stk6(a0, a1), _stk6(d_inv, d_inv))
    return _stk6(o[..., 0, :, :, :], fp6_neg(o[..., 1, :, :, :]))


def fp12_frobenius(a):
    c0 = fp6_frobenius(_w(a, 0))
    c1 = fp6_mul_fp2(fp6_frobenius(_w(a, 1)), const(FROB12_C1, a.device))
    return _stk6(c0, c1)


def fp12_frobenius2(a):
    return fp12_frobenius(fp12_frobenius(a))


def fp12_eq(a, b):
    return field.eq(a, b).flatten(-3).all(-1)


def fp12_is_one(a):
    return fp12_eq(a, const(FP12_ONE, a.device))
