"""Batched BLS12-381 optimal-ate pairing on tensors.

Port of ``lighthouse_tpu/ops/pairing.py``: Miller loop over the bits of |x|
in Jacobian coordinates with division-free line evaluation (each line is
scaled by a nonzero Fp2 factor that the final exponentiation annihilates),
a final conjugation for x < 0, then the easy part and the
Hayashida-Hayasaka-Teruya hard-part chain.

|x| is a constant, so the Python loops over its bits run the addition step
(and the multiply of a cyclotomic power) only on its 6 one bits; the
reference computes both legs every step and selects. The kept leg's limbs
are the same.
"""

from __future__ import annotations

import torch

from .field import const
from .points import FP2_OPS, X_BITS, pt_from_affine
from .tower import (
    FP12_ONE,
    FP2_ZERO,
    _stk2,
    _stk6,
    fp12_conj,
    fp12_frobenius,
    fp12_frobenius2,
    fp12_inv,
    fp12_mul,
    fp12_sqr,
    fp2_double,
    fp2_mul_fp,
    fp2_neg,
    fp2_sub,
    fp2_triple,
)

def _embed_line(A, B, C, xp, yp):
    """Sparse line value -> dense Fp12.

    l = A + B*xp (slot c0.c1) + C*yp (slot c1.c1), matching the oracle's
    twist embedding: G1 x rides the w^2 (= v) slot, G1 y the w^3 (= v*w)
    slot. xp/yp are Fp tensors; A/B/C are Fp2.
    """
    z = const(FP2_ZERO, A.device).expand(A.shape)
    c0 = _stk2(A, fp2_mul_fp(B, xp), z)
    c1 = _stk2(z, fp2_mul_fp(C, yp), z)
    return _stk6(c0, c1)


def _dbl_step(T):
    """Double T and return the line through T (scaled by 2YZ^3).

    Coefficients: A = E*X - 2B, B_xp = -E*Z^2, C_yp = Z3*Z^2 with
    E = 3X^2, B = Y^2, Z3 = 2YZ. Products are stacked by dependency level
    (``muln``); each keeps the limbs of its unstacked call.
    """
    muln = FP2_OPS.muln
    Xc, Yc, Zc = T
    A_, B_, Zh, Z_sq = muln((Xc, Xc), (Yc, Yc), (Yc, Zc), (Zc, Zc))
    XB = FP2_OPS.add(Xc, B_)
    C_, S_ = muln((B_, B_), (XB, XB))
    D_ = fp2_double(fp2_sub(fp2_sub(S_, A_), C_))
    E_ = fp2_triple(A_)
    F_, EX, EZ = muln((E_, E_), (E_, Xc), (E_, Z_sq))
    X3 = fp2_sub(F_, fp2_double(D_))
    Z3 = fp2_double(Zh)
    Y3a, lC = muln((E_, fp2_sub(D_, X3)), (Z3, Z_sq))
    Y3 = fp2_sub(Y3a, fp2_double(fp2_double(fp2_double(C_))))
    lA = fp2_sub(EX, fp2_double(B_))
    lB = fp2_neg(EZ)
    return (X3, Y3, Z3), (lA, lB, lC)


def _add_step(T, Qaff):
    """T + Q (Q affine) and the line through them (scaled by 2ZH).

    Coefficients: A = r*xq - Z3*yq, B_xp = -r, C_yp = Z3 with
    r = 2(S2 - Y), H = U2 - X, Z3 = 2ZH (madd-2007-bl mixed addition).
    """
    muln = FP2_OPS.muln
    X1, Y1, Z1 = T
    xq, yq = Qaff
    (Z1Z1,) = muln((Z1, Z1))
    U2, Tz = muln((xq, Z1Z1), (Z1, Z1Z1))
    (S2,) = muln((yq, Tz))
    H = fp2_sub(U2, X1)
    r = fp2_double(fp2_sub(S2, Y1))
    H2 = fp2_double(H)
    Z1H = FP2_OPS.add(Z1, H)
    I, HH, ZS, rr = muln((H2, H2), (H, H), (Z1H, Z1H), (r, r))
    J, V = muln((H, I), (X1, I))
    X3 = fp2_sub(fp2_sub(rr, J), fp2_double(V))
    Z3 = fp2_sub(fp2_sub(ZS, Z1Z1), HH)  # 2 Z1 H
    Y3a, Y3b, lA1, lA2 = muln((r, fp2_sub(V, X3)), (Y1, J), (r, xq), (Z3, yq))
    Y3 = fp2_sub(Y3a, fp2_double(Y3b))
    return (X3, Y3, Z3), (fp2_sub(lA1, lA2), fp2_neg(r), Z3)


def _mul_line_dense(f, line, xp, yp):
    """f * l with the line embedded as a dense Fp12."""
    return fp12_mul(f, _embed_line(*line, xp, yp))


def _sel12(mask, a, b):
    return torch.where(mask[(...,) + (None,) * 4], a, b)


def miller_loop(p_aff, p_inf, q_aff, q_inf, mul_line=_mul_line_dense):
    """Batched Miller loop f_{|x|,Q}(P), conjugated for x < 0.

    p_aff: (xp, yp) Fp tensors [..., 48]; q_aff: (xq, yq) Fp2 tensors.
    Lanes with P or Q at infinity yield Fp12 one. ``mul_line(f, line, xp,
    yp)`` multiplies a line into f (dense here; sparse for kernel K8's plain
    version, ``tkernel_pairing.miller_loop_seg``).
    """
    xp, yp = p_aff
    T = pt_from_affine(FP2_OPS, q_aff[0], q_aff[1], q_inf)
    one = const(FP12_ONE, xp.device)
    f = one.expand(*xp.shape[:-1], *one.shape)
    for bit in X_BITS:
        f = fp12_sqr(f)
        T, line = _dbl_step(T)
        f = mul_line(f, line, xp, yp)
        if bit == "1":
            T, line = _add_step(T, q_aff)
            f = mul_line(f, line, xp, yp)
    f = fp12_conj(f)  # x < 0
    return _sel12(p_inf | q_inf, one.expand(f.shape), f)


# ------------------------------------------------------ final exponentiation


def _cyc_pow_x(f):
    """f^x (x the negative BLS parameter), cyclotomic subgroup only."""
    acc = f  # the leading bit consumes f itself
    for bit in X_BITS:
        acc = fp12_sqr(acc)
        if bit == "1":
            acc = fp12_mul(acc, f)
    return fp12_conj(acc)  # x < 0


def _cyc_pow_x_minus_1(f):
    return fp12_mul(_cyc_pow_x(f), fp12_conj(f))


def easy_part(f):
    """f^((p^6 - 1)(p^2 + 1))."""
    f = fp12_mul(fp12_conj(f), fp12_inv(f))      # f^(p^6 - 1)
    return fp12_mul(fp12_frobenius2(f), f)       # ^(p^2 + 1)


def final_exponentiation(f):
    """f^(3(p^12-1)/r): easy part then the HHT hard-part chain, exactly the
    oracle's schedule, batched."""
    f = easy_part(f)
    a = _cyc_pow_x_minus_1(_cyc_pow_x_minus_1(f))
    b = fp12_mul(_cyc_pow_x(a), fp12_frobenius(a))
    c = fp12_mul(
        fp12_mul(_cyc_pow_x(_cyc_pow_x(b)), fp12_frobenius2(b)), fp12_conj(b)
    )
    return fp12_mul(fp12_mul(c, fp12_sqr(f)), f)


def fp12_tree_prod_groups(f, group_size: int):
    """Per-group products ``f[G, n, ...] -> [G, ...]`` by binary halving
    along axis 1, all G folds in one batched chain (reference:
    ``fp12_tree_prod_groups``; pad groups with one). G = 1 is the
    reference's ``fp12_tree_prod`` of the whole batch."""
    n = group_size
    if n & (n - 1):
        raise ValueError("pad to a power of two")
    while n > 1:
        half = n // 2
        f = fp12_mul(f[:, :half], f[:, half:n])
        n = half
    return f[:, 0]
