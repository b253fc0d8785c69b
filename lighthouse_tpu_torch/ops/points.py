"""Batched Jacobian-coordinate G1/G2 group arithmetic on tensors.

Port of ``lighthouse_tpu/ops/points.py``: the same branch-free formulas and
lane masks, so every output limb equals the reference's. A point batch is a
tuple ``(X, Y, Z)`` of field tensors (Fp: [..., 48], Fp2: [..., 2, 48]),
Jacobian (x = X/Z^2, y = Y/Z^3), Montgomery limbs; ``Z == 0`` encodes
infinity. Case analysis (P==Q, P==-Q, either infinite) is lane masks and
selects, never branches on data.

Python loops take the place of ``lax.scan``. Where the loop runs over the
bits of a constant (a subgroup order), a zero bit skips the addition that
the reference computes and then discards by select: same limbs, less work.
Per-lane scalars (the RLC blinding bits) keep compute-both-and-select.

Field genericity: every function takes a namespace ``F`` (FP_OPS or
FP2_OPS) so G1 and G2 share one code path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls.constants import G1_X, G1_Y, R as CURVE_ORDER, X as X_BLS
from . import field, tower
from .field import const


class FieldOps:
    """Namespace of batched field ops (trailing-axis polymorphic)."""

    def __init__(self, *, mul, sqr, add, sub, neg, double, inv, is_zero, eq,
                 zero, one, ndim_tail, canon, sqr_is_mul):
        self.mul, self.sqr, self.add, self.sub = mul, sqr, add, sub
        self.neg, self.double, self.inv = neg, double, inv
        self.is_zero, self.eq = is_zero, eq
        self.zero, self.one = zero, one  # numpy constants, shape = tail dims
        self.ndim_tail = ndim_tail
        # Full reduction [0,2p) -> [0,p) at representation boundaries
        # (pt_to_affine), so equal points are bitwise equal across schedules.
        self.canon = canon
        # True where sqr(a) gives the limbs of mul(a, a) (Fp); False where
        # squaring has its own formula and representative (Fp2).
        self.sqr_is_mul = sqr_is_mul

    def select(self, mask, a, b):
        """a where mask else b, broadcasting mask over the field tail dims."""
        return torch.where(mask[(...,) + (None,) * self.ndim_tail], a, b)

    def triple(self, a):
        return self.add(self.double(a), a)

    def muln(self, *pairs):
        """Independent products at one dependency level, stacked into one
        multiplication (two for Fp2: squarings, marked by object identity
        ``(v, v)``, keep their own formula, as in the reference's unstacked
        Fp2 loop). Each product's limbs are those of the call it replaces."""
        groups: dict[bool, list[int]] = {True: [], False: []}
        for i, (a, b) in enumerate(pairs):
            groups[a is b and not self.sqr_is_mul].append(i)
        out: list = [None] * len(pairs)
        for is_sqr, idx in groups.items():
            if not idx:
                continue
            if len(idx) == 1:
                a, b = pairs[idx[0]]
                out[idx[0]] = self.sqr(a) if is_sqr else self.mul(a, b)
                continue
            xs = torch.broadcast_tensors(*(t for i in idx for t in pairs[i]))
            A = torch.stack(xs[0::2])
            res = self.sqr(A) if is_sqr else self.mul(A, torch.stack(xs[1::2]))
            for j, i in enumerate(idx):
                out[i] = res[j]
        return tuple(out)


FP_OPS = FieldOps(
    mul=field.mont_mul, sqr=field.mont_sqr, add=field.add, sub=field.sub,
    neg=field.neg, double=field.double, inv=field.mont_inv,
    is_zero=field.is_zero, eq=field.eq,
    zero=field.ZERO_LIMBS, one=field.R_LIMBS, ndim_tail=1,
    canon=field.canonical, sqr_is_mul=True,
)

FP2_OPS = FieldOps(
    mul=tower.fp2_mul, sqr=tower.fp2_sqr, add=tower.fp2_add,
    sub=tower.fp2_sub, neg=tower.fp2_neg, double=tower.fp2_double,
    inv=tower.fp2_inv, is_zero=tower.fp2_is_zero, eq=tower.fp2_eq,
    zero=tower.FP2_ZERO, one=tower.FP2_ONE, ndim_tail=2,
    canon=field.canonical,  # trailing-limb-axis polymorphic over the 2
    sqr_is_mul=False,
)


# ------------------------------------------------------------ constructors


def pt_infinity(F, shape, device):
    """Batch of points at infinity: (1, 1, 0) in Jacobian form."""
    one = const(F.one, device).expand(*shape, *F.one.shape)
    zero = const(F.zero, device).expand(*shape, *F.zero.shape)
    return (one, one, zero)


def pt_is_infinity(F, P):
    return F.is_zero(P[2])


def pt_from_affine(F, x, y, inf_mask=None):
    """Affine coords (+ optional infinity mask) -> Jacobian batch."""
    z = const(F.one, x.device).expand(x.shape)
    if inf_mask is not None:
        z = F.select(inf_mask, const(F.zero, x.device).expand(x.shape), z)
    return (x, y, z)


def pt_to_affine(F, P):
    """Jacobian -> affine (batched inversion); infinity -> (0, 0, True).

    Outputs are canonical ([0, p) limbs): affine coordinates are the
    representation boundary where group-op schedules must agree bitwise."""
    X, Y, Z = P
    zi = F.inv(Z)          # 0 -> 0, so infinity lanes stay zeroed
    zi2 = F.sqr(zi)
    return (
        F.canon(F.mul(X, zi2)),
        F.canon(F.mul(Y, F.mul(zi, zi2))),
        F.is_zero(Z),
    )


def pt_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


# -------------------------------------------------------------- group law


def pt_double(F, P):
    """Jacobian doubling (classic 5S+2M values); maps infinity->infinity.

    Scheduled as 4 dependency levels of products (muln):
    {X², Y², Y·Z} → {B², (X+B)²} → E² → E·(D-X3)."""
    X, Y, Z = P
    A, B, Zh = F.muln((X, X), (Y, Y), (Y, Z))
    XB = F.add(X, B)
    C, S = F.muln((B, B), (XB, XB))
    D = F.double(F.sub(F.sub(S, A), C))
    E = F.triple(A)
    Fq = F.sqr(E)
    X3 = F.sub(Fq, F.double(D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.double(F.double(F.double(C))))
    Z3 = F.double(Zh)
    return (X3, Y3, Z3)


def pt_add(F, P, Q):
    """Complete Jacobian addition via masked case analysis.

    General add-2007-bl style formulas, with selects for: P infinite (->Q),
    Q infinite (->P), P==Q (->double), P==-Q (Z3 vanishes naturally).
    """
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    # 6 dependency levels of products (F.muln).
    Z1Z1, Z2Z2 = F.muln((Z1, Z1), (Z2, Z2))
    U1, U2, T1, T2 = F.muln(
        (X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1)
    )
    S1, S2 = F.muln((Y1, T1), (Y2, T2))
    H = F.sub(U2, U1)
    r = F.double(F.sub(S2, S1))
    H2 = F.double(H)
    Z12 = F.add(Z1, Z2)
    I, rr, ZS = F.muln((H2, H2), (r, r), (Z12, Z12))
    J, V, Z3 = F.muln(
        (H, I), (U1, I), (F.sub(F.sub(ZS, Z1Z1), Z2Z2), H)
    )
    X3 = F.sub(F.sub(rr, J), F.double(V))
    Y3a, Y3b = F.muln((r, F.sub(V, X3)), (S1, J))
    Y3 = F.sub(Y3a, F.double(Y3b))

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    same_x = F.is_zero(H)
    same_y = F.is_zero(r)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    # same_x & ~same_y -> P == -Q: H == 0 makes Z3 == 0, already infinity.

    D = pt_double(F, P)
    out = tuple(F.select(is_dbl, d, g) for d, g in zip(D, (X3, Y3, Z3)))
    out = tuple(F.select(q_inf, p, o) for p, o in zip(P, out))
    out = tuple(F.select(p_inf, q, o) for q, o in zip(Q, out))
    return out


def pt_add_mixed(F, P, Qaff, q_inf):
    """P (Jacobian) + Q (affine, with explicit infinity mask).

    madd-2007-bl schedule (Z2 == 1 saves 4 muls vs pt_add); same masked
    case analysis.
    """
    X1, Y1, Z1 = P
    X2, Y2 = Qaff
    # 6 dependency levels of products (F.muln).
    Z1Z1 = F.sqr(Z1)
    U2, T = F.muln((X2, Z1Z1), (Z1, Z1Z1))
    S2 = F.mul(Y2, T)
    H = F.sub(U2, X1)
    r = F.double(F.sub(S2, Y1))
    H2 = F.double(H)
    Z1H = F.add(Z1, H)
    I, HH, ZS, rr = F.muln((H2, H2), (H, H), (Z1H, Z1H), (r, r))
    J, V = F.muln((H, I), (X1, I))
    X3 = F.sub(F.sub(rr, J), F.double(V))
    Y3a, Y3b = F.muln((r, F.sub(V, X3)), (Y1, J))
    Y3 = F.sub(Y3a, F.double(Y3b))
    Z3 = F.sub(F.sub(ZS, Z1Z1), HH)  # = 2 Z1 H

    p_inf = F.is_zero(Z1)
    same_x = F.is_zero(H)
    same_y = F.is_zero(r)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf

    D = pt_double(F, P)
    out = tuple(F.select(is_dbl, d, g) for d, g in zip(D, (X3, Y3, Z3)))
    out = tuple(F.select(q_inf, p, o) for p, o in zip(P, out))
    Qj = pt_from_affine(F, X2, Y2, q_inf)  # mask kept: inf+inf stays inf
    out = tuple(F.select(p_inf, q, o) for q, o in zip(Qj, out))
    return out


# ------------------------------------------------------------- scalar mul


def pt_scalar_mul_bits(F, Qaff, q_inf, bits):
    """[k]Q for per-lane scalars given as bit tensors, MSB first.

    Left-to-right double-and-add over an affine base (mixed additions):
    bits has shape [..., n_bits] matching the batch shape of Qaff. Both
    legs run every step and a per-lane select keeps one.
    """
    acc = pt_infinity(F, q_inf.shape, q_inf.device)
    for i in range(bits.shape[-1]):
        acc = pt_double(F, acc)
        cand = pt_add_mixed(F, acc, Qaff, q_inf)
        take = bits[..., i] == 1
        acc = tuple(F.select(take, c, a) for c, a in zip(cand, acc))
    return acc


def pt_scalar_mul_const(F, P, k: int):
    """[k]P for a constant scalar (same for all lanes); the addition runs
    only on the one bits of k."""
    if k < 0:
        return pt_scalar_mul_const(F, pt_neg(F, P), -k)
    if k == 0:
        return pt_infinity(F, P[2].shape[: P[2].dim() - F.ndim_tail],
                           P[2].device)
    acc = P  # the leading bit consumes P itself
    for bit in bin(k)[3:]:
        acc = pt_double(F, acc)
        if bit == "1":
            acc = pt_add(F, acc, P)
    return acc


def pt_subgroup_check(F, P):
    """[r]P == infinity; batched. Infinity itself passes (callers mask
    separately where the spec says otherwise)."""
    return pt_is_infinity(F, pt_scalar_mul_const(F, P, CURVE_ORDER))


# Bits of |x| (x = X_BLS < 0, the BLS parameter) below its leading one, MSB
# first: the static schedule of every x-chain (this subgroup check, the
# Miller loop, the cyclotomic power of the final exponentiation). The
# leading one is the chain's initial value; each bit then doubles, and a one
# bit adds.
X_BITS = bin(-X_BLS)[3:]


def subgroup_check_g2_fast(x, y, inf):
    """G2 membership by the psi criterion, psi(Q) == [x]Q, per lane: the plain
    version of kernel K4 (reference: ``tkernel_calls._subgroup_fast_kernel``).

    x, y: affine Fp2 [..., 2, 48] on the curve; inf: bool [...]. [|x|]Q on
    |x|'s static bits, negated (x < 0), compared with psi(Q) without an
    inversion; [x]Q at infinity fails a finite Q. Infinity passes, as in
    :func:`pt_subgroup_check`."""
    F = FP2_OPS
    acc = pt_from_affine(F, x, y, inf)  # the leading bit of |x|
    for bit in X_BITS:
        acc = pt_double(F, acc)
        if bit == "1":
            acc = pt_add_mixed(F, acc, (x, y), inf)
    xj, yj, zj = acc
    yj = F.neg(yj)
    px, py = F.muln(
        (tower.fp2_conj(x), const(PSI_CX_DEV, x.device)),
        (tower.fp2_conj(y), const(PSI_CY_DEV, x.device)),
    )
    z2 = F.sqr(zj)
    z3 = F.mul(z2, zj)
    lx, ly = F.muln((px, z2), (py, z3))
    return (F.eq(lx, xj) & F.eq(ly, yj) & ~F.is_zero(zj)) | inf


# -------------------------------------------------------------- reductions


def pt_tree_sum(F, P, axis_size: int):
    """Sum a batch of points along the leading axis by binary halving
    (power-of-two size, pad with infinity): log2(n) batched pt_add rounds."""
    return pt_tree_sum_axis(F, P, 0, axis_size)


def pt_tree_sum_axis(F, P, axis: int, axis_size: int):
    """Like pt_tree_sum but over an arbitrary axis (e.g. per-set pubkey
    aggregation over a padded [n_sets, k_max] layout)."""
    n = axis_size
    if n & (n - 1):
        raise ValueError("pad to a power of two")
    while n > 1:
        half = n // 2
        lo = tuple(c.narrow(axis, 0, half) for c in P)
        hi = tuple(c.narrow(axis, half, half) for c in P)
        P = pt_add(F, lo, hi)
        n = half
    return tuple(c.squeeze(axis) for c in P)


# ------------------------------------------------------- host conversions


def _mont_batch(ints) -> np.ndarray:
    """Host ints (standard domain) -> Montgomery limb batch [n, 48]."""
    return field.ints_to_limbs_mont(ints)


def g1_to_dev(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G1 AffinePoints -> (x, y, inf_mask) numpy batch (Montgomery)."""
    xs = _mont_batch([p.x.n for p in points])
    ys = _mont_batch([p.y.n for p in points])
    inf = np.asarray([p.infinity for p in points])
    return xs, ys, inf


def g2_to_dev(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle G2 AffinePoints -> (x, y, inf_mask) with Fp2 coords."""
    n = len(points)
    flat = []
    for p in points:
        flat.append(p.x.c0)
        flat.append(p.x.c1)
        flat.append(p.y.c0)
        flat.append(p.y.c1)
    limbs = _mont_batch(flat).reshape(n, 4, 48)
    xs = np.ascontiguousarray(limbs[:, 0:2])
    ys = np.ascontiguousarray(limbs[:, 2:4])
    inf = np.asarray([p.infinity for p in points])
    return xs, ys, inf


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def g1_from_dev(x, y, inf):
    """Affine batch -> oracle AffinePoints (tests/serialization)."""
    from ..crypto.bls.curve import AffinePoint, FQ_B1, g1_infinity
    from ..crypto.bls.fields import Fq

    x, y, inf = _host(x), _host(y), _host(inf)
    out = []
    for i in range(x.shape[0]):
        if bool(inf[i]):
            out.append(g1_infinity())
        else:
            out.append(AffinePoint(
                Fq(tower.fp_from_dev(x[i])), Fq(tower.fp_from_dev(y[i])),
                False, FQ_B1,
            ))
    return out


def g2_from_dev(x, y, inf):
    from ..crypto.bls.curve import AffinePoint, FQ2_B2, g2_infinity
    from ..crypto.bls.fields import Fq2

    x, y, inf = _host(x), _host(y), _host(inf)
    out = []
    for i in range(x.shape[0]):
        if bool(inf[i]):
            out.append(g2_infinity())
        else:
            out.append(AffinePoint(
                Fq2(*tower.fp2_from_dev(x[i])), Fq2(*tower.fp2_from_dev(y[i])),
                False, FQ2_B2,
            ))
    return out


# psi-endomorphism twist constants (Montgomery form).
from ..crypto.bls.curve import _PSI_CX, _PSI_CY  # noqa: E402

PSI_CX_DEV = tower.fq2_to_dev(_PSI_CX)
PSI_CY_DEV = tower.fq2_to_dev(_PSI_CY)

# Generators (affine, Montgomery form).
G1_GEN_DEV = (tower.fp_to_dev(G1_X), tower.fp_to_dev(G1_Y))


def scalars_to_bits(ks, nbits: int) -> np.ndarray:
    """Host ints -> int32[n, nbits] bit tensor, MSB first."""
    out = np.zeros((len(ks), nbits), np.int32)
    for i, k in enumerate(ks):
        if k < 0 or k >> nbits:
            raise ValueError("scalar out of range")
        for j in range(nbits):
            out[i, nbits - 1 - j] = (k >> j) & 1
    return out
