// Jacobian group law on G1 (over Fp) and G2 (over Fp2) for the fused
// kernels, one template over the field (ops/points.py takes a FieldOps
// namespace for the same reason).
//
// The formulas, their order of operations and the lane cases are those of
// ops/points.py: pt_double (5S + 2M), pt_add (add-2007-bl, 5S + 11M) and
// pt_add_mixed (madd-2007-bl) with their masked case analysis (P at infinity -> Q, Q at infinity -> P, P == Q ->
// the doubling, P == -Q -> Z3 = 0), so a lane at infinity stays inert and
// the limbs equal the plain versions'. Where the plain version computes
// both legs and keeps one by a per-lane select, a kernel thread computes
// only the leg it keeps: the same limbs, less work.

#pragma once

#include "tower.cuh"

namespace bls {

// |x| of the BLS parameter x = -0xd201000000010000. Its bits below the
// leading one, most significant first, drive every x-chain: the Miller
// loop, the cyclotomic power f^x and the psi-criterion subgroup check.
constexpr uint64_t kXAbs = 0xd201000000010000ull;
constexpr int kXTopBit = 63;

__device__ __forceinline__ bool x_bit(int i) { return (kXAbs >> i) & 1ull; }

// psi(x, y) = (conj(x) PSI_CX, conj(y) PSI_CY), Montgomery form, [c0, c1]
// words (ops/points.py PSI_CX_DEV, PSI_CY_DEV).
__device__ __constant__ const uint32_t kPsiCx[2][kWords] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u,
     0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu,
     0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};
__device__ __constant__ const uint32_t kPsiCy[2][kWords] = {
    {0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du,
     0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu,
     0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu},
    {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u,
     0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u,
     0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}};

template <class F>
struct Jac {
  F X, Y, Z;
};

// Affine (x, y) with an infinity flag -> Jacobian (x, y, inf ? 0 : 1).
template <class F>
__device__ __forceinline__ Jac<F> pt_from_affine(const F& x, const F& y,
                                                 bool inf) {
  return {x, y, inf ? zero(F()) : one(F())};
}

// ops/points.py pt_double; infinity (Z = 0) maps to infinity.
template <class F>
__device__ __noinline__ Jac<F> pt_double(const Jac<F>& P) {
  const F A = sqr(P.X);
  const F B = sqr(P.Y);
  const F Zh = mul(P.Y, P.Z);
  const F C = sqr(B);
  const F S = sqr(add(P.X, B));
  const F D = dbl(sub(sub(S, A), C));
  const F E = triple(A);
  const F X3 = sub(sqr(E), dbl(D));
  const F Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))));
  return {X3, Y3, dbl(Zh)};
}

template <class F>
__device__ __forceinline__ Jac<F> pt_neg(const Jac<F>& P) {
  return {P.X, neg(P.Y), P.Z};
}

// ops/points.py pt_add: the complete Jacobian addition (add-2007-bl) with
// its case order: P at infinity -> Q, Q at infinity -> P, P == Q -> the
// doubling, P == -Q -> Z3 = 0 (H = 0 makes it so). The zero tests run on
// lazy [0, 2p) values, where zero is 0 or p (fp_is_zero), as F.is_zero.
template <class F>
__device__ __noinline__ Jac<F> pt_add(const Jac<F>& P, const Jac<F>& Q) {
  if (is_zero(P.Z)) return Q;
  if (is_zero(Q.Z)) return P;
  const F Z1Z1 = sqr(P.Z);
  const F Z2Z2 = sqr(Q.Z);
  const F U1 = mul(P.X, Z2Z2);
  const F U2 = mul(Q.X, Z1Z1);
  const F T1 = mul(Q.Z, Z2Z2);
  const F T2 = mul(P.Z, Z1Z1);
  const F S1 = mul(P.Y, T1);
  const F S2 = mul(Q.Y, T2);
  const F H = sub(U2, U1);
  const F r = dbl(sub(S2, S1));
  if (is_zero(H) && is_zero(r)) return pt_double(P);
  const F I = sqr(dbl(H));
  const F rr = sqr(r);
  const F ZS = sqr(add(P.Z, Q.Z));
  const F J = mul(H, I);
  const F V = mul(U1, I);
  const F Z3 = mul(sub(sub(ZS, Z1Z1), Z2Z2), H);
  const F X3 = sub(sub(rr, J), dbl(V));
  const F Y3 = sub(mul(r, sub(V, X3)), dbl(mul(S1, J)));
  return {X3, Y3, Z3};
}

// ops/points.py pt_add_mixed: P (Jacobian) + (x2, y2) (affine, q_inf).
template <class F>
__device__ __noinline__ Jac<F> pt_add_mixed(const Jac<F>& P, const F& x2,
                                            const F& y2, bool q_inf) {
  if (is_zero(P.Z)) return pt_from_affine(x2, y2, q_inf);  // inf + inf = inf
  if (q_inf) return P;
  const F Z1Z1 = sqr(P.Z);
  const F U2 = mul(x2, Z1Z1);
  const F T = mul(P.Z, Z1Z1);
  const F S2 = mul(y2, T);
  const F H = sub(U2, P.X);
  const F r = dbl(sub(S2, P.Y));
  if (is_zero(H) && is_zero(r)) return pt_double(P);
  const F H2 = dbl(H);
  const F Z1H = add(P.Z, H);
  const F I = sqr(H2);
  const F HH = sqr(H);
  const F ZS = sqr(Z1H);
  const F rr = sqr(r);
  const F J = mul(H, I);
  const F V = mul(P.X, I);
  const F X3 = sub(sub(rr, J), dbl(V));
  const F Y3 = sub(mul(r, sub(V, X3)), dbl(mul(P.Y, J)));
  const F Z3 = sub(sub(ZS, Z1Z1), HH);  // = 2 Z1 H
  return {X3, Y3, Z3};
}

}  // namespace bls
