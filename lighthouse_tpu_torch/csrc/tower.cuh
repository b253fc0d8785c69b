// BLS12-381 tower fields Fp2 / Fp6 / Fp12 for the fused kernels (sm_90a).
//
// The same construction as ops/tower.py (Fp2 = Fp[u]/(u^2+1),
// Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v)) and the same layout:
// a struct holds its coefficients in the order of the torch tensor's axes,
// so Fp12 is the [2, 3, 2, 48] block of one lane. Every function follows its
// ops/tower.py counterpart op for op (the same Karatsuba terms, added and
// subtracted in the same order, on the lazy [0, 2p) values of fp.cuh), so a
// kernel's output equals the plain version's limb for limb.
//
// The Fp level is inlined; every Fp2 product and everything above it is a
// real call (__noinline__): one copy of each body per kernel, not one per
// use, which keeps nvcc to seconds per source. The price is that the
// operands of those calls live in local memory.

#pragma once

#include "fp.cuh"

namespace bls {

using fp::kWords;

struct Fp {
  uint32_t w[kWords];
};
struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c[3];
};
struct Fp12 {
  Fp6 c[2];
};

// xi^((p-1)/3), xi^(2(p-1)/3), xi^((p-1)/6) with xi = 1 + u, Montgomery
// form, [c0, c1] words (ops/tower.py FROB6_C1, FROB6_C2, FROB12_C1).
__device__ __constant__ const uint32_t kFrob6C1[2][kWords] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
    {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u,
     0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu,
     0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}};
__device__ __constant__ const uint32_t kFrob6C2[2][kWords] = {
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u,
     0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu,
     0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}};
__device__ __constant__ const uint32_t kFrob12C1[2][kWords] = {
    {0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u,
     0xd117228fu, 0x97e83cccu, 0xb2dc29eeu, 0xa35baecau,
     0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
    {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu,
     0x2599d394u, 0xcf4895d4u, 0x40a8e8d0u, 0xc11b9cbau,
     0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}};

// ------------------------------------------------------------ load / store
// N consecutive Fp values (48 int32 limbs each) of one lane.

template <class T>
__device__ __forceinline__ void load(T& x, const int4* __restrict__ src) {
  constexpr int n = sizeof(T) / sizeof(Fp);
  Fp* v = reinterpret_cast<Fp*>(&x);
#pragma unroll
  for (int i = 0; i < n; ++i) fp::fp_load(src + i * kWords, v[i].w);
}

template <class T>
__device__ __forceinline__ void store(int4* __restrict__ dst, const T& x) {
  constexpr int n = sizeof(T) / sizeof(Fp);
  const Fp* v = reinterpret_cast<const Fp*>(&x);
#pragma unroll
  for (int i = 0; i < n; ++i) fp::fp_store(dst + i * kWords, v[i].w);
}

__device__ __forceinline__ Fp fp_const(const uint32_t c[kWords]) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = c[j];
  return r;
}

__device__ __forceinline__ Fp2 fp2_const(const uint32_t c[2][kWords]) {
  return {fp_const(c[0]), fp_const(c[1])};
}

// --------------------------------------------------------------------- Fp

__device__ __forceinline__ Fp zero(Fp) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kWords; ++j) r.w[j] = 0u;
  return r;
}
__device__ __forceinline__ Fp one(Fp) { return fp_const(fp::kOne); }

__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp r;
  fp::fp_add(r.w, a.w, b.w);
  return r;
}
__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp r;
  fp::fp_sub(r.w, a.w, b.w);
  return r;
}
__device__ __forceinline__ Fp neg(const Fp& a) {
  Fp r;
  fp::fp_neg(r.w, a.w);
  return r;
}
__device__ __forceinline__ Fp dbl(const Fp& a) { return add(a, a); }
__device__ __forceinline__ Fp triple(const Fp& a) { return add(dbl(a), a); }
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
  Fp r;
  fp::fp_mul(r.w, a.w, b.w);
  return r;
}
// Fp squares are products (FieldOps.sqr_is_mul in ops/points.py).
__device__ __forceinline__ Fp sqr(const Fp& a) { return mul(a, a); }
__device__ __forceinline__ Fp canonical(const Fp& a) {
  Fp r;
  fp::fp_canonical(r.w, a.w);
  return r;
}
__device__ __forceinline__ bool is_zero(const Fp& a) {
  return fp::fp_is_zero(a.w);
}
__device__ __forceinline__ bool eq(const Fp& a, const Fp& b) {
  return fp::fp_eq(a.w, b.w);
}
__device__ __noinline__ Fp inv(const Fp& a) {
  Fp r;
  fp::fp_inv(r.w, a.w);
  return r;
}

// -------------------------------------------------------------------- Fp2

__device__ __forceinline__ Fp2 zero(Fp2) { return {zero(Fp()), zero(Fp())}; }
__device__ __forceinline__ Fp2 one(Fp2) { return {one(Fp()), zero(Fp())}; }

__device__ __forceinline__ Fp2 add(const Fp2& a, const Fp2& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 sub(const Fp2& a, const Fp2& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 neg(const Fp2& a) {
  return {neg(a.c0), neg(a.c1)};
}
__device__ __forceinline__ Fp2 dbl(const Fp2& a) { return add(a, a); }
__device__ __forceinline__ Fp2 triple(const Fp2& a) { return add(dbl(a), a); }
__device__ __forceinline__ Fp2 canonical(const Fp2& a) {
  return {canonical(a.c0), canonical(a.c1)};
}
__device__ __forceinline__ bool is_zero(const Fp2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}
__device__ __forceinline__ bool eq(const Fp2& a, const Fp2& b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

// Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
// (t0 - t1, (t2 - t0) - t1)  (ops/tower.py fp2_mul)
__device__ __noinline__ Fp2 mul(const Fp2& a, const Fp2& b) {
  const Fp sa = add(a.c0, a.c1);
  const Fp sb = add(b.c0, b.c1);
  const Fp t0 = mul(a.c0, b.c0);
  const Fp t1 = mul(a.c1, b.c1);
  const Fp t2 = mul(sa, sb);
  return {sub(t0, t1), sub(sub(t2, t0), t1)};
}

// ((a0+a1)(a0-a1), 2 a0 a1)  (ops/tower.py fp2_sqr)
__device__ __noinline__ Fp2 sqr(const Fp2& a) {
  const Fp s = add(a.c0, a.c1);
  const Fp d = sub(a.c0, a.c1);
  return {mul(s, d), dbl(mul(a.c0, a.c1))};
}

__device__ __forceinline__ Fp2 mul_fp(const Fp2& a, const Fp& k) {
  return {mul(a.c0, k), mul(a.c1, k)};
}

// times xi = 1 + u: (c0 - c1, c0 + c1)
__device__ __forceinline__ Fp2 mul_by_xi(const Fp2& a) {
  return {sub(a.c0, a.c1), add(a.c0, a.c1)};
}

__device__ __forceinline__ Fp2 conj(const Fp2& a) { return {a.c0, neg(a.c1)}; }

// (c0 - c1 u) / (c0^2 + c1^2); 0 -> 0  (ops/tower.py fp2_inv)
__device__ __noinline__ Fp2 inv(const Fp2& a) {
  const Fp ni = inv(add(mul(a.c0, a.c0), mul(a.c1, a.c1)));
  return {mul(a.c0, ni), mul(neg(a.c1), ni)};
}

// -------------------------------------------------------------------- Fp6

__device__ __forceinline__ Fp6 add(const Fp6& a, const Fp6& b) {
  return {{add(a.c[0], b.c[0]), add(a.c[1], b.c[1]), add(a.c[2], b.c[2])}};
}
__device__ __forceinline__ Fp6 sub(const Fp6& a, const Fp6& b) {
  return {{sub(a.c[0], b.c[0]), sub(a.c[1], b.c[1]), sub(a.c[2], b.c[2])}};
}
__device__ __forceinline__ Fp6 neg(const Fp6& a) {
  return {{neg(a.c[0]), neg(a.c[1]), neg(a.c[2])}};
}

// The 6-product Toom/Karatsuba schedule of ops/tower.py fp6_mul.
__device__ __noinline__ Fp6 mul(const Fp6& a, const Fp6& b) {
  const Fp2 t0 = mul(a.c[0], b.c[0]);
  const Fp2 t1 = mul(a.c[1], b.c[1]);
  const Fp2 t2 = mul(a.c[2], b.c[2]);
  const Fp2 s12 = mul(add(a.c[1], a.c[2]), add(b.c[1], b.c[2]));
  const Fp2 s01 = mul(add(a.c[0], a.c[1]), add(b.c[0], b.c[1]));
  const Fp2 s02 = mul(add(a.c[0], a.c[2]), add(b.c[0], b.c[2]));
  const Fp2 u0 = sub(sub(s12, t1), t2);
  const Fp2 u1 = sub(sub(s01, t0), t1);
  const Fp2 u2 = sub(sub(s02, t0), t2);
  return {{add(mul_by_xi(u0), t0), add(u1, mul_by_xi(t2)), add(u2, t1)}};
}

// (c0, c1, c2) -> (xi c2, c0, c1)
__device__ __forceinline__ Fp6 mul_by_v(const Fp6& a) {
  return {{mul_by_xi(a.c[2]), a.c[0], a.c[1]}};
}

// ops/tower.py fp6_inv: 6 + 3 + 3 Fp2 products (squares as products).
__device__ __noinline__ Fp6 inv(const Fp6& a) {
  const Fp2 &c0 = a.c[0], &c1 = a.c[1], &c2 = a.c[2];
  const Fp2 a_sq = mul(c0, c0), bc = mul(c1, c2), c_sq = mul(c2, c2);
  const Fp2 ab = mul(c0, c1), b_sq = mul(c1, c1), ac = mul(c0, c2);
  const Fp2 t0 = sub(a_sq, mul_by_xi(bc));
  const Fp2 t1 = sub(mul_by_xi(c_sq), ab);
  const Fp2 t2 = sub(b_sq, ac);
  const Fp2 n0 = mul(c0, t0), n1 = mul(c2, t1), n2 = mul(c1, t2);
  const Fp2 d = inv(add(n0, mul_by_xi(add(n1, n2))));
  return {{mul(t0, d), mul(t1, d), mul(t2, d)}};
}

__device__ __noinline__ Fp6 frobenius(const Fp6& a) {
  return {{conj(a.c[0]), mul(conj(a.c[1]), fp2_const(kFrob6C1)),
           mul(conj(a.c[2]), fp2_const(kFrob6C2))}};
}

// ------------------------------------------------------------------- Fp12

__device__ __forceinline__ Fp12 one(Fp12) {
  const Fp2 z = zero(Fp2());
  return {{{{one(Fp2()), z, z}}, {{z, z, z}}}};
}

// Karatsuba over Fp6 (ops/tower.py fp12_mul)
__device__ __noinline__ Fp12 mul(const Fp12& a, const Fp12& b) {
  const Fp6 t0 = mul(a.c[0], b.c[0]);
  const Fp6 t1 = mul(a.c[1], b.c[1]);
  const Fp6 s = mul(add(a.c[0], a.c[1]), add(b.c[0], b.c[1]));
  return {{add(t0, mul_by_v(t1)), sub(sub(s, t0), t1)}};
}

// c0 = (a0+a1)(a0+v a1) - t0 - v t0, c1 = 2 t0, t0 = a0 a1
// (ops/tower.py fp12_sqr)
__device__ __noinline__ Fp12 sqr(const Fp12& a) {
  const Fp6 t0 = mul(a.c[0], a.c[1]);
  const Fp6 s = mul(add(a.c[0], a.c[1]), add(a.c[0], mul_by_v(a.c[1])));
  return {{sub(sub(s, t0), mul_by_v(t0)), add(t0, t0)}};
}

__device__ __forceinline__ Fp12 conj(const Fp12& a) {
  return {{a.c[0], neg(a.c[1])}};
}

__device__ __noinline__ Fp12 inv(const Fp12& a) {
  const Fp6 s0 = mul(a.c[0], a.c[0]);
  const Fp6 s1 = mul(a.c[1], a.c[1]);
  const Fp6 d = inv(sub(s0, mul_by_v(s1)));
  return {{mul(a.c[0], d), neg(mul(a.c[1], d))}};
}

__device__ __noinline__ Fp12 frobenius(const Fp12& a) {
  const Fp6 f1 = frobenius(a.c[1]);
  const Fp2 k = fp2_const(kFrob12C1);
  return {{frobenius(a.c[0]), {{mul(f1.c[0], k), mul(f1.c[1], k),
                                mul(f1.c[2], k)}}}};
}

__device__ __forceinline__ Fp12 frobenius2(const Fp12& a) {
  return frobenius(frobenius(a));
}

// a == 1 mod p, coefficient by coefficient (ops/tower.py fp12_is_one).
__device__ __forceinline__ bool is_one(const Fp12& a) {
  const Fp* v = reinterpret_cast<const Fp*>(&a);
  bool ok = eq(v[0], one(Fp()));
#pragma unroll
  for (int i = 1; i < 12; ++i) ok = ok && is_zero(v[i]);
  return ok;
}

}  // namespace bls
