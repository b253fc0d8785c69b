// BLS12-381 base-field (Fp) word arithmetic for Hopper (sm_90a).
//
// An Fp value is 12 little-endian 32-bit words in Montgomery form with
// R = 2^384, the same integer the torch layer stores as 48 int32 byte limbs
// (ops/field.py). Values live in the lazy domain [0, 2p): no function here
// performs a final reduction to [0, p), which is what keeps every result
// bit-identical to the JAX reference (lighthouse_tpu/ops/limb.py).
//
// Kernel K1 (mont_mul.cu) is a thin loop around fp_load / fp_mul / fp_store;
// the fused kernels reach these functions through tower.cuh. The word loops
// stay unrolled and inlined here; the tower and group-law functions above
// them are out of line, which keeps each kernel's build to seconds.

#pragma once

#include <stdint.h>

namespace fp {

constexpr int kWords = 12;  // 12 x 32 bits = 384 bits >= 381
constexpr int kLimbs = 48;  // int32 byte limbs per value in the torch layout

// p, little-endian 32-bit words.
__device__ __constant__ const uint32_t kP[kWords] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// 2p, little-endian 32-bit words.
__device__ __constant__ const uint32_t kTwoP[kWords] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
    0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
    0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};

// -p^{-1} mod 2^32: the per-word Montgomery quotient constant.
constexpr uint32_t kNInv = 0xfffcfffdu;

// R mod p = 2^384 mod p: one in Montgomery form (ops/field.py R_LIMBS).
__device__ __constant__ const uint32_t kOne[kWords] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// p - 2, the Fermat inversion exponent; its top set bit is bit 380.
__device__ __constant__ const uint32_t kPMinus2[kWords] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr int kPMinus2TopBit = 380;

// 48 int32 byte limbs (each in [0, 255]) -> 12 words, packed in registers.
// `src` points at the value's 48 limbs as 12 int4 (16-byte aligned).
__device__ __forceinline__ void fp_load(const int4* __restrict__ src,
                                        uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int4 v = src[k];
    w[k] = (uint32_t)v.x | ((uint32_t)v.y << 8) | ((uint32_t)v.z << 16) |
           ((uint32_t)v.w << 24);
  }
}

// 12 words -> 48 int32 byte limbs.
__device__ __forceinline__ void fp_store(int4* __restrict__ dst,
                                         const uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    dst[k] = make_int4((int)(w[k] & 0xffu), (int)((w[k] >> 8) & 0xffu),
                       (int)((w[k] >> 16) & 0xffu), (int)(w[k] >> 24));
  }
}

// r = a * b * 2^-384 mod-ish p: word-level CIOS with 64-bit products and
// NO final conditional subtraction. For a, b in [0, 2p) the result
// (a*b + m*p) / 2^384 lies in [0, 2p). The quotient m is the unique value
// in [0, 2^384) with a*b + m*p = 0 mod 2^384 whether it is built from
// 32-bit words (here) or 8-bit digits (the reference), so the output is
// the same integer as lighthouse_tpu.ops.limb.mont_mul, limb for limb.
__device__ __forceinline__ void fp_mul(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0u;

#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);

    // t = (t + m * p) / 2^32 with m chosen so the low word vanishes
    const uint32_t m = t[0] * kNInv;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = (uint64_t)m * kP[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = t[j];
}

// r = a + b, minus 2p when the sum reaches 2p: the reference's lazy add
// (lighthouse_tpu/ops/limb.py add). Inputs and output in [0, 2p).
__device__ __forceinline__ void fp_add(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t s[kWords], d[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)s[j] - kTwoP[j] - br;
    d[j] = (uint32_t)x;
    br = x >> 63;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = br ? s[j] : d[j];
}

// r = a - b, plus 2p when a < b: the reference's lazy sub
// (lighthouse_tpu/ops/limb.py sub). Inputs and output in [0, 2p).
__device__ __forceinline__ void fp_sub(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t d[kWords];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)a[j] - b[j] - br;
    d[j] = (uint32_t)x;
    br = x >> 63;
  }
  const uint32_t mask = br ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d[j] + (kTwoP[j] & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = -a, closed on [0, 2p): 0 -> 0, else 2p - a (ops/field.py neg, which
// is sub(0, a)).
__device__ __forceinline__ void fp_neg(uint32_t r[kWords],
                                       const uint32_t a[kWords]) {
  uint32_t z[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) z[j] = 0u;
  fp_sub(r, z, a);
}

__device__ __forceinline__ void fp_double(uint32_t r[kWords],
                                          const uint32_t a[kWords]) {
  fp_add(r, a, a);
}

// r = a reduced into [0, p) (ops/field.py canonical): a - p when a >= p.
__device__ __forceinline__ void fp_canonical(uint32_t r[kWords],
                                             const uint32_t a[kWords]) {
  uint32_t d[kWords];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t x = (uint64_t)a[j] - kP[j] - br;
    d[j] = (uint32_t)x;
    br = x >> 63;
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = br ? a[j] : d[j];
}

// a == 0 mod p for a in [0, 2p): a == 0 or a == p (ops/field.py is_zero).
__device__ __forceinline__ bool fp_is_zero(const uint32_t a[kWords]) {
  uint32_t z = 0u, q = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    z |= a[j];
    q |= a[j] ^ kP[j];
  }
  return z == 0u || q == 0u;
}

// a == b mod p (ops/field.py eq): equal canonical representatives.
__device__ __forceinline__ bool fp_eq(const uint32_t a[kWords],
                                      const uint32_t b[kWords]) {
  uint32_t ca[kWords], cb[kWords];
  fp_canonical(ca, a);
  fp_canonical(cb, b);
  uint32_t d = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) d |= ca[j] ^ cb[j];
  return d == 0u;
}

// r = a^(p-2) = a^-1 (0 -> 0) by left-to-right square-and-multiply over the
// bits of p - 2 below its top bit, skipping the multiply on zero bits: the
// schedule of ops/field.py mont_inv, so the limbs are the same.
__device__ __forceinline__ void fp_inv(uint32_t r[kWords],
                                       const uint32_t a[kWords]) {
  uint32_t acc[kWords], t[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) acc[j] = a[j];
#pragma unroll 1
  for (int i = kPMinus2TopBit - 1; i >= 0; --i) {
    fp_mul(t, acc, acc);
    if ((kPMinus2[i >> 5] >> (i & 31)) & 1u) {
      fp_mul(acc, t, a);
    } else {
#pragma unroll
      for (int j = 0; j < kWords; ++j) acc[j] = t[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = acc[j];
}

}  // namespace fp
