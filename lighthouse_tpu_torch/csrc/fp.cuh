// BLS12-381 base-field (Fp) word arithmetic for Hopper (sm_90a).
//
// An Fp value is 12 little-endian 32-bit words in Montgomery form with
// R = 2^384, the same integer the torch layer stores as 48 int32 byte limbs
// (ops/field.py). Values live in the lazy domain [0, 2p): no function here
// performs a final reduction to [0, p), which is what keeps every result
// bit-identical to the JAX reference (lighthouse_tpu/ops/limb.py).
//
// Kernel K1 (mont_mul.cu) runs fp_mul on rows it packs with limbs_to_word /
// word_to_limbs; the fused kernels reach these functions through tower.cuh
// (and K2 the divstep inversion fp_inv_gcd). The word loops
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

// 4 int32 byte limbs (each in [0, 255]) <-> one 32-bit word.
__device__ __forceinline__ uint32_t limbs_to_word(const int4 v) {
  return (uint32_t)v.x | ((uint32_t)v.y << 8) | ((uint32_t)v.z << 16) |
         ((uint32_t)v.w << 24);
}

__device__ __forceinline__ int4 word_to_limbs(uint32_t w) {
  return make_int4((int)(w & 0xffu), (int)((w >> 8) & 0xffu),
                   (int)((w >> 16) & 0xffu), (int)(w >> 24));
}

// 48 int32 byte limbs -> 12 words, packed in registers. `src` points at
// the value's 48 limbs as 12 int4 (16-byte aligned).
__device__ __forceinline__ void fp_load(const int4* __restrict__ src,
                                        uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = limbs_to_word(src[k]);
}

// 12 words -> 48 int32 byte limbs.
__device__ __forceinline__ void fp_store(int4* __restrict__ dst,
                                         const uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) dst[k] = word_to_limbs(w[k]);
}

// ------------------------------------------------------ carry chains
// The PTX carry flag threads one chain of add.cc / addc / mad*.cc words; a
// chain's instructions stay in program order (asm volatile) and no other
// chain runs between them. The Carry argument names the chain: it is empty
// work on the card, and a host compiler (which sees the portable branch)
// keeps the flag in it, so the word arithmetic can be checked off the card.

struct Carry {
  uint32_t c = 0u;
};

#if defined(__CUDA_ARCH__)
#define LH_ASM(...) asm volatile(__VA_ARGS__)
__device__ __forceinline__ uint32_t add_cc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  LH_ASM("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo / hi word of a * b, plus c (and the flag, for madc), setting the flag.
__device__ __forceinline__ uint32_t mad_lo_cc(Carry&, uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  LH_ASM("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(Carry&, uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  LH_ASM("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(Carry&, uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  LH_ASM("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(Carry&, uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  LH_ASM("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
#undef LH_ASM
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
#else
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
__device__ __forceinline__ uint32_t add_w(Carry& k, uint64_t s) {
  k.c = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t sub_w(Carry& k, uint64_t d) {
  k.c = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
__device__ __forceinline__ uint32_t add_cc(Carry& k, uint32_t a, uint32_t b) {
  return add_w(k, (uint64_t)a + b);
}
__device__ __forceinline__ uint32_t addc_cc(Carry& k, uint32_t a, uint32_t b) {
  return add_w(k, (uint64_t)a + b + k.c);
}
__device__ __forceinline__ uint32_t addc(Carry& k, uint32_t a, uint32_t b) {
  return a + b + k.c;
}
__device__ __forceinline__ uint32_t sub_cc(Carry& k, uint32_t a, uint32_t b) {
  return sub_w(k, (uint64_t)a - b);
}
__device__ __forceinline__ uint32_t subc_cc(Carry& k, uint32_t a, uint32_t b) {
  return sub_w(k, (uint64_t)a - b - k.c);
}
__device__ __forceinline__ uint32_t subc(Carry& k, uint32_t a, uint32_t b) {
  return a - b - k.c;
}
__device__ __forceinline__ uint32_t mad_lo_cc(Carry& k, uint32_t a, uint32_t b,
                                              uint32_t c) {
  return add_w(k, (uint64_t)(a * b) + c);
}
__device__ __forceinline__ uint32_t madc_lo_cc(Carry& k, uint32_t a, uint32_t b,
                                               uint32_t c) {
  return add_w(k, (uint64_t)(a * b) + c + k.c);
}
__device__ __forceinline__ uint32_t madc_hi_cc(Carry& k, uint32_t a, uint32_t b,
                                               uint32_t c) {
  return add_w(k, (((uint64_t)a * b) >> 32) + c + k.c);
}
__device__ __forceinline__ uint32_t madc_hi(Carry& k, uint32_t a, uint32_t b,
                                            uint32_t c) {
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + k.c);
}
#endif

// The word products of a Montgomery product, even and odd word apart. Each
// helper reads every other word of `a` (a or a + 1): the products of those
// words by one word b are 64-bit pairs that do not overlap, so a 12-word
// accumulator takes them in one carry chain.

// r = a[0, 2, .., 10] * b as six 64-bit pairs.
__device__ __forceinline__ void mul_n(uint32_t r[kWords], const uint32_t* a,
                                      uint32_t b) {
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    r[j] = a[j] * b;
    r[j + 1] = mul_hi(a[j], b);
  }
}

// acc += a[0, 2, .., 10] * b; the chain's carry out of acc[11] is left in k.
__device__ __forceinline__ void cmad_n(Carry& k, uint32_t acc[kWords],
                                       const uint32_t* a, uint32_t b) {
  acc[0] = mad_lo_cc(k, a[0], b, acc[0]);
  acc[1] = madc_hi_cc(k, a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    acc[j] = madc_lo_cc(k, a[j], b, acc[j]);
    acc[j + 1] = madc_hi_cc(k, a[j], b, acc[j + 1]);
  }
}

// acc = (acc >> 64) + a[0, 2, .., 10] * b + the carry in k, which ends here.
__device__ __forceinline__ void madc_n_rshift(Carry& k, uint32_t acc[kWords],
                                              const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < kWords - 2; j += 2) {
    acc[j] = madc_lo_cc(k, a[j], b, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(k, a[j], b, acc[j + 3]);
  }
  acc[kWords - 2] = madc_lo_cc(k, a[kWords - 2], b, 0u);
  acc[kWords - 1] = madc_hi(k, a[kWords - 2], b, 0u);
}

// One CIOS step, T = (T + a * b + m * p) / 2^32 with m = T * -1/p mod 2^32,
// on the running sum T = lo + hi * 2^32: lo holds the words at positions
// 0..11, hi those at 1..12. The previous step's lo (whose word 0 the
// reduction made 0) comes in as hi and its hi as lo: dividing by 2^32 moves
// hi's word 1 to position 0 and the rest of hi down two words into the odd
// positions. `first` starts T at a * b.
__device__ __forceinline__ void mad_redc(uint32_t lo[kWords],
                                         uint32_t hi[kWords],
                                         const uint32_t a[kWords], uint32_t b,
                                         bool first) {
  Carry k;
  if (first) {
    mul_n(hi, a + 1, b);
    mul_n(lo, a, b);
  } else {
    // lo[0] + hi[1] (hi's word 1 moves to position 0), its carry into the
    // shift of hi down two words, which takes a's odd products
    lo[0] = add_cc(k, lo[0], hi[1]);
    madc_n_rshift(k, hi, a + 1, b);
    cmad_n(k, lo, a, b);
    hi[kWords - 1] = addc(k, hi[kWords - 1], 0u);
  }
  const uint32_t m = lo[0] * kNInv;
  cmad_n(k, hi, kP + 1, m);  // hi < 2^384 throughout: no carry out
  cmad_n(k, lo, kP, m);
  hi[kWords - 1] = addc(k, hi[kWords - 1], 0u);
}

// r = a * b * 2^-384 mod-ish p: word-level CIOS on PTX carry chains and NO
// final conditional subtraction. For a, b in [0, 2p) the result
// (a*b + m*p) / 2^384 lies in [0, 2p). The quotient m is the unique value
// in [0, 2^384) with a*b + m*p = 0 mod 2^384 whether it is built from
// 32-bit words (here) or 8-bit digits (the reference), so the output is
// the same integer as lighthouse_tpu.ops.limb.mont_mul, limb for limb.
//
// The running sum is kept as two accumulators, the even-aligned and the
// odd-aligned words of every row (sppark's mont_t layout), so the two
// chains of a step have no carry between them. Since p < 2^381, every
// running sum stays below a + p < 2^383 after a step and below 2^415
// before its division, so 12 words of each accumulator hold it and no
// chain carries out of its top word except where the code says.
__device__ __forceinline__ void fp_mul(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t even[kWords], odd[kWords];
#pragma unroll
  for (int i = 0; i < kWords; i += 2) {
    mad_redc(even, odd, a, b[i], i == 0);
    mad_redc(odd, even, a, b[i + 1], false);
  }
  // odd holds the even-aligned words after the last step, whose word 0 is
  // 0: r = (odd >> 32) + even
  Carry k;
  r[0] = add_cc(k, even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) r[j] = addc_cc(k, even[j], odd[j + 1]);
  r[kWords - 1] = addc(k, even[kWords - 1], 0u);
}

// r = a + b, minus 2p when the sum reaches 2p: the reference's lazy add
// (lighthouse_tpu/ops/limb.py add). Inputs and output in [0, 2p), so the
// sum fits in 12 words.
__device__ __forceinline__ void fp_add(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t s[kWords], d[kWords];
  Carry k;
  s[0] = add_cc(k, a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) s[j] = addc_cc(k, a[j], b[j]);
  d[0] = sub_cc(k, s[0], kTwoP[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = subc_cc(k, s[j], kTwoP[j]);
  const uint32_t below = subc(k, 0u, 0u);  // all ones when s < 2p
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = below ? s[j] : d[j];
}

// r = a - b, plus 2p when a < b: the reference's lazy sub
// (lighthouse_tpu/ops/limb.py sub). Inputs and output in [0, 2p).
__device__ __forceinline__ void fp_sub(uint32_t r[kWords],
                                       const uint32_t a[kWords],
                                       const uint32_t b[kWords]) {
  uint32_t d[kWords];
  Carry k;
  d[0] = sub_cc(k, a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) d[j] = subc_cc(k, a[j], b[j]);
  const uint32_t mask = subc(k, 0u, 0u);  // all ones when a < b
  r[0] = add_cc(k, d[0], kTwoP[0] & mask);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) r[j] = addc_cc(k, d[j], kTwoP[j] & mask);
  r[kWords - 1] = addc(k, d[kWords - 1], kTwoP[kWords - 1] & mask);
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

// ------------------------------------------------- inversion by divsteps
// Bernstein and Yang's constant-time GCD ("Fast constant-time gcd
// computation and modular inversion", IACR TCHES 2019(3), Theorem 11.2):
// for odd f and f^2 + 4 g^2 <= 5 * 2^(2d), divstep^m(1, f, g) has g = 0 once
// m >= floor((49 d + 57) / 17) (d >= 46). With f = p and 0 <= g < p,
// d = 381 and m = 1,101; the loop runs 37 batches of 30 = 1,110 divsteps,
// the same count in every lane, so a warp's lanes never diverge. The words
// follow libsecp256k1's modinv32 (signed 30-bit limbs, a batch of divsteps
// as one 2x2 matrix on the low limbs, (d, e) kept in (-2p, p) by adding
// multiples of p that clear their low 30 bits), with delta in place of its
// zeta, since the bound above is for divsteps from delta = 1.

constexpr int kDivstepBatch = 30;
constexpr int kDivstepBatches = 37;  // 37 * 30 = 1,110 >= 1,101
constexpr int kS30 = 13;             // 13 x 30 = 390 bits: 381 and a sign
constexpr int32_t kM30 = 0x3fffffff;

// p in 30-bit limbs, and p^-1 mod 2^30.
__device__ __constant__ const int32_t kP30[kS30] = {
    0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e,
    0x034a83da, 0x112bf673, 0x12e13ce1, 0x2cd76477, 0x1ed90d2e,
    0x29a4b1ba, 0x3a8e5ff9, 0x001a0111};
constexpr uint32_t kPInv30 = 0x30003u;

// R^3 mod p: fp_mul by it takes the integer inverse of a R back to
// Montgomery form, (a R)^-1 R^3 R^-1 = a^-1 R.
__device__ __constant__ const uint32_t kR3[kWords] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu,
    0x615e29ddu, 0x9a53352au, 0x921e1761u, 0x34c04e5eu,
    0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

// 30 divsteps on the low 30 bits of f (odd) and g. Returns the new delta
// and the transition matrix t = (u, v, q, r) scaled by 2^30:
// 2^30 (f', g') = (u f + v g, q f + r g), with |u| + |v| <= 2^30 and
// |q| + |r| <= 2^30. Masks in place of branches: c1 = (delta > 0),
// c2 = (g odd); a swap step is (1 - delta, g, (g - f) / 2), any other
// (1 + delta, f, (g + (g & 1) f) / 2).
__device__ __forceinline__ int32_t divsteps_30(int32_t delta, uint32_t f,
                                               uint32_t g, int32_t t[4]) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < kDivstepBatch; ++i) {
    const uint32_t c1 = (uint32_t)((-delta) >> 31);
    const uint32_t c2 = 0u - (g & 1u);
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    const uint32_t c = c1 & c2;
    delta = (int32_t)(((uint32_t)delta ^ c) - c) + 1;
    f += g & c;
    u += q & c;
    v += r & c;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return delta;
}

// (f, g) = t (f, g) / 2^30, exact (the divsteps cleared the low 30 bits).
__device__ __forceinline__ void update_fg_30(int32_t f[kS30], int32_t g[kS30],
                                             const int32_t t[4]) {
  int64_t cf = (int64_t)t[0] * f[0] + (int64_t)t[1] * g[0];
  int64_t cg = (int64_t)t[2] * f[0] + (int64_t)t[3] * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cf += (int64_t)t[0] * f[i] + (int64_t)t[1] * g[i];
    cg += (int64_t)t[2] * f[i] + (int64_t)t[3] * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    g[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f[kS30 - 1] = (int32_t)cf;
  g[kS30 - 1] = (int32_t)cg;
}

// (d, e) = (t (d, e) + p (md, me)) / 2^30 with md, me chosen so the low
// 30 bits vanish (and p added where d or e is negative): d, e stay in
// (-2p, p) and keep f = d x, g = e x mod p for the input x.
__device__ __forceinline__ void update_de_30(int32_t d[kS30], int32_t e[kS30],
                                             const int32_t t[4]) {
  const int32_t sd = d[kS30 - 1] >> 31, se = e[kS30 - 1] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  int64_t cd = (int64_t)t[0] * d[0] + (int64_t)t[1] * e[0];
  int64_t ce = (int64_t)t[2] * d[0] + (int64_t)t[3] * e[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)kP30[0] * md;
  ce += (int64_t)kP30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cd += (int64_t)t[0] * d[i] + (int64_t)t[1] * e[i] + (int64_t)kP30[i] * md;
    ce += (int64_t)t[2] * d[i] + (int64_t)t[3] * e[i] + (int64_t)kP30[i] * me;
    d[i - 1] = (int32_t)cd & kM30;
    e[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d[kS30 - 1] = (int32_t)cd;
  e[kS30 - 1] = (int32_t)ce;
}

// Carry each limb's bits above 30 into the next: limbs back in [0, 2^30)
// but the top one, which keeps the sign.
__device__ __forceinline__ void carry_30(int32_t a[kS30]) {
#pragma unroll
  for (int i = 0; i < kS30 - 1; ++i) {
    a[i + 1] += a[i] >> 30;
    a[i] &= kM30;
  }
}

// a in (-2p, p) -> a * sign(s) in [0, p): add p if negative, negate if
// s < 0, add p if still negative.
__device__ __forceinline__ void normalize_30(int32_t a[kS30], int32_t s) {
  int32_t m = a[kS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) a[i] += kP30[i] & m;
  const int32_t n = s >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) a[i] = (a[i] ^ n) - n;
  carry_30(a);
  m = a[kS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) a[i] += kP30[i] & m;
  carry_30(a);
}

// r = x^-1 mod p as a plain integer in [0, p) (0 -> 0), for x in [0, p).
__device__ __forceinline__ void gcd_inverse(uint32_t r[kWords],
                                            const uint32_t x[kWords]) {
  int32_t f[kS30], g[kS30], d[kS30], e[kS30];
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    const int b = 30 * i, w = b / 32, s = b % 32;
    uint32_t v = x[w] >> s;
    if (s > 2 && w + 1 < kWords) v |= x[w + 1] << (32 - s);
    f[i] = kP30[i];
    g[i] = (int32_t)(v & (uint32_t)kM30);
    d[i] = 0;
    e[i] = i == 0 ? 1 : 0;
  }
  int32_t delta = 1;
#pragma unroll 1
  for (int b = 0; b < kDivstepBatches; ++b) {
    int32_t t[4];
    delta = divsteps_30(delta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  // g = 0 and f = +-1 (or f = p when x = 0, where d = 0): x^-1 = d * f
  normalize_30(d, f[kS30 - 1]);
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int b = 32 * j, l = b / 30, s = b % 30;  // s is even: s <= 28
    uint32_t v = (uint32_t)d[l] >> s;
    if (l + 1 < kS30) v |= (uint32_t)d[l + 1] << (30 - s);
    r[j] = v;
  }
}

// r = a^-1 in Montgomery form (0 -> 0) for a in [0, 2p): a reduced to
// [0, p), its integer inverse by the divsteps above, then one fp_mul by
// R^3. Same value mod p as fp_inv; the representative in [0, 2p) may
// differ, so it serves where the result is made canonical (K2).
__device__ __forceinline__ void fp_inv_gcd(uint32_t r[kWords],
                                           const uint32_t a[kWords]) {
  uint32_t c[kWords], i[kWords];
  fp_canonical(c, a);
  gcd_inverse(i, c);
  fp_mul(r, i, kR3);
}

}  // namespace fp
