// Hash-to-G2 bodies of kernels K12-K14 (sm_90a), run by a group of threads
// of one warp (warp_curve.cuh Group, Round): the Fp2 power over the
// sqrt_ratio exponent, sqrt_ratio, sgn0, the SSWU + 3-isogeny body, and the
// cofactor body by two |x| walks with warp_curve.cuh's group law.
//
// A group is the 16 threads of a half-warp (one u through SSWU + isogeny)
// or the whole warp (Q0 + Q1 and the cofactor). The products of an isogeny
// step or of sqrt_ratio's set-up go side by side in a round as those of a
// point operation do. A condition on the chain's values (sqrt_ratio's first
// hit, tv2 == 0, is_sq, sgn0) is the same in every thread of the group and
// stays a branch; where the two halves of a warp take different legs, the
// warp runs them one after the other. The bits of the exponents are
// constants, the same for the whole warp.
//
// Each function follows its plain version op for op on the lazy [0, 2p)
// values of fp.cuh (a product computed once where the plain version
// computes it twice gives the same limbs), so a kernel's limbs equal the
// plain version's: the SSWU + isogeny chain is that of ops/htc.py
// (sqrt_ratio, fp2_sgn0, sswu_fq2, iso3_jacobian, psi_jacobian), the
// cofactor that of ops/tkernel_htc.py (cofactor_plain).
//
// The constants are Montgomery-form words, [c0, c1] per Fp2 element
// (ops/htc.py A_DEV, B_DEV, Z_DEV, C_Z_DEV, SQRT_CANDS_DEV, ISO_*); a CPU
// test parses them against the Python constants.

#pragma once

#include "warp_curve.cuh"

namespace bls {

// A' = 240 u
__device__ __constant__ const uint32_t kSswuA[2][kWords] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
    {0x03135242u, 0xe53a0000u, 0xdef80285u, 0x01080c0fu,
     0xe340f6bdu, 0xe7889edbu, 0x26310601u, 0x0b513751u,
     0x17c744abu, 0x02d69857u, 0x79ea5467u, 0x1220b4e9u}};
// B' = 1012 (1 + u)
__device__ __constant__ const uint32_t kSswuB[2][kWords] = {
    {0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu,
     0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u,
     0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu},
    {0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu,
     0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u,
     0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}};
// Z = -(2 + u)
__device__ __constant__ const uint32_t kSswuZ[2][kWords] = {
    {0xfff9555cu, 0x87ebffffu, 0xda8ffffau, 0x656fffe5u,
     0x45d33ad2u, 0x0fd07493u, 0x066576f4u, 0xd951e663u,
     0x41e980d3u, 0xde291a3du, 0x7dfe040du, 0x0815664cu},
    {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u,
     0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u,
     0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u}};
// C_Z = Z^(1 + E)
__device__ __constant__ const uint32_t kCZ[2][kWords] = {
    {0x05eb0ad5u, 0x1aab5a8fu, 0x7f5c75a8u, 0x7f978a13u,
     0xb2dcb26eu, 0x88dddbddu, 0xd31d1798u, 0x5f39d438u,
     0xd8ef2b8eu, 0x8ffe34a7u, 0xabca7e2fu, 0x000fd871u},
    {0x810e8983u, 0xe970a0b7u, 0xf7bdacaau, 0x8d515f4eu,
     0x3a1fcfceu, 0x18b05210u, 0x4654434au, 0x2fc57aedu,
     0x46c49672u, 0x0ebb355au, 0x2d4b5b10u, 0x12c4c8c5u}};
// the square-root candidates 1, u, sqrt(u), sqrt(-u)
__device__ __constant__ const uint32_t kSqrtCands[4][2][kWords] = {
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
      0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
      0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
      0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
      0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}},
    {{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du,
      0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu,
      0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu},
     {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u,
      0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u,
      0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
    {{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du,
      0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu,
      0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu},
     {0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du,
      0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu,
      0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu}}};
// x_num, constant term first
__device__ __constant__ const uint32_t kIsoXNum[4][2][kWords] = {
    {{0x1ce05e62u, 0x47f671c7u, 0x1206393eu, 0x06dd5707u,
      0xf3fd71a2u, 0x7c80cd2au, 0x9e6cd062u, 0x048103eau,
      0xc8d037f6u, 0xc54516acu, 0x0920ea41u, 0x13808f55u},
     {0x1ce05e62u, 0x47f671c7u, 0x1206393eu, 0x06dd5707u,
      0xf3fd71a2u, 0x7c80cd2au, 0x9e6cd062u, 0x048103eau,
      0xc8d037f6u, 0xc54516acu, 0x0920ea41u, 0x13808f55u}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x554c71d0u, 0x5fe55555u, 0x236aaaa3u, 0x873fffddu,
      0xb26ef918u, 0x6a6b4619u, 0x08874945u, 0x21c28884u,
      0x028cabc5u, 0x2836cda7u, 0xa7fd5abdu, 0x0ac73310u}},
    {{0x555971c3u, 0x0a0c5555u, 0x1f9eaaaeu, 0xdb0c0010u,
      0x1d797997u, 0xb1fb2f94u, 0xef416e1cu, 0xd3960742u,
      0xc20556f4u, 0xb70040e2u, 0xe581393bu, 0x149d7861u},
     {0xaaa638e8u, 0xaff2aaaau, 0x91b55551u, 0x439fffeeu,
      0xd9377c8cu, 0xb535a30cu, 0x0443a4a2u, 0x90e14442u,
      0x814655e2u, 0x941b66d3u, 0x53fead5eu, 0x05639988u}},
    {{0x71c725edu, 0x40aac71cu, 0x7a84e38eu, 0x19095555u,
      0x8f41abc3u, 0xd817050au, 0xc87f6fb1u, 0xd86485d4u,
      0xf885d059u, 0x696eb479u, 0x328002d2u, 0x198e1a74u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}};
// x_den (monic)
__device__ __constant__ const uint32_t kIsoXDen[3][2][kWords] = {
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0xff13ab97u, 0x1f3affffu, 0x1da3ff3eu, 0xf25bfc61u,
      0x3819b208u, 0xca3757cbu, 0x6f8cec18u, 0x3e642736u,
      0x6095b089u, 0x03977bc8u, 0x3f39a952u, 0x04f69db1u}},
    {{0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au,
      0x4a6e8b59u, 0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u,
      0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u},
     {0xffd8557du, 0x7588ffffu, 0x6e0bffdfu, 0x41f3ff64u,
      0xac426acau, 0xf7b1e8d2u, 0x32dbb6f8u, 0xb3741acdu,
      0x482d581fu, 0xe9daf5b9u, 0xba7431b8u, 0x167f53e0u}},
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
      0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
      0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}};
// y_num
__device__ __constant__ const uint32_t kIsoYNum[4][2][kWords] = {
    {{0xbdfc77beu, 0x96d8f684u, 0x3b66d0e2u, 0xb530e4f4u,
      0x379652fdu, 0x184a88ffu, 0xfae804e1u, 0x57cb23ecu,
      0xada3eba9u, 0x0fd2e39eu, 0x31c5d5c3u, 0x08c8055eu},
     {0xbdfc77beu, 0x96d8f684u, 0x3b66d0e2u, 0xb530e4f4u,
      0x379652fdu, 0x184a88ffu, 0xfae804e1u, 0x57cb23ecu,
      0xada3eba9u, 0x0fd2e39eu, 0x31c5d5c3u, 0x08c8055eu}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0x1c91b406u, 0xbf0a71c7u, 0x8b7638fdu, 0x4d6d55d2u,
      0x5f205aeeu, 0x9d82f98eu, 0x1d1a18d5u, 0xa27aa27bu,
      0xd2938e86u, 0x02c3b2b2u, 0x0b09807fu, 0x0c7d1342u}},
    {{0x55531c74u, 0xd7f95555u, 0x48daaaa8u, 0x21cffff7u,
      0x6c9bbe46u, 0x5a9ad186u, 0x0221d251u, 0x4870a221u,
      0xc0a32af1u, 0x4a0db369u, 0x29ff56afu, 0x02b1ccc4u},
     {0xaaac8e37u, 0xe205aaaau, 0x68795556u, 0xfcdc0007u,
      0x8a1537ddu, 0x0c96011au, 0xf163406eu, 0x1c06a963u,
      0x82a881e6u, 0x010df44cu, 0x0f808febu, 0x174f4526u}},
    {{0x2f67f35cu, 0xa470bda1u, 0x3327b425u, 0xc0fe38e2u,
      0xc6f0678du, 0xc9d3d0f2u, 0x5b5a982eu, 0x1c55c993u,
      0xf0746764u, 0x27f6c0e2u, 0x28aa9054u, 0x117c5e6eu},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}};
// y_den (monic)
__device__ __constant__ const uint32_t kIsoYDen[4][2][kWords] = {
    {{0xfa765adfu, 0x0162ffffu, 0x0083fb75u, 0x8f7bea48u,
      0x59e93611u, 0x561b3c22u, 0xa9c875d5u, 0x11e19fc1u,
      0x00367660u, 0xca713efcu, 0x41da1151u, 0x03c6a03du},
     {0xfa765adfu, 0x0162ffffu, 0x0083fb75u, 0x8f7bea48u,
      0x59e93611u, 0x561b3c22u, 0xa9c875d5u, 0x11e19fc1u,
      0x00367660u, 0xca713efcu, 0x41da1151u, 0x03c6a03du}},
    {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
     {0xfd3b02c5u, 0x5db0ffffu, 0x58ebfdbau, 0xd713f523u,
      0xa84d161au, 0x5ea60761u, 0x4ea6c44au, 0xbb2c75a3u,
      0x21c1119bu, 0x0ac67359u, 0xbdacfbf6u, 0x0ee3d913u}},
    {{0x003affc5u, 0x66b10000u, 0x64ec0030u, 0xcb1400e7u,
      0x6fa5d106u, 0xa73e5eb5u, 0xa0fe09a9u, 0x8984c913u,
      0x78ad7f13u, 0x11e10afbu, 0x3e918f52u, 0x05429d0eu},
     {0xffc4aae6u, 0x534dffffu, 0x4c67ffcfu, 0x5397ff17u,
      0x870b251du, 0xbff273ebu, 0x52870915u, 0xdaf28271u,
      0xca9e2dc3u, 0x393a9cbau, 0xfaee5748u, 0x14be74dbu}},
    {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
      0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
      0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
      0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}};
// E = (p^2 - 9) / 16, 24 little-endian words; its top set bit is bit 757.
__device__ __constant__ const uint32_t kSqrtRatioE[24] = {
    0x01c718e3u, 0xb26aa000u, 0xd76382eau, 0xd7ced6b1u,
    0x362113cfu, 0x3162c338u, 0xd3e71b74u, 0x966bf91eu,
    0x87091a04u, 0xb292e85au, 0xc86185c7u, 0x11d68619u,
    0x30978ef0u, 0xef531493u, 0xd16ddca6u, 0x050a62cfu,
    0x9349e8bdu, 0x466e59e4u, 0x50e7046bu, 0x9e2dc90eu,
    0xaa22f25eu, 0x74bd278eu, 0x4b8c35fcu, 0x002a437au};
constexpr int kSqrtRatioTopBit = 757;

__device__ __forceinline__ bool sqrt_ratio_e_bit(int i) {
  return (kSqrtRatioE[i >> 5] >> (i & 31)) & 1u;
}

// ------------------------------------------------------------- groups

// Threads per half-warp group: one u of the SSWU + isogeny body.
constexpr int kHalfThreads = 16;

// -------------------------------------------------------------- SSWU

// a^E by square and multiply over E's bits below its top one, the product
// skipped on zero bits (ops/htc.py fp2_pow_const over SQRT_RATIO_BITS): 757
// squaring rounds and 365 product rounds.
template <int S>
__device__ __forceinline__ Fp2 pow_sqrt_ratio_e(const Group<S>& G,
                                                const Fp2& a) {
  Fp2 acc = a;
#pragma unroll 1
  for (int i = kSqrtRatioTopBit - 1; i >= 0; --i) {
    acc = sqr(G, acc);
    if (sqrt_ratio_e_bit(i)) acc = mul(G, acc, a);
  }
  return acc;
}

// RFC 9380 F.2.1 (ops/htc.py sqrt_ratio): true and root = sqrt(u/v) when
// u/v is a square, else false and root = sqrt(Z u/v). The first candidate
// that hits wins; the Z candidates (base t C_Z, target Z u) are tried only
// when no plain one hit. u = 0 gives (true, 0): the first candidate,
// t * 1 = 0, hits.
template <int S>
__device__ __forceinline__ bool sqrt_ratio(const Group<S>& G, Fp2& root,
                                           const Fp2& u, const Fp2& v) {
  const Fp2 v2 = sqr(G, v);
  const Fp2 v4 = sqr(G, v2);
  Fp2 v6, v8;
  {
    Round<S> r(G);
    const MulSlot h6 = r.mul(v4, v2), h8 = r.mul(v4, v4);
    r.run();
    v6 = r.get(h6);
    v8 = r.get(h8);
  }
  const Fp2 uv7 = mul(G, u, mul(G, v6, v));
  const Fp2 uv15 = mul(G, uv7, v8);
  const Fp2 t = mul(G, uv7, pow_sqrt_ratio_e(G, uv15));
  Fp2 base = t, target = u;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    if (i == 4) {
      Round<S> r(G);
      const MulSlot hz = r.mul(fp2_const(kSswuZ), u);
      const MulSlot hb = r.mul(t, fp2_const(kCZ));
      r.run();
      target = r.get(hz);
      base = r.get(hb);
    }
    const Fp2 cand = mul(G, base, fp2_const(kSqrtCands[i & 3]));
    if (eq(mul(G, sqr(G, cand), v), target)) {
      root = cand;
      return i < 4;
    }
  }
  root = zero(Fp2());
  return false;
}

// RFC 9380 sgn0 for Fp2 (ops/htc.py fp2_sgn0) from the products of c0 and
// c1 by standard 1 (ops/field.py from_mont before canonical): c0's parity,
// or c1's when c0 == 0.
__device__ __forceinline__ Fp standard_one() {
  Fp one_std = zero(Fp());
  one_std.w[0] = 1u;
  return one_std;
}

__device__ __forceinline__ int sgn0(const Fp& c0_by_one, const Fp& c1_by_one) {
  const Fp c0 = canonical(c0_by_one);
  const Fp c1 = canonical(c1_by_one);
  uint32_t nz = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) nz |= c0.w[j];
  return (int)(c0.w[0] & 1u) | (int)(nz == 0u && (c1.w[0] & 1u));
}

// The 3-isogeny E2' -> E2 on x = xn / xd, Jacobian out, Z = 0 when a
// denominator vanishes (ops/htc.py iso3_jacobian). Each polynomial is
// sum_i c_i (n^i d^(deg-i)) over the power tables (ops/htc.py _poly_frac),
// summed in the order of i; the products n^i d^(deg-i) are shared among the
// polynomials of one degree.
template <int S>
__device__ __forceinline__ Jac<Fp2> iso3(const Group<S>& G, const Fp2& xn,
                                         const Fp2& xd, const Fp2& y) {
  Fp2 np[4], dp[4], m[4];
  np[0] = dp[0] = one(Fp2());
  np[1] = xn;
  dp[1] = xd;
  {
    Round<S> r(G);
    const SqrSlot hn = r.sqr(xn), hd = r.sqr(xd);
    r.run();
    np[2] = r.get(hn);
    dp[2] = r.get(hd);
  }
  {
    Round<S> r(G);
    const MulSlot hn = r.mul(np[2], xn), hd = r.mul(dp[2], xd);
    r.run();
    np[3] = r.get(hn);
    dp[3] = r.get(hd);
  }
  // sum_i table[i] * m[i] over m[i] = n^i d^(deg-i), i = 0..deg
  auto poly = [&](const uint32_t(*table)[2][kWords], int deg) {
    Round<S> r(G);
    MulSlot h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i <= deg) h[i] = r.mul(fp2_const(table[i]), m[i]);
    r.run();
    Fp2 acc = r.get(h[0]);
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (i <= deg) acc = add(acc, r.get(h[i]));
    return acc;
  };
  auto powers = [&](int deg) {
    Round<S> r(G);
    MulSlot h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i <= deg) h[i] = r.mul(np[i], dp[deg - i]);
    r.run();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i <= deg) m[i] = r.get(h[i]);
  };
  powers(3);
  const Fp2 Xn = poly(kIsoXNum, 3);
  const Fp2 Yn = poly(kIsoYNum, 3);
  const Fp2 Yd = poly(kIsoYDen, 3);
  powers(2);
  const Fp2 Xd = poly(kIsoXDen, 2);

  Fp2 xd2, sYd, yYn;
  {
    Round<S> r(G);
    const MulSlot h1 = r.mul(xd, Xd);
    const SqrSlot h2 = r.sqr(Yd);
    const MulSlot h3 = r.mul(y, Yn);
    r.run();
    xd2 = r.get(h1);
    sYd = r.get(h2);
    yYn = r.get(h3);
  }
  Fp2 Z, m1, sxd2;
  {
    Round<S> r(G);
    const MulSlot h1 = r.mul(xd2, Yd), h2 = r.mul(xd2, sYd);
    const SqrSlot h3 = r.sqr(xd2);
    r.run();
    Z = r.get(h1);
    m1 = r.get(h2);
    sxd2 = r.get(h3);
  }
  Fp2 X, m2;
  {
    Round<S> r(G);
    const MulSlot h1 = r.mul(Xn, m1), h2 = r.mul(xd2, sxd2);
    r.run();
    X = r.get(h1);
    m2 = r.get(h2);
  }
  const Fp2 Y = mul(G, yYn, mul(G, m2, sYd));
  return {X, Y, Z};
}

// Simplified SWU onto E2', division-free, then the isogeny (ops/htc.py
// sswu_fq2 then iso3_jacobian). tv2 == 0 (u = 0) takes den = Z A.
template <int S>
__device__ __noinline__ Jac<Fp2> sswu_iso(const Group<S>& G, const Fp2& u) {
  const Fp2 a = fp2_const(kSswuA);
  const Fp2 b = fp2_const(kSswuB);
  const Fp2 z = fp2_const(kSswuZ);
  const Fp one_std = standard_one();
  Fp2 u2;
  int sgn_u;
  {
    Round<S> r(G);
    const SqrSlot h = r.sqr(u);
    const ProdSlot h0 = r.prod(u.c0, one_std), h1 = r.prod(u.c1, one_std);
    r.run();
    u2 = r.get(h);
    sgn_u = sgn0(r.get(h0), r.get(h1));
  }
  const Fp2 tv1 = mul(G, z, u2);
  const Fp2 tv2 = add(sqr(G, tv1), tv1);
  const bool exc = is_zero(tv2);
  Fp2 num1, den;
  {
    Round<S> r(G);
    const MulSlot hn = r.mul(b, add(tv2, one(Fp2())));
    MulSlot hd;
    if (exc) {
      hd = r.mul(z, a);
    } else {
      hd = r.mul(a, tv2);
    }
    r.run();
    num1 = r.get(hn);
    if (exc) {
      den = r.get(hd);
    } else {
      den = neg(r.get(hd));
    }
  }
  Fp2 den2, n2, an;
  {
    Round<S> r(G);
    const SqrSlot h1 = r.sqr(den), h2 = r.sqr(num1);
    const MulSlot h3 = r.mul(a, num1);
    r.run();
    den2 = r.get(h1);
    n2 = r.get(h2);
    an = r.get(h3);
  }
  Fp2 n3, and2, gxd;
  {
    Round<S> r(G);
    const MulSlot h1 = r.mul(n2, num1), h2 = r.mul(an, den2), h3 = r.mul(den2, den);
    r.run();
    n3 = r.get(h1);
    and2 = r.get(h2);
    gxd = r.get(h3);
  }
  const Fp2 gxn = add(add(n3, and2), mul(G, b, gxd));
  Fp2 y1;
  const bool is_sq = sqrt_ratio(G, y1, gxn, gxd);
  Fp2 xn, y;
  if (is_sq) {
    xn = num1;
    y = y1;
  } else {
    Round<S> r(G);
    const MulSlot h1 = r.mul(tv1, num1), h2 = r.mul(tv1, u);
    r.run();
    xn = r.get(h1);
    y = mul(G, r.get(h2), y1);
  }
  int sgn_y;
  {
    Round<S> r(G);
    const ProdSlot h0 = r.prod(y.c0, one_std), h1 = r.prod(y.c1, one_std);
    r.run();
    sgn_y = sgn0(r.get(h0), r.get(h1));
  }
  if (sgn_u != sgn_y) y = neg(y);
  return iso3(G, xn, den, y);
}

// ----------------------------------------------------------- cofactor

// h_eff Q = t2 + t - Q - psi(t + Q) + psi^2(2Q), t = [|x|]Q, t2 = [|x|]t
// (ops/tkernel_htc.py cofactor_plain; x < 0 gives the signs).
template <int S>
__device__ __noinline__ Jac<Fp2> clear_cofactor(const Group<S>& G,
                                                const Jac<Fp2>& Q) {
  const Jac<Fp2> t = x_walk(G, Q);
  const Jac<Fp2> t2 = x_walk(G, t);
  const Jac<Fp2> term0 = pt_add(G, pt_add(G, t2, t), pt_neg(Q));
  const Jac<Fp2> term1 = pt_neg(psi(G, pt_add(G, t, Q)));
  const Jac<Fp2> term2 = psi(G, psi(G, pt_double(G, Q)));
  return pt_add(G, pt_add(G, term0, term1), term2);
}

}  // namespace bls
