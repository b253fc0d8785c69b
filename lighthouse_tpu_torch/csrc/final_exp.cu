// Kernels K9, K10, K11: the final exponentiation f^(3(p^12-1)/r), as the
// three entry points of the 9-launch chain of ops/tkernel_calls.py
// final_exp_kernel (easy part, 5 x-powers, 3 combinations).
//
// Replace the Pallas TPU kernels of lighthouse_tpu/ops/tkernel_calls.py,
// all launched through the pallas_call at :437:
//   K9  :390 _easy_exp_kernel   f^((p^6-1)(p^2+1))
//   K10 :398 _pow_kernel(xm1)   the cyclotomic f^x on |x|'s bit layout,
//                               times conj(f) when xm1 (f^(x-1))
//   K11 :410 _comb_kernel(mode) b: u frob(v); c: u frob2(v) conj(v);
//                               final: u v^2 v
// Each computes what its plain version in ops/tkernel_calls.py computes,
// limb for limb; chained, they equal ops/pairing.py final_exponentiation.
//
// What bounds them on an H100: integer multiplies. A K10 lane is 63 Fp12
// squarings and 5 products in a dependent chain (~2,540 Fp products), K9
// ~870 including an Fp inversion, a K11 lane 75-150; each reads one or two
// 2,304 B Fp12 values and writes one.
//
// What the design does about it: one thread per lane, the Fp12 values in
// registers and local memory. A verify runs the chain on ONE lane, so the
// kernels run one thread on one SM of 132: the chain's latency is the cost.
// Spreading an Fp12 product over a warp is later work.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

constexpr int W12 = 12 * kWords;  // int4 per Fp12 value

// f^x for f in the cyclotomic subgroup (ops/pairing.py _cyc_pow_x):
// f^|x| by square-and-multiply over |x|'s bits below the leading one,
// then conj because x < 0.
__device__ __noinline__ Fp12 cyc_pow_x(const Fp12& f) {
  Fp12 acc = f;
#pragma unroll 1
  for (int b = kXTopBit - 1; b >= 0; --b) {
    acc = sqr(acc);
    if (x_bit(b)) acc = mul(acc, f);
  }
  return conj(acc);
}

__global__ void __launch_bounds__(kLaneThreads)
    easy_exp_kernel(const int4* __restrict__ f, int4* __restrict__ out,
                    long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 a;
  load(a, f + i * W12);
  const Fp12 g = mul(conj(a), inv(a));  // f^(p^6 - 1)
  store(out + i * W12, mul(frobenius2(g), g));
}

__global__ void __launch_bounds__(kLaneThreads)
    pow_x_kernel(const int4* __restrict__ f, int4* __restrict__ out, int xm1,
                 long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 a;
  load(a, f + i * W12);
  Fp12 p = cyc_pow_x(a);
  if (xm1) p = mul(p, conj(a));
  store(out + i * W12, p);
}

__global__ void __launch_bounds__(kLaneThreads)
    comb_kernel(const int4* __restrict__ u, const int4* __restrict__ v,
                int4* __restrict__ out, int mode, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 a, b;
  load(a, u + i * W12);
  load(b, v + i * W12);
  Fp12 r;
  if (mode == 0) {
    r = mul(a, frobenius(b));
  } else if (mode == 1) {
    r = mul(mul(a, frobenius2(b)), conj(b));
  } else {
    r = mul(mul(a, sqr(b)), b);
  }
  store(out + i * W12, r);
}

}  // namespace

// f, u, v, out: n x 2 x 3 x 2 x 48 int32. Each returns cudaGetLastError().
extern "C" int lh_easy_exp(const void* f, void* out, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  easy_exp_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)f, (int4*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int lh_pow_x(const void* f, void* out, int xm1, long long n,
                        void* stream) {
  if (n <= 0) return 0;
  pow_x_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)f, (int4*)out, xm1, n);
  return (int)cudaGetLastError();
}

// mode: 0 = b, 1 = c, 2 = final.
extern "C" int lh_comb(const void* u, const void* v, void* out, int mode,
                       long long n, void* stream) {
  if (n <= 0) return 0;
  comb_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)u, (const int4*)v, (int4*)out, mode, n);
  return (int)cudaGetLastError();
}
