// Kernel K2: Jacobian -> canonical affine plus an infinity flag, per lane.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:267
// _to_affine_kernel (pallas_call at :298), in its G1 and G2 forms. Computes
// what ops/points.py pt_to_affine computes: zi = Z^-1 (0 -> 0),
// x = canonical(X zi^2), y = canonical(Y zi^3), inf = (Z == 0); infinity
// lanes come out as (0, 0, true). The G2 form inverts the Fp2 norm
// (c0^2 + c1^2) and multiplies by the conjugate, as tower.cuh does.
//
// Why not Fermat: the TPU kernel (and ops/field.py mont_inv) inverts by
// Z^(p-2), ~608 dependent Fp products, because a TPU has no wide integer
// ops and no per-lane branches. On an H100 each of those products is ~1,870
// issue cycles in its warp, so the chain alone took ~0.6 ms. Hopper has
// native 32-bit integer ops, so here zi comes from fp.cuh fp_inv_gcd:
// Bernstein-Yang divsteps, a fixed 1,110 of them (the proven bound for 381
// bits is 1,101), in batches of 30 on 32-bit words, then one Fp product
// back to Montgomery form. The count is the same in every lane, so the
// lanes of a warp never diverge. zi may be another representative in
// [0, 2p) than Fermat's, but x and y are canonical, so the outputs equal
// pt_to_affine limb for limb.
//
// What bounds it on an H100: 32-bit integer operations, ~58,000 per lane
// for the inversion (counted in chip_smoke.py) and 5 Fp products (G1) or 9
// (G2), against 576 B (G1) or 1,152 B (G2) read and 385 B / 769 B written
// per lane. One thread runs one lane; the verify's 128 lanes are 4 warps,
// so the kernel runs at the latency of one lane's chain.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

__device__ __noinline__ Fp inv_gcd(const Fp& a) {
  Fp r;
  fp::fp_inv_gcd(r.w, a.w);
  return r;
}

// (c0 - c1 u) / (c0^2 + c1^2); 0 -> 0  (tower.cuh inv on the GCD inverse)
__device__ __noinline__ Fp2 inv_gcd(const Fp2& a) {
  const Fp ni = inv_gcd(add(mul(a.c0, a.c0), mul(a.c1, a.c1)));
  return {mul(a.c0, ni), mul(neg(a.c1), ni)};
}

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
    to_affine_kernel(const int4* __restrict__ X, const int4* __restrict__ Y,
                     const int4* __restrict__ Z, int4* __restrict__ ox,
                     int4* __restrict__ oy, uint8_t* __restrict__ inf,
                     long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  constexpr int W = sizeof(F) / sizeof(Fp) * kWords;  // int4 per value
  F x, y, z;
  load(x, X + i * W);
  load(y, Y + i * W);
  load(z, Z + i * W);
  const F zi = inv_gcd(z);
  const F zi2 = sqr(zi);
  store(ox + i * W, canonical(mul(x, zi2)));
  store(oy + i * W, canonical(mul(y, mul(zi, zi2))));
  inf[i] = is_zero(z) ? 1 : 0;
}

template <class F>
int launch(const void* X, const void* Y, const void* Z, void* ox, void* oy,
           void* inf, long long n, void* stream) {
  if (n <= 0) return 0;
  to_affine_kernel<F><<<lane_blocks(n), kLaneThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int4*)X, (const int4*)Y, (const int4*)Z, (int4*)ox, (int4*)oy,
      (uint8_t*)inf, n);
  return (int)cudaGetLastError();
}

}  // namespace

// X, Y, Z: n x (2 x) 48 int32 each; ox, oy: the same shape; inf: n bytes
// (torch.bool). Returns cudaGetLastError() (0 on success).
extern "C" int lh_to_affine_g1(const void* X, const void* Y, const void* Z,
                               void* ox, void* oy, void* inf, long long n,
                               void* stream) {
  return launch<Fp>(X, Y, Z, ox, oy, inf, n, stream);
}

extern "C" int lh_to_affine_g2(const void* X, const void* Y, const void* Z,
                               void* ox, void* oy, void* inf, long long n,
                               void* stream) {
  return launch<Fp2>(X, Y, Z, ox, oy, inf, n, stream);
}
