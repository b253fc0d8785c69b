// Kernels K12, K13, K14: device hash-to-G2, the curve map from hash_to_field
// output to a point of G2.
//
// Replace the Pallas TPU kernels of lighthouse_tpu/ops/tkernel_htc.py:
//   K12 :338 _map_to_g2_kernel (pallas_call at :372), the resident map:
//       SSWU + sqrt_ratio + 3-isogeny on both u-halves, Q0 + Q1 by the
//       complete addition, then the cofactor clear; one launch per batch;
//   K13 :216 _sswu_iso_kernel (:235), SSWU + 3-isogeny, one u per lane;
//   K14 :300 _cofactor_kernel (:323), h_eff Q by two |x| walks and psi.
// Each computes what its plain version in ops/tkernel_htc.py computes,
// limb for limb (map_to_g2_resident_plain, sswu_iso_plain, cofactor_plain).
//
// What bounds them on an H100: a lane is a chain of dependent Fp products
// (K12 ~8,400: two 757-step sqrt_ratio powers, ~2,800 each with the SSWU
// and isogeny glue, and ~2,700 for the cofactor's 126 doublings and 15
// complete additions) against 768 B read and 1,152 B written; a K13 lane
// ~2,800, a K14 lane ~2,700. The batch is small (128 messages on the verify
// path), so the card's multipliers are far from busy: a lane's time is its
// rounds, each one Fp product issued by one warp (issue-bound, not
// latency-bound: chip_smoke.py's product probe) plus the additions that
// every thread of the warp runs.
//
// What the design does about it: one warp per lane, one lane per block of
// one warp, so 128 messages take 128 SMs. The chain's independent Fp
// products run side by side on the warp's threads in rounds (htc.cuh): in
// K12 the two u-halves run on the two half-warps until Q0 + Q1, each Fp2
// product's three Karatsuba products (a square's two) on three (two)
// threads, and a point operation's independent Fp2 products together, so a
// K12 lane is ~1,770 rounds where one thread ran ~8,400 products in a row:
// per u-half 1,122 rounds of the power and ~30 of SSWU, sqrt_ratio's
// candidates and the isogeny; per message ~600 rounds of the cofactor (4 per
// doubling, 6 per addition). Every product is fp.cuh's carry-chain fp_mul.
// The data-dependent conditions are uniform in each group and stay
// branches. No block-wide barrier: a round ends in __syncwarp over its
// group (warp_curve.cuh, whose group law K3 and K7 share). K13 runs a u
// per half-warp (two per block), K14 a point per warp, on the same bodies.

#include <cuda_runtime.h>

#include "htc.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

constexpr int W = 2 * kWords;  // int4 per Fp2 value

__device__ __forceinline__ void store_jac(int4* __restrict__ X,
                                          int4* __restrict__ Y,
                                          int4* __restrict__ Z, long long i,
                                          const Jac<Fp2>& P) {
  store(X + i * W, P.X);
  store(Y + i * W, P.Y);
  store(Z + i * W, P.Z);
}

// This thread's half-warp (threads 0-15, 16-31).
__device__ __forceinline__ int half_index() {
  return threadIdx.x / kHalfThreads;
}

// One message per block: u-half h on half-warp h, then Q0 + Q1 and the
// cofactor on the warp.
__global__ void __launch_bounds__(kWarpThreads)
    map_to_g2_kernel(const int4* __restrict__ us, int4* __restrict__ X,
                     int4* __restrict__ Y, int4* __restrict__ Z) {
  __shared__ uint4 slots[kWarpSlots];
  __shared__ Jac<Fp2> halves[2];
  const long long i = blockIdx.x;
  const int h = half_index();
  Fp2 u;
  load(u, us + (i * 2 + h) * W);
  const Jac<Fp2> Q = sswu_iso(sub_group<kHalfThreads>(slots), u);
  if (threadIdx.x % kHalfThreads == 0) halves[h] = Q;
  __syncwarp();
  const Group<kWarpThreads> G = warp_group(slots);
  const Jac<Fp2> R = clear_cofactor(G, pt_add(G, halves[0], halves[1]));
  if (threadIdx.x == 0) store_jac(X, Y, Z, i, R);
}

// Two u per block, one per half-warp.
__global__ void __launch_bounds__(kWarpThreads)
    sswu_iso_kernel(const int4* __restrict__ u, int4* __restrict__ X,
                    int4* __restrict__ Y, int4* __restrict__ Z, long long n) {
  __shared__ uint4 slots[kWarpSlots];
  const long long i = (long long)blockIdx.x * 2 + half_index();
  if (i >= n) return;  // n odd: the last block's second half-warp has no u
  Fp2 a;
  load(a, u + i * W);
  const Jac<Fp2> P = sswu_iso(sub_group<kHalfThreads>(slots), a);
  if (threadIdx.x % kHalfThreads == 0) store_jac(X, Y, Z, i, P);
}

// One point per block.
__global__ void __launch_bounds__(kWarpThreads)
    cofactor_kernel(const int4* __restrict__ X, const int4* __restrict__ Y,
                    const int4* __restrict__ Z, int4* __restrict__ oX,
                    int4* __restrict__ oY, int4* __restrict__ oZ) {
  __shared__ uint4 slots[kWarpSlots];
  const long long i = blockIdx.x;
  Jac<Fp2> P;
  load(P.X, X + i * W);
  load(P.Y, Y + i * W);
  load(P.Z, Z + i * W);
  const Jac<Fp2> R = clear_cofactor(warp_group(slots), P);
  if (threadIdx.x == 0) store_jac(oX, oY, oZ, i, R);
}

}  // namespace

// us: n x 2 x 2 x 48 int32 (message, u-half, coefficient, limb); X, Y, Z:
// n x 2 x 48 int32 each. Each entry point returns cudaGetLastError().
extern "C" int lh_map_to_g2(const void* us, void* X, void* Y, void* Z,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  map_to_g2_kernel<<<(unsigned int)n, kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)us, (int4*)X, (int4*)Y, (int4*)Z);
  return (int)cudaGetLastError();
}

// u: n x 2 x 48 int32.
extern "C" int lh_sswu_iso(const void* u, void* X, void* Y, void* Z,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  sswu_iso_kernel<<<(unsigned int)((n + 1) / 2), kWarpThreads, 0,
                    (cudaStream_t)stream>>>((const int4*)u, (int4*)X, (int4*)Y,
                                            (int4*)Z, n);
  return (int)cudaGetLastError();
}

// X, Y, Z in and oX, oY, oZ out: n x 2 x 48 int32 each.
extern "C" int lh_cofactor(const void* X, const void* Y, const void* Z,
                           void* oX, void* oY, void* oZ, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  cofactor_kernel<<<(unsigned int)n, kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)X, (const int4*)Y, (const int4*)Z, (int4*)oX, (int4*)oY,
      (int4*)oZ);
  return (int)cudaGetLastError();
}
