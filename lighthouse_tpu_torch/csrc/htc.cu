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
// What bounds them on an H100: integer multiplies. A K12 lane is a
// dependent chain of ~8,400 Fp products (two 757-step sqrt_ratio powers,
// ~2,800 each with the SSWU and isogeny glue, and ~2,700 for the cofactor's
// 126 doublings and 15 complete additions) against 768 B read and 1,152 B
// written; a K13 lane ~2,800, a K14 lane ~2,700.
//
// What the design does about it: one thread per lane (one message for K12,
// one u for K13, one point for K14), the chain in registers and local
// memory; the 758-bit exponent is a loop over a __constant__ table, and
// every Fp2 product and point operation is one out-of-line copy, which
// keeps the build to seconds. At the verify path's 128 messages K12 fills 4
// of the 132 SMs with one warp each: the chain's latency is the cost.

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

__global__ void __launch_bounds__(kLaneThreads)
    map_to_g2_kernel(const int4* __restrict__ us, int4* __restrict__ X,
                     int4* __restrict__ Y, int4* __restrict__ Z,
                     long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp2 u0, u1;
  load(u0, us + i * 2 * W);
  load(u1, us + i * 2 * W + W);
  store_jac(X, Y, Z, i, clear_cofactor(pt_add(sswu_iso(u0), sswu_iso(u1))));
}

__global__ void __launch_bounds__(kLaneThreads)
    sswu_iso_kernel(const int4* __restrict__ u, int4* __restrict__ X,
                    int4* __restrict__ Y, int4* __restrict__ Z, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp2 a;
  load(a, u + i * W);
  store_jac(X, Y, Z, i, sswu_iso(a));
}

__global__ void __launch_bounds__(kLaneThreads)
    cofactor_kernel(const int4* __restrict__ X, const int4* __restrict__ Y,
                    const int4* __restrict__ Z, int4* __restrict__ oX,
                    int4* __restrict__ oY, int4* __restrict__ oZ,
                    long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Jac<Fp2> P;
  load(P.X, X + i * W);
  load(P.Y, Y + i * W);
  load(P.Z, Z + i * W);
  store_jac(oX, oY, oZ, i, clear_cofactor(P));
}

}  // namespace

// us: n x 2 x 2 x 48 int32 (message, u-half, coefficient, limb); X, Y, Z:
// n x 2 x 48 int32 each. Each entry point returns cudaGetLastError().
extern "C" int lh_map_to_g2(const void* us, void* X, void* Y, void* Z,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  map_to_g2_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)us, (int4*)X, (int4*)Y, (int4*)Z, n);
  return (int)cudaGetLastError();
}

// u: n x 2 x 48 int32.
extern "C" int lh_sswu_iso(const void* u, void* X, void* Y, void* Z,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  sswu_iso_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)u, (int4*)X, (int4*)Y, (int4*)Z, n);
  return (int)cudaGetLastError();
}

// X, Y, Z in and oX, oY, oZ out: n x 2 x 48 int32 each.
extern "C" int lh_cofactor(const void* X, const void* Y, const void* Z,
                           void* oX, void* oY, void* oZ, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  cofactor_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)X, (const int4*)Y, (const int4*)Z, (int4*)oX, (int4*)oY,
      (int4*)oZ, n);
  return (int)cudaGetLastError();
}
