// Kernels K5, K6 and K7: the bucketed multi-scalar multiplication
// sum_i r_i S_i of the fused verify's signature accumulator.
//
// Replaces the Pallas TPU kernels of lighthouse_tpu/ops/msm.py: the
// accumulation kernel of _accum_t (:153, pallas_call at :174), the bucket
// tree _tree_kernel (:185) and the Horner pass _horner_kernel (:213), both
// through _f3_call (pallas_call at :269). Each computes what its plain
// version in ops/msm.py computes, on the same 256-lane layout (bucket lane
// = (digit - 1) * 16 + window, lanes 240-255 padding), with the group law of
// curve.cuh (K5, K6) or warp_curve.cuh (K7), which follow ops/points.py
// case for case; the raw limbs equal the plain versions'.
//
// What bounds them on an H100: integer multiplies in dependent chains. At
// S = 128 sets K5 runs L = 48 rounds, of which a bucket holds ~8 points on
// average, so ~7 mixed additions of 31 Fp products each per lane; K6 eight
// complete additions per lane (43 Fp products each while both sides are
// finite); K7 60 doublings and 15 additions on one lane (~1,600 Fp
// products). The bytes (the signatures gathered, the [L, 240] schedule, 256
// Jacobian points in and out) are tens of kilobytes.
//
// What the design does about it: K5 and K6 run one thread per bucket lane.
// K5 gathers its points from the int32 schedule itself (no [L, 240] copy of
// the points); K6 is one block of 256 threads that trade their lanes
// through 72 KiB of shared memory between the eight shift-add steps. K7,
// the one lane-0 chain the reference reads, runs on one warp with
// warp_curve.cuh's group law: a doubling's products in 4 rounds, an
// addition's in 6, each round's independent Fp2 products one per thread,
// meeting at __syncwarp; 330 rounds where one thread ran ~1,600 products in
// a row. The windows keep the plain version's Horner order (its 60
// doublings stay on the chain either way, and the limbs stay its limbs).

#include "warp_curve.cuh"

namespace {

using namespace bls;

constexpr int kBuckets = 240;  // 16 windows x 15 nonzero digits
constexpr int kLanes = 256;    // the bucket axis padded to a power of two
constexpr int kWindows = 16;
constexpr int kWindowBits = 4;
constexpr int W = 2 * kWords;  // int4 per Fp2 value

__device__ __forceinline__ Jac<Fp2> load_point(const int4* X, const int4* Y,
                                               const int4* Z, int lane) {
  Jac<Fp2> P;
  load(P.X, X + lane * W);
  load(P.Y, Y + lane * W);
  load(P.Z, Z + lane * W);
  return P;
}

__device__ __forceinline__ void store_point(int4* X, int4* Y, int4* Z,
                                            int lane, const Jac<Fp2>& P) {
  store(X + lane * W, P.X);
  store(Y + lane * W, P.Y);
  store(Z + lane * W, P.Z);
}

// K5: lane b starts at infinity (one, one, zero) and, for each of the L
// rounds, adds the affine point (sx, sy)[idx[r, b]] unless valid[r, b] is
// false (pt_add_mixed with q_inf = !valid: an accumulator at infinity then
// takes the gathered x, y with Z = 0, as the plain version's select does).
// The pad lanes add the all-zero point, never valid.
__global__ void __launch_bounds__(kLaneThreads)
    msm_accum_kernel(const int4* __restrict__ sx, const int4* __restrict__ sy,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid,
                     int4* __restrict__ oX, int4* __restrict__ oY,
                     int4* __restrict__ oZ, int L, int S, long long n) {
  const long long b = lane_index();
  if (b >= n) return;
  Jac<Fp2> acc = {one(Fp2()), one(Fp2()), zero(Fp2())};
  const Fp2 z = zero(Fp2());
#pragma unroll 1
  for (int r = 0; r < L; ++r) {
    if (b >= kBuckets) {
      acc = pt_add_mixed(acc, z, z, true);
      continue;
    }
    const int j = idx[(long long)r * kBuckets + b];
    if (j < 0 || j >= S) __trap();  // the plain version's IndexError
    Fp2 x, y;
    load(x, sx + (long long)j * W);
    load(y, sy + (long long)j * W);
    acc = pt_add_mixed(acc, x, y, valid[(long long)r * kBuckets + b] == 0);
  }
  store_point(oX, oY, oZ, (int)b, acc);
}

// K6: two passes of P = pt_add(P, shift_down(P, sh)) for sh = 16, 32, 64,
// 128; lane i reads lane i + sh of the previous step from shared memory,
// and the lanes shifted in from beyond 255 are all-zero limbs.
__global__ void __launch_bounds__(kLanes, 1)
    msm_tree_kernel(const int4* __restrict__ bX, const int4* __restrict__ bY,
                    const int4* __restrict__ bZ, int4* __restrict__ oX,
                    int4* __restrict__ oY, int4* __restrict__ oZ) {
  extern __shared__ int4 smem[];
  Jac<Fp2>* lanes = reinterpret_cast<Jac<Fp2>*>(smem);
  const int i = threadIdx.x;
  Jac<Fp2> P = load_point(bX, bY, bZ, i);
  lanes[i] = P;
  __syncthreads();
  const Fp2 z = zero(Fp2());
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int sh = kWindows; sh < kLanes; sh <<= 1) {
      const Jac<Fp2> Q = i + sh < kLanes ? lanes[i + sh] : Jac<Fp2>{z, z, z};
      P = pt_add(P, Q);
      __syncthreads();  // every lane has read the previous step
      lanes[i] = P;
      __syncthreads();
    }
  }
  store_point(oX, oY, oZ, i, P);
}

// K7: acc = T[15]; for w = 14 .. 0: four doublings, then acc + T[w] (the
// reference's rotations put T[w] in lane 0 at window w). One block of one
// warp: the warp group law of warp_curve.cuh.
__global__ void __launch_bounds__(kWarpThreads)
    msm_horner_kernel(const int4* __restrict__ tX, const int4* __restrict__ tY,
                      const int4* __restrict__ tZ, int4* __restrict__ oX,
                      int4* __restrict__ oY, int4* __restrict__ oZ) {
  __shared__ uint4 slots[kWarpSlots];
  const Group<kWarpThreads> G = warp_group(slots);
  Jac<Fp2> acc = load_point(tX, tY, tZ, kWindows - 1);
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < kWindowBits; ++k) acc = pt_double(G, acc);
    acc = pt_add(G, acc, load_point(tX, tY, tZ, w));
  }
  if (threadIdx.x == 0) store_point(oX, oY, oZ, 0, acc);
}

constexpr int kTreeSmem = kLanes * (int)sizeof(Jac<Fp2>);  // 72 KiB

}  // namespace

// sx, sy: S x 2 x 48 int32; idx: L x 240 int32; valid: L x 240 bytes;
// oX, oY, oZ: 256 x 2 x 48 int32; n must be 256.
// Returns cudaGetLastError() (0 on success).
extern "C" int lh_msm_accum(const void* sx, const void* sy, const void* idx,
                            const void* valid, void* oX, void* oY, void* oZ,
                            int L, int S, long long n, void* stream) {
  if (n != kLanes) return (int)cudaErrorInvalidValue;
  msm_accum_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)sx, (const int4*)sy, (const int32_t*)idx,
      (const uint8_t*)valid, (int4*)oX, (int4*)oY, (int4*)oZ, L, S, n);
  return (int)cudaGetLastError();
}

// bX, bY, bZ, oX, oY, oZ: 256 x 2 x 48 int32; n must be 256.
extern "C" int lh_msm_tree(const void* bX, const void* bY, const void* bZ,
                           void* oX, void* oY, void* oZ, long long n,
                           void* stream) {
  if (n != kLanes) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      msm_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTreeSmem);
  if (err != cudaSuccess) return (int)err;
  msm_tree_kernel<<<1, kLanes, kTreeSmem, (cudaStream_t)stream>>>(
      (const int4*)bX, (const int4*)bY, (const int4*)bZ, (int4*)oX,
      (int4*)oY, (int4*)oZ);
  return (int)cudaGetLastError();
}

// tX, tY, tZ: 256 x 2 x 48 int32 (lanes 0-15 read); oX, oY, oZ: one lane,
// 2 x 48 int32 each; n must be 256.
extern "C" int lh_msm_horner(const void* tX, const void* tY, const void* tZ,
                             void* oX, void* oY, void* oZ, long long n,
                             void* stream) {
  if (n != kLanes) return (int)cudaErrorInvalidValue;
  msm_horner_kernel<<<1, kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)tX, (const int4*)tY, (const int4*)tZ, (int4*)oX, (int4*)oY,
      (int4*)oZ);
  return (int)cudaGetLastError();
}
