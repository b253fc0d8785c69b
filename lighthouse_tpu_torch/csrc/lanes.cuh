// The three launch shapes of the kernels.
//
// One thread per lane (most kernels): a lane (one point, one pair, one
// Fp12 value) runs its whole chain in one thread. Blocks are small (32
// threads) so that the 128-129 lanes of a verify spread over several SMs;
// the last block is ragged and its extra threads return at once.
//
// One block per lane (K8, K10; coop.cuh): a lane's independent Fp
// operations run side by side on kCoopThreads threads, 64 so that the
// widest round of a program (an Fp12 product's 54 Fp products, f^2 beside
// the doubling step's first level, 45) takes one pass.
//
// Warp groups (K3, K7, K12-K14; warp_curve.cuh, htc.cuh): blocks of one
// warp, a lane's independent Fp products side by side on a group of the
// warp's threads that meets at __syncwarp. K7, K12 and K14 run one lane per
// warp (K12's two u-halves on the two half-warps, then the whole warp), K13
// a lane per half-warp, K3 one lane per warp up to one lane per SM and
// past that 8 (G1) or 4 (G2) lanes per warp.
//
// Every entry point of the fused kernels is extern "C" and takes its
// pointers first, then its int options, the lane count and the stream, and
// returns cudaGetLastError() (ops/tkernel_calls.py _launch calls them so).

#pragma once

#include <cuda_runtime.h>

namespace bls {

constexpr int kLaneThreads = 32;

inline unsigned int lane_blocks(long long n) {
  return (unsigned int)((n + kLaneThreads - 1) / kLaneThreads);
}

constexpr int kCoopThreads = 64;  // ops/coop.py THREADS

constexpr int kWarpThreads = 32;

__device__ __forceinline__ long long lane_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

#ifdef __CUDACC__
// The current device's SM count into *sms, read once per device (K3's and
// K4's shapes follow it); returns a CUDA error code. A host build of the
// kernels (the tests' harnesses) gives its own.
inline int sm_count(int* sms) {
  static int sms_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = sms_of[dev];
  return 0;
}
#endif

}  // namespace bls
