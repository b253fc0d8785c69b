// One thread per lane: the launch shape every fused kernel shares.
//
// A lane (one point, one pair, one Fp12 value) runs its whole chain in one
// thread. Blocks are small (32 threads) so that the 128-129 lanes of a
// verify spread over several SMs; the last block is ragged and its extra
// threads return at once.
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

__device__ __forceinline__ long long lane_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

}  // namespace bls
