// Kernel K15: G2 subgroup membership by the full order, [r]Q == infinity.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:141
// _subgroup_kernel (pallas_call at :173). Computes what ops/points.py
// pt_subgroup_check computes on pt_from_affine(x, y, inf): [r]Q on the
// static bits of the curve order r (the leading bit initialises the
// accumulator with Q, then a doubling per bit and a complete addition of Q
// on each one bit), true where the result is at infinity. A lane at
// infinity passes. The JAX package calls it from its kernel benchmark and
// its tests only; the verify path uses the psi criterion (K4), which this
// kernel checks on the card.
//
// What bounds it on an H100: integer multiplies. A lane is a dependent
// chain of 254 doublings and 133 complete additions, ~9,800 Fp products,
// against 769 B read and one byte written.
//
// What the design does about it: one thread per lane, the chain in
// registers and local memory, infinity lanes return at once.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

// The curve order r, little-endian 32-bit words; its top set bit is 254.
__device__ __constant__ const uint32_t kOrder[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr int kOrderTopBit = 254;

__device__ __forceinline__ bool order_bit(int i) {
  return (kOrder[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(kLaneThreads)
    subgroup_kernel(const int4* __restrict__ qx, const int4* __restrict__ qy,
                    const uint8_t* __restrict__ q_inf,
                    uint8_t* __restrict__ out, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  if (q_inf[i]) {
    out[i] = 1;
    return;
  }
  constexpr int W = 2 * kWords;
  Fp2 x, y;
  load(x, qx + i * W);
  load(y, qy + i * W);
  const Jac<Fp2> Q = pt_from_affine(x, y, false);
  Jac<Fp2> acc = Q;
#pragma unroll 1
  for (int b = kOrderTopBit - 1; b >= 0; --b) {
    acc = pt_double(acc);
    if (order_bit(b)) acc = pt_add(acc, Q);
  }
  out[i] = is_zero(acc.Z) ? 1 : 0;
}

}  // namespace

// qx, qy: n x 2 x 48 int32; q_inf, out: n bytes (torch.bool).
// Returns cudaGetLastError() (0 on success).
extern "C" int lh_subgroup_full(const void* qx, const void* qy,
                                const void* q_inf, void* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  subgroup_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)qx, (const int4*)qy, (const uint8_t*)q_inf, (uint8_t*)out,
      n);
  return (int)cudaGetLastError();
}
