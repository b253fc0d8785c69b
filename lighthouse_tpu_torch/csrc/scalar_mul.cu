// Kernel K3: per-lane scalar multiplication [k]Q over an affine base.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:77
// _scalar_mul_kernel (pallas_call at :118), in its G1 and G2 forms: the RLC
// blinding [r_i] agg_pk_i and [r_i] sig_i of a verify. Computes what
// ops/points.py pt_scalar_mul_bits computes: left-to-right double-and-add
// over the lane's bits (most significant first) from Jacobian infinity
// (1, 1, 0), each step a doubling and, on a one bit, the mixed addition.
// The output is Jacobian, limb for limb the plain version's.
//
// What bounds it on an H100: integer multiplies. A lane runs 64 doublings
// and ~31 mixed additions, a dependent chain of ~820 Fp products for G1
// (~2,000 for G2), against 641 B / 1,025 B read and 576 B / 1,152 B
// written.
//
// What the design does about it: one thread per lane, the chain in
// registers and local memory; the addition runs only on the lane's one bits
// (the plain version computes it on every bit and selects). At 128 lanes
// the kernel fills 4 of 132 SMs with one warp each; spreading a lane over a
// warp is later work.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

template <class F>
__global__ void __launch_bounds__(kLaneThreads)
    scalar_mul_kernel(const int4* __restrict__ qx, const int4* __restrict__ qy,
                      const uint8_t* __restrict__ q_inf,
                      const int32_t* __restrict__ bits,
                      int4* __restrict__ oX, int4* __restrict__ oY,
                      int4* __restrict__ oZ, int nbits, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  constexpr int W = sizeof(F) / sizeof(Fp) * kWords;
  F x, y;
  load(x, qx + i * W);
  load(y, qy + i * W);
  const bool inf = q_inf[i] != 0;
  const int32_t* b = bits + i * nbits;
  Jac<F> acc = {one(F()), one(F()), zero(F())};
#pragma unroll 1
  for (int k = 0; k < nbits; ++k) {
    acc = pt_double(acc);
    if (b[k] == 1) acc = pt_add_mixed(acc, x, y, inf);
  }
  store(oX + i * W, acc.X);
  store(oY + i * W, acc.Y);
  store(oZ + i * W, acc.Z);
}

template <class F>
int launch(const void* qx, const void* qy, const void* q_inf, const void* bits,
           void* oX, void* oY, void* oZ, int nbits, long long n,
           void* stream) {
  if (n <= 0) return 0;
  scalar_mul_kernel<F><<<lane_blocks(n), kLaneThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int4*)qx, (const int4*)qy, (const uint8_t*)q_inf,
      (const int32_t*)bits, (int4*)oX, (int4*)oY, (int4*)oZ, nbits, n);
  return (int)cudaGetLastError();
}

}  // namespace

// qx, qy: n x (2 x) 48 int32; q_inf: n bytes; bits: n x nbits int32 (MSB
// first); oX, oY, oZ: n x (2 x) 48 int32. Returns cudaGetLastError().
extern "C" int lh_scalar_mul_g1(const void* qx, const void* qy,
                                const void* q_inf, const void* bits, void* oX,
                                void* oY, void* oZ, int nbits, long long n,
                                void* stream) {
  return launch<Fp>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream);
}

extern "C" int lh_scalar_mul_g2(const void* qx, const void* qy,
                                const void* q_inf, const void* bits, void* oX,
                                void* oY, void* oZ, int nbits, long long n,
                                void* stream) {
  return launch<Fp2>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream);
}
