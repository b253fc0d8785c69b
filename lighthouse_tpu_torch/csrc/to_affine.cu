// Kernel K2: Jacobian -> canonical affine plus an infinity flag, per lane.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:267
// _to_affine_kernel (pallas_call at :298), in its G1 and G2 forms. Computes
// what ops/points.py pt_to_affine computes: zi = Z^(p-2) by Fermat,
// x = canonical(X zi^2), y = canonical(Y zi^3), inf = (Z == 0); infinity
// lanes come out as (0, 0, true) because 0^(p-2) = 0.
//
// What bounds it on an H100: integer multiplies. A lane is a dependent
// chain of ~610 Fp products (608 for the inversion's squarings and
// multiplies), ~600 32-bit multiply-adds each, against 576 B (G1) or
// 1,152 B (G2) read and 385 B / 769 B written.
//
// What the design does about it: one thread per lane, the whole chain in
// registers and local memory, no device-memory traffic beyond the operands.
// At the verify path's 128 lanes that fills 4 of the 132 SMs with one warp
// each, so the kernel runs at the latency of one thread's chain; a warp per
// lane with limb-parallel products is later work.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

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
  const F zi = inv(z);
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
