// Kernel K4: G2 subgroup membership by the psi criterion, psi(Q) == [x]Q.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:191
// _subgroup_fast_kernel (pallas_call at :246). Computes what ops/points.py
// subgroup_check_g2_fast computes: [|x|]Q on |x|'s static bit layout (the
// leading bit initialises the accumulator with Q, then 63 doublings with
// the 5 mixed additions at their positions), negated because x < 0; then
// psi(Q) = (conj(x) PSI_CX, conj(y) PSI_CY) compared with the Jacobian
// result without an inversion (px Z^2 == X, py Z^3 == Y), which must be
// finite. A lane at infinity passes.
//
// What bounds it on an H100: integer multiplies. A lane is a dependent
// chain of ~1,180 Fp products (63 doublings, 5 mixed additions, the psi
// map and the comparison) against 769 B read and one byte written.
//
// What the design does about it: one thread per lane, the chain in
// registers and local memory, infinity lanes return at once. At 128 lanes
// it fills 4 of 132 SMs with one warp each; a warp per lane is later work.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

__global__ void __launch_bounds__(kLaneThreads)
    subgroup_fast_kernel(const int4* __restrict__ qx,
                         const int4* __restrict__ qy,
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
  Jac<Fp2> acc = pt_from_affine(x, y, false);
#pragma unroll 1
  for (int b = kXTopBit - 1; b >= 0; --b) {
    acc = pt_double(acc);
    if (x_bit(b)) acc = pt_add_mixed(acc, x, y, false);
  }
  const Fp2 yj = neg(acc.Y);  // [x]Q = -[|x|]Q
  const Fp2 px = mul(conj(x), fp2_const(kPsiCx));
  const Fp2 py = mul(conj(y), fp2_const(kPsiCy));
  const Fp2 z2 = sqr(acc.Z);
  const Fp2 z3 = mul(z2, acc.Z);
  const bool ok =
      eq(mul(px, z2), acc.X) && eq(mul(py, z3), yj) && !is_zero(acc.Z);
  out[i] = ok ? 1 : 0;
}

}  // namespace

// qx, qy: n x 2 x 48 int32; q_inf, out: n bytes (torch.bool).
// Returns cudaGetLastError() (0 on success).
extern "C" int lh_subgroup_fast(const void* qx, const void* qy,
                                const void* q_inf, void* out, long long n,
                                void* stream) {
  if (n <= 0) return 0;
  subgroup_fast_kernel<<<lane_blocks(n), kLaneThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int4*)qx, (const int4*)qy, (const uint8_t*)q_inf,
      (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
