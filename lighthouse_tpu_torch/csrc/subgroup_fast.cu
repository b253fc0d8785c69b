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
// map and the comparison) against 769 B read and one byte written. A
// verify launches it on S lanes.
//
// What the design does about it: a lane runs on a group of a warp's threads
// with warp_curve.cuh's group law, as K3 does: a doubling's products in 4
// rounds, a mixed addition's in 6, psi and the comparison in 3 more, each
// round's independent products one per thread of the group, meeting at
// __syncwarp over the group; 285 rounds where one thread ran 1,180
// products in a row. |x|'s bits are the same for every lane, so the groups
// of a warp never disagree on them; a lane at infinity leaves at once,
// its whole group together, before its first round. The shape follows the
// lane count (lanes_per_warp), at the crossovers chip_smoke.py's K4 sweep
// measured on an H100 (PERF.md):
// - up to kOneWarpLanesPerSm lanes per SM, the whole warp runs one lane (a
//   block of one warp per lane): each of an SM's four schedulers has at
//   most one such warp, and the chain is the time;
// - past that, 4 lanes per warp on groups of 8 threads, the widest round
//   (the mixed addition's 4 Fp2 squares) in one pass: a packed warp issues
//   about what a one-lane warp issues per round, so packing divides the
//   warps that share an SM's issue;
// - past kPackedWarpsPerSm packed warps per SM, one thread per lane (the
//   chain in registers and local memory, 32 lanes per block of one warp):
//   slower per lane (1,180 products in a row), but its products' issue
//   carries no group's replicated Fp2 additions, so it holds its time up
//   to one warp per SM while the packed warps queue for issue.

#include "warp_curve.cuh"

namespace {

using namespace bls;

constexpr int W = 2 * kWords;  // int4 per Fp2 value

// Lanes per warp of the three shapes.
constexpr int kOneWarp = 1;
constexpr int kPacked = 4;
constexpr int kOneThread = kWarpThreads;

// Lanes per SM up to which a warp runs one lane, and packed warps per SM
// up to which 4 lanes share a warp; one thread per lane past that.
constexpr int kOneWarpLanesPerSm = 3;
constexpr int kPackedWarpsPerSm = 12;

// psi(Q) == -[|x|]Q = [x]Q for the affine Q = (x, y), given acc = [|x|]Q:
// px Z^2 == X and py Z^3 == -Y with Z finite, its products in 3 rounds.
template <int S>
__device__ __forceinline__ bool psi_is_x_multiple(const Group<S>& G,
                                                  const Jac<Fp2>& acc,
                                                  const Fp2& x, const Fp2& y) {
  Fp2 px, py, z2;
  {
    Round<S> r(G);
    const MulSlot hx = r.mul(conj(x), fp2_const(kPsiCx));
    const MulSlot hy = r.mul(conj(y), fp2_const(kPsiCy));
    const SqrSlot hz = r.sqr(acc.Z);
    r.run();
    px = r.get(hx);
    py = r.get(hy);
    z2 = r.get(hz);
  }
  Fp2 z3, pxz2;
  {
    Round<S> r(G);
    const MulSlot h1 = r.mul(z2, acc.Z), h2 = r.mul(px, z2);
    r.run();
    z3 = r.get(h1);
    pxz2 = r.get(h2);
  }
  const Fp2 pyz3 = mul(G, py, z3);
  return eq(pxz2, acc.X) && eq(pyz3, neg(acc.Y)) && !is_zero(acc.Z);
}

// A lane on a group of kThreadsPerLane threads (32: one lane per block of
// one warp; 8: four).
template <int kThreadsPerLane>
__global__ void __launch_bounds__(kWarpThreads)
    subgroup_fast_warp_kernel(const int4* __restrict__ qx,
                              const int4* __restrict__ qy,
                              const uint8_t* __restrict__ q_inf,
                              uint8_t* __restrict__ out, long long n) {
  __shared__ uint4 slots[kWarpSlots];
  const Group<kThreadsPerLane> G = sub_group<kThreadsPerLane>(slots);
  const long long i = (long long)blockIdx.x * (kWarpThreads / kThreadsPerLane) +
                      threadIdx.x / kThreadsPerLane;
  if (i >= n) return;  // the ragged last warp's idle groups, whole
  if (q_inf[i]) {      // the whole group, before its first round
    if (G.g == 0) out[i] = 1;
    return;
  }
  Fp2 x, y;
  load(x, qx + i * W);
  load(y, qy + i * W);
  Jac<Fp2> acc = pt_from_affine(x, y, false);
#pragma unroll 1
  for (int b = kXTopBit - 1; b >= 0; --b) {
    acc = pt_double(G, acc);
    if (x_bit(b)) acc = pt_add_mixed(G, acc, x, y, false);
  }
  const bool ok = psi_is_x_multiple(G, acc, x, y);
  if (G.g == 0) out[i] = ok ? 1 : 0;
}

// A lane per thread, the chain on curve.cuh's one-thread group law.
__global__ void __launch_bounds__(kLaneThreads)
    subgroup_fast_thread_kernel(const int4* __restrict__ qx,
                                const int4* __restrict__ qy,
                                const uint8_t* __restrict__ q_inf,
                                uint8_t* __restrict__ out, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  if (q_inf[i]) {
    out[i] = 1;
    return;
  }
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

// Lanes per warp for n lanes: one up to kOneWarpLanesPerSm lanes per SM, 4
// up to kPackedWarpsPerSm packed warps per SM, 32 (a thread per lane) past
// that.
int lanes_per_warp(long long n, int* out) {
  int sm = 0;
  const int err = sm_count(&sm);
  if (err) return err;
  const long long sms = sm;
  *out = n <= sms * kOneWarpLanesPerSm ? kOneWarp
         : n <= sms * kPackedWarpsPerSm * kPacked ? kPacked
                                                  : kOneThread;
  return 0;
}

template <int kThreadsPerLane>
void launch_warps(const void* qx, const void* qy, const void* q_inf, void* out,
                  long long n, void* stream) {
  constexpr int per_warp = kWarpThreads / kThreadsPerLane;
  subgroup_fast_warp_kernel<kThreadsPerLane>
      <<<(unsigned int)((n + per_warp - 1) / per_warp), kWarpThreads, 0,
         (cudaStream_t)stream>>>((const int4*)qx, (const int4*)qy,
                                 (const uint8_t*)q_inf, (uint8_t*)out, n);
}

// lanes: kOneWarp, kPacked or kOneThread; 0 chooses by lanes_per_warp.
int launch(const void* qx, const void* qy, const void* q_inf, void* out,
           int lanes, long long n, void* stream) {
  if (n <= 0) return 0;
  if (lanes == 0) {
    const int err = lanes_per_warp(n, &lanes);
    if (err) return err;
  }
  if (lanes == kOneWarp)
    launch_warps<kWarpThreads>(qx, qy, q_inf, out, n, stream);
  else if (lanes == kPacked)
    launch_warps<kWarpThreads / kPacked>(qx, qy, q_inf, out, n, stream);
  else if (lanes == kOneThread)
    subgroup_fast_thread_kernel<<<lane_blocks(n), kLaneThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const int4*)qx, (const int4*)qy, (const uint8_t*)q_inf,
        (uint8_t*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// qx, qy: n x 2 x 48 int32; q_inf, out: n bytes (torch.bool).
// Returns cudaGetLastError() (0 on success).
extern "C" int lh_subgroup_fast(const void* qx, const void* qy,
                                const void* q_inf, void* out, long long n,
                                void* stream) {
  return launch(qx, qy, q_inf, out, 0, n, stream);
}

// The lanes per warp that lh_subgroup_fast takes for n lanes, into *lanes;
// returns a CUDA error code.
extern "C" int lh_subgroup_fast_lanes_per_warp(long long n, int* lanes) {
  return lanes_per_warp(n, lanes);
}

// lh_subgroup_fast at a given lanes per warp (1, 4 or 32), to compare the
// shapes at one lane count.
extern "C" int lh_subgroup_fast_shaped(const void* qx, const void* qy,
                                       const void* q_inf, void* out, int lanes,
                                       long long n, void* stream) {
  return launch(qx, qy, q_inf, out, lanes, n, stream);
}
