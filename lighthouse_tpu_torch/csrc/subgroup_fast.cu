// Kernels K4 and K15: G2 subgroup membership, K4 by the psi criterion
// psi(Q) == [x]Q, K15 by the full order [r]Q == infinity, on one launch
// rule.
//
// K4 replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:191
// _subgroup_fast_kernel (pallas_call at :246). Computes what ops/points.py
// subgroup_check_g2_fast computes: [|x|]Q on |x|'s static bit layout (the
// leading bit initialises the accumulator with Q, then 63 doublings with
// the 5 mixed additions at their positions), negated because x < 0; then
// psi(Q) = (conj(x) PSI_CX, conj(y) PSI_CY) compared with the Jacobian
// result without an inversion (px Z^2 == X, py Z^3 == Y), which must be
// finite. A lane at infinity passes.
//
// K15 replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:141
// _subgroup_kernel (pallas_call at :173). Computes the verdict of
// ops/points.py pt_subgroup_check on pt_from_affine(x, y, inf): [r]Q at
// infinity, r the curve order; a lane at infinity passes. The verdict
// alone leaves the chain free, so it runs the NAF of r (kOrderNaf*, 256
// digits, 60 of them nonzero; the reference's binary chain has 133 one
// bits below its top): Q for the leading digit, then per digit a doubling
// and, on a digit +-1, a mixed addition of the affine Q or of -Q = (x, -y),
// negated once per lane. For Q in G2 the last digit (+1) adds Q to [r - 1]Q
// = -Q, the mixed addition's P == -Q case, which gives Z3 = 0. The JAX
// package calls it from its kernel benchmark and its tests only; the
// verify path runs K4, which chip_smoke.py holds to K15 on the card.
//
// What bounds them on an H100: integer multiplies. A K4 lane is a
// dependent chain of ~1,180 Fp products (63 doublings, 5 mixed additions,
// the psi map and the comparison), a K15 lane of ~5,900 (255 doublings, 59
// mixed additions), against 769 B read and one byte written. A verify
// launches K4 on S lanes.
//
// What the design does about it: a lane runs on a group of a warp's threads
// with warp_curve.cuh's group law, as K3 does: a doubling's products in 4
// rounds, a mixed addition's in 6, psi and the comparison in 3 more, each
// round's independent products one per thread of the group, meeting at
// __syncwarp over the group; K4 285 rounds where one thread ran 1,180
// products in a row, K15 1,374 where one thread ran ~9,800 (the binary
// chain). The chains' digits are the same for every lane, so the groups of
// a warp never disagree on them; a lane at infinity leaves at once, its
// whole group together, before its first round. Both checks take one shape
// rule by lane count (lanes_per_warp), at the crossovers chip_smoke.py's
// K4 sweep measured on an H100 (PERF.md; K15's sweep found the same shapes
// fastest but for one thread per lane ahead of packed warps at 5,808 and
// 6,336 lanes, by 7.8 % at 6,336, counts no path launches K15 at):
// - up to kOneWarpLanesPerSm lanes per SM, the whole warp runs one lane (a
//   block of one warp per lane): each of an SM's four schedulers has at
//   most one such warp, and the chain is the time;
// - past that, 4 lanes per warp on groups of 8 threads, the widest round
//   (the mixed addition's 4 Fp2 squares) in one pass: a packed warp issues
//   about what a one-lane warp issues per round, so packing divides the
//   warps that share an SM's issue;
// - past kPackedWarpsPerSm packed warps per SM, one thread per lane (the
//   chain in registers and local memory, 32 lanes per block of one warp):
//   slower per lane (its products in a row), but its products' issue
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

// The NAF of the curve order r, r = sum_i d_i 2^i with d_i in {-1, 0, 1}
// and no two adjacent nonzero: bit i of kOrderNafPos is d_i = 1, of
// kOrderNafNeg d_i = -1, little-endian 32-bit words. Its top digit, +1, is
// at 255.
__device__ __constant__ const uint32_t kOrderNafPos[8] = {
    0x00000001u, 0x00000000u, 0x00008000u, 0x54002404u,
    0x0a220005u, 0x44420008u, 0x2a200148u, 0x84002854u};
__device__ __constant__ const uint32_t kOrderNafNeg[8] = {
    0x00000000u, 0x00000001u, 0x00022401u, 0x00428001u,
    0x00802800u, 0x11082800u, 0x00828400u, 0x10128101u};
constexpr int kOrderNafTop = 255;

// d_i of the NAF of r.
__device__ __forceinline__ int order_digit(int i) {
  const uint32_t bit = 1u << (i & 31);
  return (kOrderNafPos[i >> 5] & bit) ? 1 : (kOrderNafNeg[i >> 5] & bit) ? -1 : 0;
}

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

// K4's check on the affine Q = (x, y): [|x|]Q on |x|'s bits, then psi(Q)
// == -[|x|]Q; on a group of threads (warp) or one thread (thread).
struct PsiCheck {
  template <int S>
  __device__ static bool warp(const Group<S>& G, const Fp2& x, const Fp2& y) {
    Jac<Fp2> acc = pt_from_affine(x, y, false);
#pragma unroll 1
    for (int b = kXTopBit - 1; b >= 0; --b) {
      acc = pt_double(G, acc);
      if (x_bit(b)) acc = pt_add_mixed(G, acc, x, y, false);
    }
    return psi_is_x_multiple(G, acc, x, y);
  }
  __device__ static bool thread(const Fp2& x, const Fp2& y) {
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
    return eq(mul(px, z2), acc.X) && eq(mul(py, z3), yj) && !is_zero(acc.Z);
  }
};

// K15's check on the affine Q = (x, y): [r]Q on the NAF of r, at infinity.
struct OrderCheck {
  template <int S>
  __device__ static bool warp(const Group<S>& G, const Fp2& x, const Fp2& y) {
    const Fp2 ny = neg(y);
    Jac<Fp2> acc = pt_from_affine(x, y, false);
#pragma unroll 1
    for (int i = kOrderNafTop - 1; i >= 0; --i) {
      acc = pt_double(G, acc);
      const int d = order_digit(i);
      if (d) acc = pt_add_mixed(G, acc, x, d > 0 ? y : ny, false);
    }
    return is_zero(acc.Z);
  }
  __device__ static bool thread(const Fp2& x, const Fp2& y) {
    const Fp2 ny = neg(y);
    Jac<Fp2> acc = pt_from_affine(x, y, false);
#pragma unroll 1
    for (int i = kOrderNafTop - 1; i >= 0; --i) {
      acc = pt_double(acc);
      const int d = order_digit(i);
      if (d) acc = pt_add_mixed(acc, x, d > 0 ? y : ny, false);
    }
    return is_zero(acc.Z);
  }
};

// A lane on a group of kThreadsPerLane threads (32: one lane per block of
// one warp; 8: four).
template <class Check, int kThreadsPerLane>
__global__ void __launch_bounds__(kWarpThreads)
    subgroup_warp_kernel(const int4* __restrict__ qx, const int4* __restrict__ qy,
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
  const bool ok = Check::warp(G, x, y);
  if (G.g == 0) out[i] = ok ? 1 : 0;
}

// A lane per thread, the chain on curve.cuh's one-thread group law.
template <class Check>
__global__ void __launch_bounds__(kLaneThreads)
    subgroup_thread_kernel(const int4* __restrict__ qx,
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
  out[i] = Check::thread(x, y) ? 1 : 0;
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

template <class Check, int kThreadsPerLane>
void launch_warps(const void* qx, const void* qy, const void* q_inf, void* out,
                  long long n, void* stream) {
  constexpr int per_warp = kWarpThreads / kThreadsPerLane;
  subgroup_warp_kernel<Check, kThreadsPerLane>
      <<<(unsigned int)((n + per_warp - 1) / per_warp), kWarpThreads, 0,
         (cudaStream_t)stream>>>((const int4*)qx, (const int4*)qy,
                                 (const uint8_t*)q_inf, (uint8_t*)out, n);
}

// lanes: kOneWarp, kPacked or kOneThread; 0 chooses by lanes_per_warp.
template <class Check>
int launch(const void* qx, const void* qy, const void* q_inf, void* out,
           int lanes, long long n, void* stream) {
  if (n <= 0) return 0;
  if (lanes == 0) {
    const int err = lanes_per_warp(n, &lanes);
    if (err) return err;
  }
  if (lanes == kOneWarp)
    launch_warps<Check, kWarpThreads>(qx, qy, q_inf, out, n, stream);
  else if (lanes == kPacked)
    launch_warps<Check, kWarpThreads / kPacked>(qx, qy, q_inf, out, n, stream);
  else if (lanes == kOneThread)
    subgroup_thread_kernel<Check><<<lane_blocks(n), kLaneThreads, 0,
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
  return launch<PsiCheck>(qx, qy, q_inf, out, 0, n, stream);
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
  return launch<PsiCheck>(qx, qy, q_inf, out, lanes, n, stream);
}

// K15: [r]Q == infinity per lane; arguments as lh_subgroup_fast's.
extern "C" int lh_subgroup_full(const void* qx, const void* qy,
                                const void* q_inf, void* out, long long n,
                                void* stream) {
  return launch<OrderCheck>(qx, qy, q_inf, out, 0, n, stream);
}

// lh_subgroup_full at a given lanes per warp (1, 4 or 32).
extern "C" int lh_subgroup_full_shaped(const void* qx, const void* qy,
                                       const void* q_inf, void* out, int lanes,
                                       long long n, void* stream) {
  return launch<OrderCheck>(qx, qy, q_inf, out, lanes, n, stream);
}
