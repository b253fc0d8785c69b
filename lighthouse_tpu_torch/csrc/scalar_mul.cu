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
// What bounds it on an H100: a lane is a dependent chain of 64 doublings
// and ~31 mixed additions, ~820 Fp products for G1 (~2,000 for G2),
// against 641 B / 1,025 B read and 576 B / 1,152 B written. A verify
// launches it on S lanes (S sets, padded to a power of two).
//
// What the design does about it: a lane runs on a group of a warp's threads
// with warp_curve.cuh's group law: a doubling's products in 4 rounds, a
// mixed addition's in 6, each round's independent products one per thread
// of the group, meeting at __syncwarp over the group. The lane's bit is the
// same for its whole group, so the addition is a branch that runs only on
// one bits (the plain version computes it on every bit and selects: the
// same limbs). The group's width follows the lane count (lanes_per_warp):
// - up to one lane per SM, the whole warp runs one lane (a block of one
//   warp per lane): the chain is the time, and a 64-bit lane is 256
//   doubling rounds and ~190 addition rounds;
// - past that, lanes are packed into the warp on groups just wide enough
//   for the widest round (4 threads over Fp, 8 over Fp2), so each round
//   issues a product on every thread. Every thread runs its lane's
//   additions, so a warp of one lane issues about as much per round as a
//   warp of eight: once several warps share an SM's schedulers, issue sets
//   the time, and packing divides it by the lanes per warp. The groups of a
//   warp disagree on their bits, so the warp runs the addition on nearly
//   every bit (~640 rounds).

#include "warp_curve.cuh"

namespace {

using namespace bls;

// Threads of a lane packed several to a warp: the widest round of the
// doubling and the mixed addition (4 squares of the addition's fourth
// round) over Fp, and over Fp2 twice that (a square's two products).
template <class F>
constexpr int kPackedThreads = sizeof(F) == sizeof(Fp) ? 4 : 8;

template <class F, int kThreadsPerLane>
__global__ void __launch_bounds__(kWarpThreads)
    scalar_mul_kernel(const int4* __restrict__ qx, const int4* __restrict__ qy,
                      const uint8_t* __restrict__ q_inf,
                      const int32_t* __restrict__ bits,
                      int4* __restrict__ oX, int4* __restrict__ oY,
                      int4* __restrict__ oZ, int nbits, long long n) {
  __shared__ uint4 slots[kWarpSlots];
  const Group<kThreadsPerLane> G = sub_group<kThreadsPerLane>(slots);
  const long long i = (long long)blockIdx.x * (kWarpThreads / kThreadsPerLane) +
                      threadIdx.x / kThreadsPerLane;
  if (i >= n) return;  // the ragged last warp's idle groups, whole
  constexpr int W = sizeof(F) / sizeof(Fp) * kWords;  // int4 per value
  F x, y;
  load(x, qx + i * W);
  load(y, qy + i * W);
  const bool inf = q_inf[i] != 0;
  const int32_t* b = bits + i * nbits;
  Jac<F> acc = {one(F()), one(F()), zero(F())};
#pragma unroll 1
  for (int k = 0; k < nbits; ++k) {
    acc = pt_double(G, acc);
    if (b[k] == 1) acc = pt_add_mixed(G, acc, x, y, inf);
  }
  if (G.g == 0) {
    store(oX + i * W, acc.X);
    store(oY + i * W, acc.Y);
    store(oZ + i * W, acc.Z);
  }
}

// Lanes per warp for n lanes: one while each lane can have an SM of its
// own, else packed.
template <class F>
int lanes_per_warp(long long n, int* out) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  *out = n <= sms ? 1 : kWarpThreads / kPackedThreads<F>;
  return 0;
}

template <class F, int kThreadsPerLane>
void launch_shape(const void* qx, const void* qy, const void* q_inf,
                  const void* bits, void* oX, void* oY, void* oZ, int nbits,
                  long long n, void* stream) {
  constexpr int per_warp = kWarpThreads / kThreadsPerLane;
  scalar_mul_kernel<F, kThreadsPerLane>
      <<<(unsigned int)((n + per_warp - 1) / per_warp), kWarpThreads, 0,
         (cudaStream_t)stream>>>(
          (const int4*)qx, (const int4*)qy, (const uint8_t*)q_inf,
          (const int32_t*)bits, (int4*)oX, (int4*)oY, (int4*)oZ, nbits, n);
}

// lanes: 1, or kWarpThreads / kPackedThreads<F>; 0 chooses by lanes_per_warp.
template <class F>
int launch(const void* qx, const void* qy, const void* q_inf, const void* bits,
           void* oX, void* oY, void* oZ, int nbits, long long n, void* stream,
           int lanes) {
  if (n <= 0) return 0;
  if (lanes == 0) {
    const int err = lanes_per_warp<F>(n, &lanes);
    if (err) return err;
  }
  if (lanes == 1)
    launch_shape<F, kWarpThreads>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream);
  else if (lanes == kWarpThreads / kPackedThreads<F>)
    launch_shape<F, kPackedThreads<F>>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// qx, qy: n x (2 x) 48 int32; q_inf: n bytes; bits: n x nbits int32 (MSB
// first); oX, oY, oZ: n x (2 x) 48 int32. Returns cudaGetLastError().
extern "C" int lh_scalar_mul_g1(const void* qx, const void* qy,
                                const void* q_inf, const void* bits, void* oX,
                                void* oY, void* oZ, int nbits, long long n,
                                void* stream) {
  return launch<Fp>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream, 0);
}

extern "C" int lh_scalar_mul_g2(const void* qx, const void* qy,
                                const void* q_inf, const void* bits, void* oX,
                                void* oY, void* oZ, int nbits, long long n,
                                void* stream) {
  return launch<Fp2>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream, 0);
}

// The lanes per warp that lh_scalar_mul_g1 (g2 = 0) or _g2 takes for n
// lanes, into *lanes; returns a CUDA error code.
extern "C" int lh_scalar_mul_lanes_per_warp(int g2, long long n, int* lanes) {
  return g2 ? lanes_per_warp<Fp2>(n, lanes) : lanes_per_warp<Fp>(n, lanes);
}

// lh_scalar_mul_g1 / _g2 at a given lanes per warp (1, or 8 for G1 and 4
// for G2), to compare the two shapes at one lane count.
extern "C" int lh_scalar_mul_shaped(int g2, int lanes, const void* qx,
                                    const void* qy, const void* q_inf,
                                    const void* bits, void* oX, void* oY,
                                    void* oZ, int nbits, long long n,
                                    void* stream) {
  return g2 ? launch<Fp2>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream, lanes)
            : launch<Fp>(qx, qy, q_inf, bits, oX, oY, oZ, nbits, n, stream, lanes);
}
