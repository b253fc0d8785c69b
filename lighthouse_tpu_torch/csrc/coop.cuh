// One block per lane: a block runs straight-line Fp programs (ops/coop.py)
// round by round, the independent operations of a round spread over its
// threads. Kernels K8 (miller.cu), K9 and K10 (final_exp.cu) are built on
// it.
//
// A lane's values live in shared memory as numbered slots of 12 words,
// word-major (word k of slot s at slots[k * n_slots + s], so threads on
// different slots hit different banks). A program is rounds of
// (op, dst, a, b) slot operations in which no operation reads a slot
// that another of the round writes; thread t runs operations t, t + T, ...
// of a round with its operands in registers (one fp::fp_mul, fp_add,
// fp_sub or fp_neg of fp.cuh), and __syncthreads() separates the rounds.
// Each operation gets the operands it has in the plain version, so the
// limbs are the plain version's. No tower function is called: there are no
// out-of-line frames and no local memory.
//
// What a block does for its lane is a plan (ops/coop.py Plan, packed by
// ops/coop.py pack as int16): [n_slots, n_programs, n_loads, n_stores,
// n_steps], the offset of each program, the loads (slot, source, stride,
// k), the stores (slot, negate), the steps (program indices; in a kernel
// built with inversion steps, -1 - s inverts fixed slot s in place), then
// each program [n_rounds, start of each round and the end, then 4 values
// per operation]. A block copies the plan from global into shared memory
// once, after its slots; the kernels name no slot, program or bit of their
// own.

#pragma once

#include <stdint.h>

#include "fp.cuh"
#include "lanes.cuh"

namespace coop {

using fp::kWords;

// Operation codes (ops/coop.py MUL, ADD, SUB, NEG), load sources that
// are constants (ZERO, ONE) and the plan's header length (HEADER).
constexpr int kMul = 0, kAdd = 1, kSub = 2, kNeg = 3;
constexpr int kLoadZero = -1, kLoadOne = -2;
constexpr int kHeader = 5;

// The kernel's inputs, indexed by a load's source.
struct Inputs {
  const int4* p[4];

  // p[k] by selects, not a dynamic index (which would copy p to the stack).
  __device__ __forceinline__ const int4* at(int k) const {
    const int4* r = p[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) r = k == j ? p[j] : r;
    return r;
  }
};

struct Block {
  uint32_t* slots;
  int n_slots;
  const int16_t* prog;
};

// The block's shared memory: slots, then the plan copied from `prog`
// (n_slots is its first value).
__device__ __forceinline__ Block enter(const int16_t* __restrict__ prog,
                                       int prog_len) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_slots = prog[0];
  int16_t* p = reinterpret_cast<int16_t*>(smem + n_slots * kWords);
  for (int i = threadIdx.x; i < prog_len; i += blockDim.x) p[i] = prog[i];
  __syncthreads();
  return {smem, n_slots, p};
}

__device__ __forceinline__ void get(const Block& b, int s, uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = b.slots[k * b.n_slots + s];
}

__device__ __forceinline__ void put(const Block& b, int s,
                                    const uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) b.slots[k * b.n_slots + s] = w[k];
}

// Slot s <- one Fp value of global memory (48 byte limbs).
__device__ __forceinline__ void load(const Block& b, int s,
                                     const int4* __restrict__ src) {
  uint32_t w[kWords];
  fp::fp_load(src, w);
  put(b, s, w);
}

// Slot s <- one (fp::kOne) or zero.
__device__ __forceinline__ void set(const Block& b, int s, bool one) {
  uint32_t w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = one ? fp::kOne[k] : 0u;
  put(b, s, w);
}

// Global memory <- slot s, negated when `negate` (a conjugate's c1).
__device__ __forceinline__ void store(const Block& b, int s,
                                      int4* __restrict__ dst, bool negate) {
  uint32_t w[kWords];
  get(b, s, w);
  if (negate) {
    uint32_t r[kWords];
    fp::fp_neg(r, w);
    fp::fp_store(dst, r);
  } else {
    fp::fp_store(dst, w);
  }
}

__device__ __forceinline__ void exec(const Block& b, const int16_t* op) {
  const int kind = op[0];
  uint32_t x[kWords], y[kWords], r[kWords];
  get(b, op[2], x);
  get(b, op[3], y);
  if (kind == kMul) {
    fp::fp_mul(r, x, y);
  } else if (kind == kAdd) {
    fp::fp_add(r, x, y);
  } else if (kind == kSub) {
    fp::fp_sub(r, x, y);
  } else {
    fp::fp_neg(r, x);
  }
  put(b, op[1], r);
}

// Run program `p` of the plan, every thread of the block together.
__device__ __forceinline__ void run(const Block& b, int p) {
  const int16_t* q = b.prog + b.prog[kHeader + p];
  const int n_rounds = q[0];
  const int16_t* ops = q + 2 + n_rounds;
#pragma unroll 1
  for (int r = 0; r < n_rounds; ++r) {
#pragma unroll 1
    for (int i = q[1 + r] + threadIdx.x; i < q[2 + r]; i += blockDim.x)
      exec(b, ops + 4 * i);
    __syncthreads();
  }
}

// An inversion step: slot s <- its inverse (fp.cuh fp_inv_gcd, 0 -> 0),
// by thread 0 while the block waits at the barrier after it.
static __device__ __noinline__ void invert(const Block& b, int s) {
  if (threadIdx.x == 0) {
    uint32_t x[kWords], r[kWords];
    get(b, s, x);
    fp::fp_inv_gcd(r, x);
    put(b, s, r);
  }
  __syncthreads();
}

// Lane i of the plan `prog` (prog_len int16 values): load the fixed slots
// from `in`, run the steps unless `skip`, store the outputs to `out`
// (n_stores Fp values per lane), negated where the plan says unless
// `skip`. Only a kernel built with kInvert runs inversion steps.
template <bool kInvert = false>
__device__ __forceinline__ void run_lane(const int16_t* __restrict__ prog,
                                         int prog_len, const Inputs& in,
                                         int4* __restrict__ out, long long i,
                                         bool skip) {
  const Block b = enter(prog, prog_len);
  const int n_loads = b.prog[2], n_stores = b.prog[3], n_steps = b.prog[4];
  const int16_t* loads = b.prog + kHeader + b.prog[1];
  const int16_t* stores = loads + 4 * n_loads;
  const int16_t* steps = stores + 2 * n_stores;
  for (int j = threadIdx.x; j < n_loads; j += blockDim.x) {
    const int16_t* ld = loads + 4 * j;
    if (ld[1] >= 0)  // stride ld[2] 0: an input every lane shares
      load(b, ld[0], in.at(ld[1]) + (i * ld[2] + ld[3]) * kWords);
    else
      set(b, ld[0], ld[1] == kLoadOne);
  }
  __syncthreads();
  if (!skip) {
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
      if (kInvert && steps[s] < 0)
        invert(b, -1 - steps[s]);
      else
        run(b, steps[s]);
    }
  }
  for (int j = threadIdx.x; j < n_stores; j += blockDim.x)
    store(b, stores[2 * j], out + (i * n_stores + j) * kWords,
          !skip && stores[2 * j + 1]);
}

// Launch `kernel` on n blocks of kCoopThreads with `bytes` of dynamic
// shared memory (ops/coop.py shared_bytes; at most the default 48 KB).
template <class Kernel, class... Args>
int launch(Kernel kernel, long long n, int bytes, cudaStream_t stream,
           Args... args) {
  kernel<<<(unsigned int)n, bls::kCoopThreads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace coop
