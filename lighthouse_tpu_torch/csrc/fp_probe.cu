// A probe of fp.cuh's word arithmetic on the card: the cycles one thread
// spends per fp_mul, per pair of independent fp_mul, or per fp_add, in a
// loop where each result feeds the next call. It ports no TPU kernel and no
// path runs it: chip_smoke.py reads it to tell a product's latency from the
// issue rate of the warp that runs it (the rounds of K8, K10 and K12-K14
// each wait on one product).
//
// Built by lighthouse_tpu_torch/ops/_build.py like the kernels, loaded with
// ctypes by chip_smoke.py.

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

using fp::kWords;

enum Mode { kMul = 0, kMulPair = 1, kAdd = 2 };

// Thread t starts from x = in + t, z = in ^ t and the fixed operand y; block
// 0's thread 0 writes the clock64() cycles of the loop, and every thread its
// result words, so no call is dead code. One instance per mode keeps the
// loop to the calls it times.
template <int kMode>
__global__ void fp_probe_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out,
                                long long* __restrict__ cycles, int iters) {
  uint32_t x[kWords], y[kWords], z[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    x[j] = in[j] + threadIdx.x;
    z[j] = in[j] ^ threadIdx.x;
    y[j] = in[kWords + j];
  }
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    uint32_t r[kWords], s[kWords];
    if (kMode == kAdd) {
      fp::fp_add(r, x, y);
    } else {
      fp::fp_mul(r, x, y);
      if (kMode == kMulPair) fp::fp_mul(s, z, y);
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      x[j] = r[j];
      if (kMode == kMulPair) z[j] = s[j];
    }
  }
  const long long t1 = clock64();
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kWords; ++j) out[k * kWords + j] = x[j] ^ z[j];
  if (k == 0) *cycles = t1 - t0;
}

}  // namespace

// in: 24 words (x0, y) in [0, 2p); out: 12 words per thread; cycles: one
// int64. One block of `threads` threads on one SM. Returns
// cudaGetLastError().
extern "C" int lh_fp_probe(const void* in, void* out, void* cycles, int mode,
                           int iters, int threads, void* stream) {
  const auto* a = (const uint32_t*)in;
  auto* o = (uint32_t*)out;
  auto* c = (long long*)cycles;
  const auto st = (cudaStream_t)stream;
  switch (mode) {
    case kMul: fp_probe_kernel<kMul><<<1, threads, 0, st>>>(a, o, c, iters); break;
    case kMulPair: fp_probe_kernel<kMulPair><<<1, threads, 0, st>>>(a, o, c, iters); break;
    case kAdd: fp_probe_kernel<kAdd><<<1, threads, 0, st>>>(a, o, c, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
