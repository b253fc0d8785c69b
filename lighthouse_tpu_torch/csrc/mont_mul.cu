// Kernel K1: batched BLS12-381 Montgomery multiply, out = a * b * 2^-384.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/pallas_mont.py
// _mont_mul_kernel (and its _mont_mul_kernel_mxu flavor), entry
// mont_mul_pallas: the one kernel of the classic verify path.
//
// What bounds it on an H100: each product reads two 48 x int32 operands
// (2 x 192 B) and writes one (192 B), 576 B in all, against about 300
// 32x32->64-bit multiplies. At the H100 SXM data-sheet rate of 3.35 TB/s
// (700 W) the bytes take ~0.17 ns per product, several times what the
// multiplies take on 132 SMs, so the kernel is memory-bound.
//
// What the design does about it: one thread per product; the byte limbs are
// read once as 16-byte vectors and packed into 12 x 32-bit words IN
// REGISTERS (never through device memory), the word-level CIOS runs entirely
// in registers, and the result is unpacked on the way out. The kernel moves
// exactly the 576 B the layout forces and nothing else.
//
// Built by lighthouse_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (lighthouse_tpu_torch/ops/mont_mul.py).

#include <cuda_runtime.h>

#include "fp.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                    int4* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fp::kWords], y[fp::kWords], r[fp::kWords];
  fp::fp_load(a + i * fp::kWords, x);
  fp::fp_load(b + i * fp::kWords, y);
  fp::fp_mul(r, x, y);
  fp::fp_store(out + i * fp::kWords, r);
}

}  // namespace

// a, b, out: n x 48 contiguous int32, 16-byte aligned, on the current
// device. Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int lh_mont_mul(const void* a, const void* b, void* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  mont_mul_kernel<<<(unsigned int)blocks, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int4*)a, (const int4*)b, (int4*)out, n);
  return (int)cudaGetLastError();
}
