// Kernel K1: batched BLS12-381 Montgomery multiply, out = a * b * 2^-384.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/pallas_mont.py
// _mont_mul_kernel (and its _mont_mul_kernel_mxu flavor), entry
// mont_mul_pallas (pallas_call at :119): the one kernel of the classic
// verify path, and the products of the fused path's plain glue (the pubkey
// tree, fp12_tree_prod).
//
// What bounds it on an H100: bytes. Each product reads two 48 x int32
// operands (2 x 192 B) and writes one (192 B), 576 B in all, against one
// fp_mul (~640 32-bit instructions). At 3.35 TB/s (H100 SXM data sheet,
// 700 W) the bytes take ~0.17 ns per product; with 8 warps per SM the
// products issue in about a fifth of that.
//
// What the design does about it: every byte moves in whole tiles.
// - A block owns tiles of kTile = 64 consecutive products; a tile of a and
//   one of b are each one contiguous 12,288 B run, which one thread copies
//   into shared memory with a TMA bulk copy (cp.async.bulk) completing on
//   the stage's mbarrier.
// - The grid is persistent (SMs x resident blocks, 4 per SM at 48 KiB of
//   dynamic shared memory each) and walks the tiles with two stages: the
//   next tile's copy is in flight while this tile's products run.
// - Each thread packs its row's 12 words from shared memory, runs fp_mul
//   in registers, and writes the result's byte limbs over its own a-row;
//   one thread then sends the tile out with a bulk store. The ragged last
//   tile copies, computes and stores only its rows.
// - Bank conflicts: a row is 192 B = 48 banks, so the 8 threads of a
//   16-byte load phase would fall on 2 bank groups (4-way). Each thread
//   instead walks its row's 12 chunks from chunk (t >> 1) & 3 on, which
//   spreads every phase over the 8 groups; the words are put back in order
//   with selects. (Padding rows would break the one-copy tile.)
//
// A host compiler (the CPU tests) sees the #else branches: the copies are
// plain memcpys at the point of issue and a wait is the block's barrier.
// nvcc for sm_90a always takes the asynchronous copies.
//
// Built by lighthouse_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (lighthouse_tpu_torch/ops/mont_mul.py).

#include <cuda_runtime.h>
#include <string.h>

#include "fp.cuh"

namespace {

constexpr int kTile = 64;                     // products per tile = threads
constexpr int kRowBytes = 4 * fp::kLimbs;     // 192
constexpr int kChunks = kRowBytes / 16;       // 12 int4 per row
constexpr int kTileBytes = kTile * kRowBytes;  // 12,288
constexpr int kStages = 2;
// per stage: the a tile, then the b tile; then one mbarrier per stage
constexpr int kSmemBytes = kStages * 2 * kTileBytes + kStages * 8;

#if defined(__CUDA_ARCH__)
#if __CUDA_ARCH__ < 900
#error "mont_mul.cu needs sm_90 (TMA bulk copies)"
#endif
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// a and b tiles of `bytes` each into shared memory, completing on `bar`.
__device__ __forceinline__ void load_tile(unsigned char* sa, unsigned char* sb,
                                          const int4* a, const int4* b,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t mb = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(mb), "r"(2 * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(sa)), "l"(a), "r"(bytes), "r"(mb) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(sb)), "l"(b), "r"(bytes), "r"(mb) : "memory");
}

// Until the stage's copy of its use `parity` (0, 1, 0, ...) has landed.
__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Orders this thread's shared-memory writes before the bulk copies issued
// after the next barrier.
__device__ __forceinline__ void writes_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void store_tile(int4* out, const unsigned char* s,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(out), "r"(smem_u32(s)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until the stores issued so far have read their shared memory.
__device__ __forceinline__ void stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
#else
__device__ __forceinline__ void bar_init(uint64_t*) {}
__device__ __forceinline__ void bar_init_fence() {}
__device__ __forceinline__ void load_tile(unsigned char* sa, unsigned char* sb,
                                          const int4* a, const int4* b,
                                          uint32_t bytes, uint64_t*) {
  memcpy(sa, a, bytes);
  memcpy(sb, b, bytes);
}
__device__ __forceinline__ void wait_tile(uint64_t*, uint32_t) {
  __syncthreads();
}
__device__ __forceinline__ void writes_to_async() {}
__device__ __forceinline__ void store_tile(int4* out, const unsigned char* s,
                                           uint32_t bytes) {
  memcpy(out, s, bytes);
}
__device__ __forceinline__ void stores_read() {}
__device__ __forceinline__ void stores_done() {}
#endif

// w[k] = v[(k - rot) mod 12] for rot in [0, 4), by two conditional turns.
__device__ __forceinline__ void turn_back(uint32_t w[fp::kWords], int rot) {
  uint32_t t[fp::kWords];
#pragma unroll
  for (int k = 0; k < fp::kWords; ++k)
    t[k] = (rot & 1) ? w[(k + fp::kWords - 1) % fp::kWords] : w[k];
#pragma unroll
  for (int k = 0; k < fp::kWords; ++k)
    w[k] = (rot & 2) ? t[(k + fp::kWords - 2) % fp::kWords] : t[k];
}

// w[k] = v[(k + rot) mod 12]: the inverse turn.
__device__ __forceinline__ void turn(uint32_t w[fp::kWords], int rot) {
  uint32_t t[fp::kWords];
#pragma unroll
  for (int k = 0; k < fp::kWords; ++k)
    t[k] = (rot & 2) ? w[(k + 2) % fp::kWords] : w[k];
#pragma unroll
  for (int k = 0; k < fp::kWords; ++k)
    w[k] = (rot & 1) ? t[(k + 1) % fp::kWords] : t[k];
}

// One row's 48 byte limbs -> 12 words, reading chunk (k + rot) mod 12 at
// step k.
__device__ __forceinline__ void load_row(const unsigned char* row, int rot,
                                         uint32_t w[fp::kWords]) {
  const int4* src = (const int4*)row;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    int c = k + rot;
    c -= c >= kChunks ? kChunks : 0;
    w[k] = fp::limbs_to_word(src[c]);
  }
  turn_back(w, rot);
}

// 12 words -> one row's 48 byte limbs, in the same chunk order.
__device__ __forceinline__ void store_row(unsigned char* row, int rot,
                                          uint32_t w[fp::kWords]) {
  int4* dst = (int4*)row;
  turn(w, rot);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    int c = k + rot;
    c -= c >= kChunks ? kChunks : 0;
    dst[c] = fp::word_to_limbs(w[k]);
  }
}

extern __shared__ __align__(128) unsigned char smem[];

__global__ void __launch_bounds__(kTile)
    mont_mul_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                    int4* __restrict__ out, long long n) {
  uint64_t* bars = (uint64_t*)(smem + kStages * 2 * kTileBytes);
  const int tid = threadIdx.x;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long step = gridDim.x;
  auto rows_of = [n](long long tile) {
    const long long left = n - tile * kTile;
    return (int)(left < kTile ? left : kTile);
  };
  auto issue = [&](int s, long long tile) {
    unsigned char* sa = smem + s * 2 * kTileBytes;
    const long long at = tile * kTile * kChunks;  // int4 offset of the tile
    load_tile(sa, sa + kTileBytes, a + at, b + at,
              (uint32_t)rows_of(tile) * kRowBytes, &bars[s]);
  };

  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    bar_init_fence();
  }
  __syncthreads();
  long long tile = blockIdx.x;
  if (tid == 0 && tile < tiles) issue(0, tile);
  for (int i = 0; tile < tiles; ++i, tile += step) {
    const int s = i & 1;
    if (tid == 0 && tile + step < tiles) {
      stores_read();  // the store of the last tile has read stage s ^ 1
      issue(s ^ 1, tile + step);
    }
    wait_tile(&bars[s], (uint32_t)(i >> 1) & 1u);
    unsigned char* sa = smem + s * 2 * kTileBytes;
    const int rows = rows_of(tile);
    if (tid < rows) {
      const int rot = (tid >> 1) & 3;
      uint32_t x[fp::kWords], y[fp::kWords], r[fp::kWords];
      load_row(sa + tid * kRowBytes, rot, x);
      load_row(sa + kTileBytes + tid * kRowBytes, rot, y);
      fp::fp_mul(r, x, y);
      store_row(sa + tid * kRowBytes, rot, r);
    }
    writes_to_async();
    __syncthreads();
    if (tid == 0)
      store_tile(out + tile * kTile * kChunks, sa, (uint32_t)rows * kRowBytes);
  }
  if (tid == 0) stores_done();
}

}  // namespace

// a, b, out: n x 48 contiguous int32, 16-byte aligned, on the current
// device. Launches on `stream`; returns cudaGetLastError() (0 on success).
// The first launch on a device sets the kernel's dynamic shared memory and
// reads the persistent grid's size (SMs x resident blocks per SM).
extern "C" int lh_mont_mul(const void* a, const void* b, void* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  static int grid_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(mont_mul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mont_mul_kernel, kTile, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    grid_of[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned int grid =
      (unsigned int)(tiles < grid_of[dev] ? tiles : grid_of[dev]);
  mont_mul_kernel<<<grid, kTile, kSmemBytes, (cudaStream_t)stream>>>(
      (const int4*)a, (const int4*)b, (int4*)out, n);
  return (int)cudaGetLastError();
}
