// Kernels K5, K6 and K7: the bucketed multi-scalar multiplication
// sum_i r_i S_i of the fused verify's signature accumulator.
//
// Replaces the Pallas TPU kernels of lighthouse_tpu/ops/msm.py: the
// accumulation kernel of _accum_t (:153, pallas_call at :174), the bucket
// tree _tree_kernel (:185) and the Horner pass _horner_kernel (:213), both
// through _f3_call (pallas_call at :269). Each computes what its plain
// version in ops/msm.py computes, on the same 256-lane layout (bucket lane
// = (digit - 1) * 16 + window, lanes 240-255 padding), with the group law of
// warp_curve.cuh, which follows ops/points.py case for case; the raw limbs
// equal the plain versions' (K5 cut into segments: those of ops/msm.py
// accum_segments_plain, the same points).
//
// What bounds them on an H100: integer multiplies in dependent chains. At
// S = 128 sets K5 runs L = 48 rounds, of which a bucket holds ~8 points on
// average and ~16 at most, each after its first a mixed addition of 31 Fp
// products; at S = 2048, L = 208 and ~160 at most. K6 runs eight complete
// additions per lane (43 Fp products each while both sides are finite);
// K7 60 doublings and 15 additions on one lane (~1,600 Fp products). The
// bytes (the signatures gathered, the [L, 240] schedule, 256 Jacobian
// points in and out) are tens of kilobytes.
//
// What the design does about it: K5 runs each bucket on a group of a
// warp's threads with warp_curve.cuh's group law: a mixed addition's
// products in 6 rounds, each round's independent Fp2 products one per
// thread, meeting at __syncwarp; a group is one bucket, so it runs only the
// rounds its bucket marks valid. The deepest bucket sets the time, so a
// bucket is cut into k segments of its valid rounds (16, or 32 past 256
// rounds), each summed on its own group of 8 threads (accum_segments),
// and the block joins the k sums in a tree of log2 k complete additions. K5
// gathers its points from the int32 schedule itself (no [L, 240] copy of
// the points). K6's shifts (16, 32, 64, 128 lanes) never leave a window
// (lane j * 16 + w reads lane (j + 2^s) * 16 + w), so it runs one block
// per window, 16 blocks on 16 SMs: each of the window's 16 lanes on a group
// of 16 threads of warp_curve.cuh's complete addition (6 rounds, the widest
// of 12 products), the window's points in shared memory between the eight
// steps; 48 rounds on the deepest lane where one thread per lane ran ~340
// products in a row on one SM. K7, the one lane-0 chain the reference reads,
// runs on one warp with warp_curve.cuh's group law: a doubling's products
// in 4 rounds, an addition's in 6; 330 rounds where one thread ran ~1,600
// products in a row. The windows keep the plain version's Horner order
// (its 60 doublings stay on the chain either way, and the limbs stay its
// limbs).

#include "warp_curve.cuh"

namespace {

using namespace bls;

constexpr int kBuckets = 240;  // 16 windows x 15 nonzero digits
constexpr int kLanes = 256;    // the bucket axis padded to a power of two
constexpr int kWindows = 16;
constexpr int kWindowBits = 4;
constexpr int W = 2 * kWords;  // int4 per Fp2 value

__device__ __forceinline__ Jac<Fp2> load_point(const int4* X, const int4* Y,
                                               const int4* Z, int lane) {
  Jac<Fp2> P;
  load(P.X, X + lane * W);
  load(P.Y, Y + lane * W);
  load(P.Z, Z + lane * W);
  return P;
}

__device__ __forceinline__ void store_point(int4* X, int4* Y, int4* Z,
                                            int lane, const Jac<Fp2>& P) {
  store(X + lane * W, P.X);
  store(Y + lane * W, P.Y);
  store(Z + lane * W, P.Z);
}

// ------------------------------------------------------------------ K5

// Threads of a segment's group: the widest round of the mixed addition
// over Fp2 (its 4 squares, 8 Fp products). Threads of a join's group: the
// widest round of the complete addition over Fp2 (4 products, 12).
constexpr int kPackedGroup = 8;
constexpr int kJoinThreads = 16;
// The largest block (segments x threads per group) and the most segments.
constexpr int kAccumThreads = 256;
constexpr int kMaxSegments = 32;
static_assert(kPackedGroup * kMaxSegments == kAccumThreads, "one bucket per largest block");
// The segments of the launch (accum_segments), from chip_smoke.py's K5
// sweep on an H100 (PERF.md): a bucket cut into kMinSegments segments,
// more while a segment would hold over kSegmentRounds of the schedule's L
// rounds. 16 segments were the fastest at S = 128-2048 sets (L = 48-208):
// the points per segment and the joins' log2 k levels balance there, and
// blocks of 4 warps fill one wave of 2 blocks per SM at 255 registers; 32
// segments (blocks of 8 warps, two waves) won at S = 8192 (L = 664) and,
// in two runs of three, at S = 4096 (L = 368). No size between L = 208
// and 368 was measured, so the switch sits between them, past L = 256.
// A whole warp per group, which K3 and K4 take while their lanes are few
// per SM, lost at every S and segment count measured, so the groups have
// 8 threads: 16 segments of 240 buckets are 3,840 groups, and a group of 8
// issues per round what a warp of one group does.
constexpr int kMinSegments = 16;
constexpr int kSegmentRounds = 16;

// This thread's group of kSize consecutive threads (kSize divides 32 and
// is less) in a block of one or more warps, on its kSize of the block's
// slots.
template <int kSize>
__device__ __forceinline__ Group<kSize> block_group(uint4* slots) {
  static_assert(kWarpThreads % kSize == 0 && kSize < kWarpThreads, "a part of a warp");
  const int q = threadIdx.x / kSize;
  const unsigned mask = ((1u << kSize) - 1) << (kSize * (q % (kWarpThreads / kSize)));
  return {(int)(threadIdx.x % kSize), mask, slots + q * kSize * kSlotVecs};
}

// The affine point (sx, sy)[idx[r, b]] of bucket b's round r; a pad lane
// (b >= kBuckets) reads nothing and takes the all-zero point.
__device__ __forceinline__ void gather(const int4* __restrict__ sx,
                                       const int4* __restrict__ sy,
                                       const int32_t* __restrict__ idx, int r,
                                       int b, Fp2& x, Fp2& y) {
  if (b >= kBuckets) {
    x = y = zero(Fp2());
    return;
  }
  const long long i = idx[(long long)r * kBuckets + b];
  load(x, sx + i * W);
  load(y, sy + i * W);
}

// Segment j of k of bucket b, summed on the group G. The segment holds the
// bucket's valid rounds lo .. hi - 1 in order (of its c, lo = ceil(j c /
// k)), and the rounds [r0, r1) from the one after valid round lo - 1 to
// valid round hi - 1 (the last segment to L): the invalid rounds before a
// valid one go with it, those after the last with the last segment, so the
// segments cut [0, L) into k runs. Every thread of the group scans the
// bucket's column of `valid` for c, r0 and r1 (the same values in each),
// and the group's threads check the indices of the runs' rounds between
// them. The sum starts at infinity (one, one, zero) and runs the plain
// version's round rule on [r0, r1): a valid round is warp_curve.cuh's
// mixed addition (the first lands on infinity with no product); an
// invalid one leaves a finite sum and sets a sum at infinity to the
// round's (x, y, 0), which the next valid round replaces whole. So the
// group runs only the valid rounds, and a sum at infinity after them
// takes the point of the segment's last round if that round is invalid.
__device__ __forceinline__ Jac<Fp2> segment_sum(
    const Group<kPackedGroup>& G, const int4* __restrict__ sx,
    const int4* __restrict__ sy, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid, int L, int S, int b, int j, int k) {
  const bool pad = b >= kBuckets;
  const uint8_t* col = valid + b;
  int c = 0;
  if (!pad) {
#pragma unroll 8
    for (int r = 0; r < L; ++r) c += col[(long long)r * kBuckets] != 0;
  }
  const bool last = j == k - 1;
  const int lo = (j * c + k - 1) / k, hi = ((j + 1) * c + k - 1) / k;
  int r0 = 0, r1 = last ? L : 0;
  if (lo > 0 || (!last && hi > 0)) {
    int seen = 0;
#pragma unroll 8
    for (int r = 0; r < L; ++r) {
      if (col[(long long)r * kBuckets] != 0) {
        ++seen;
        if (seen == lo) r0 = r + 1;
        if (!last && seen == hi) r1 = r + 1;
      }
    }
  }
  if (!pad) {
#pragma unroll 1
    for (int r = r0 + G.g; r < r1; r += kPackedGroup) {
      const int i = idx[(long long)r * kBuckets + b];
      if (i < 0 || i >= S) __trap();  // the plain version's IndexError
    }
    __syncwarp(G.mask);  // every index checked before any gather
  }
  Jac<Fp2> acc = {one(Fp2()), one(Fp2()), zero(Fp2())};
  const int want = hi - lo;
  Fp2 x, y;
#pragma unroll 1
  for (int r = r0, done = 0; r < r1 && done < want; ++r) {
    if (pad || col[(long long)r * kBuckets] == 0) continue;
    gather(sx, sy, idx, r, b, x, y);
    acc = pt_add_mixed(G, acc, x, y, false);
    ++done;
  }
  if (r1 > r0 && is_zero(acc.Z) && (pad || col[(long long)(r1 - 1) * kBuckets] == 0)) {
    gather(sx, sy, idx, r1 - 1, b, x, y);
    acc = {x, y, zero(Fp2())};
  }
  return acc;
}

// K5: bucket b (lanes 240-255 pad the bucket axis, all-zero points never
// valid) as k segments, each on a group of kPackedGroup threads; a block
// holds whole buckets (its threads 8 k, or 32 with 4 / k buckets).
// With k = 1 the segment is the plain version's chain and the group
// stores it. Past that the groups leave their sums in shared memory and the
// block joins each bucket's k sums by warp_curve.cuh's complete addition
// in a tree, s[a] = s[a] + s[a + step] for step = 1, 2, .. k / 2 and a a
// multiple of 2 step, each addition on a half-warp, a barrier between
// the levels; ops/msm.py accum_segments_plain gives the limbs.
__global__ void __launch_bounds__(kAccumThreads)
    msm_accum_kernel(const int4* __restrict__ sx, const int4* __restrict__ sy,
                     const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid,
                     int4* __restrict__ oX, int4* __restrict__ oY,
                     int4* __restrict__ oZ, int L, int S, int k) {
  __shared__ uint4 slots[kAccumThreads * kSlotVecs];
  __shared__ uint4 sums_raw[kAccumThreads / kPackedGroup * sizeof(Jac<Fp2>) / sizeof(uint4)];
  const int q = threadIdx.x / kPackedGroup;  // the block's group
  const int per_block = blockDim.x / (kPackedGroup * k);  // buckets
  const int b = blockIdx.x * per_block + q / k, j = q % k;
  const Group<kPackedGroup> G = block_group<kPackedGroup>(slots);
  const Jac<Fp2> s = segment_sum(G, sx, sy, idx, valid, L, S, b, j, k);
  if (k == 1) {
    if (G.g == 0) store_point(oX, oY, oZ, b, s);
    return;
  }
  Jac<Fp2>* sums = reinterpret_cast<Jac<Fp2>*>(sums_raw);
  if (G.g == 0) sums[q] = s;
  __syncthreads();
  const Group<kJoinThreads> H = block_group<kJoinThreads>(slots);
  const int h = threadIdx.x / kJoinThreads;
#pragma unroll 1
  for (int step = 1; step < k; step <<= 1) {
    const int adds = k / (2 * step);  // per bucket
    if (h < per_block * adds) {
      const int lhs = h / adds * k + h % adds * 2 * step;
      const Jac<Fp2> P = pt_add(H, sums[lhs], sums[lhs + step]);
      __syncwarp(H.mask);  // every thread of the group has read both sums
      if (H.g == 0) sums[lhs] = P;
    }
    __syncthreads();
  }
  if (j == 0 && G.g == 0) store_point(oX, oY, oZ, b, sums[q]);
}

// The segments per bucket of K5's launch for L rounds.
int accum_segments(int L) {
  int k = kMinSegments;
  while (k < kMaxSegments && (L + k - 1) / k > kSegmentRounds) k <<= 1;
  return k;
}

void accum_launch(const void* sx, const void* sy, const void* idx,
                  const void* valid, void* oX, void* oY, void* oZ, int L,
                  int S, int k, cudaStream_t stream) {
  const int threads = kPackedGroup * k > kWarpThreads ? kPackedGroup * k : kWarpThreads;
  msm_accum_kernel<<<kLanes * kPackedGroup * k / threads, threads, 0, stream>>>(
      (const int4*)sx, (const int4*)sy, (const int32_t*)idx,
      (const uint8_t*)valid, (int4*)oX, (int4*)oY, (int4*)oZ, L, S, k);
}

// ------------------------------------------------------------------ K6

// A window's lanes, and the threads per lane: the complete addition's
// widest round (its 4 Fp2 products, 12 Fp products) in one pass. On an
// H100, groups of 4 and 8 threads (a round in 3 and 2 passes) took 0.263
// and 0.197 ms against 16's 0.153, at S = 128 and 2048 alike (the 16
// blocks' work does not depend on S; PERF.md).
constexpr int kWindowLanes = kLanes / kWindows;
constexpr int kTreeThreads = 16;

// K6: two passes of P = pt_add(P, shift_down(P, sh)) for sh = 16, 32, 64,
// 128. Block w is window w: its lanes j * 16 + w, j = 0 .. 15 (digit j + 1;
// j = 15 the pad lane 240 + w), lane j on the block's group j of
// kTreeThreads threads; lane j reads lane j + sh / 16 of the previous step
// from shared memory, and the lanes shifted in from beyond the window's
// top (beyond lane 255) are all-zero limbs. A lane at infinity on either
// side returns from pt_add with its whole group before its first round.
__global__ void __launch_bounds__(kWindowLanes * kTreeThreads)
    msm_tree_kernel(const int4* __restrict__ bX, const int4* __restrict__ bY,
                    const int4* __restrict__ bZ, int4* __restrict__ oX,
                    int4* __restrict__ oY, int4* __restrict__ oZ) {
  __shared__ uint4 slots[kWindowLanes * kTreeThreads * kSlotVecs];
  __shared__ uint4 lanes_raw[kWindowLanes * sizeof(Jac<Fp2>) / sizeof(uint4)];
  Jac<Fp2>* lanes = reinterpret_cast<Jac<Fp2>*>(lanes_raw);
  const Group<kTreeThreads> G = block_group<kTreeThreads>(slots);
  const int j = threadIdx.x / kTreeThreads;
  const int lane = j * kWindows + blockIdx.x;
  Jac<Fp2> P = load_point(bX, bY, bZ, lane);
  if (G.g == 0) lanes[j] = P;
  __syncthreads();
  const Fp2 z = zero(Fp2());
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
    for (int s = 1; s < kWindowLanes; s <<= 1) {
      const Jac<Fp2> Q = j + s < kWindowLanes ? lanes[j + s] : Jac<Fp2>{z, z, z};
      P = pt_add(G, P, Q);
      __syncthreads();  // every lane has read the previous step
      if (G.g == 0) lanes[j] = P;
      __syncthreads();
    }
  }
  if (G.g == 0) store_point(oX, oY, oZ, lane, P);
}

// K7: acc = T[15]; for w = 14 .. 0: four doublings, then acc + T[w] (the
// reference's rotations put T[w] in lane 0 at window w). One block of one
// warp: the warp group law of warp_curve.cuh.
__global__ void __launch_bounds__(kWarpThreads)
    msm_horner_kernel(const int4* __restrict__ tX, const int4* __restrict__ tY,
                      const int4* __restrict__ tZ, int4* __restrict__ oX,
                      int4* __restrict__ oY, int4* __restrict__ oZ) {
  __shared__ uint4 slots[kWarpSlots];
  const Group<kWarpThreads> G = warp_group(slots);
  Jac<Fp2> acc = load_point(tX, tY, tZ, kWindows - 1);
#pragma unroll 1
  for (int w = kWindows - 2; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < kWindowBits; ++k) acc = pt_double(G, acc);
    acc = pt_add(G, acc, load_point(tX, tY, tZ, w));
  }
  if (threadIdx.x == 0) store_point(oX, oY, oZ, 0, acc);
}

}  // namespace

// sx, sy: S x 2 x 48 int32; idx: L x 240 int32; valid: L x 240 bytes;
// oX, oY, oZ: 256 x 2 x 48 int32; n must be 256. segments per bucket: a
// power of two up to 32; 0 takes accum_segments'. Returns
// cudaGetLastError() (0 on success).
extern "C" int lh_msm_accum_shaped(int segments, const void* sx,
                                   const void* sy, const void* idx,
                                   const void* valid, void* oX, void* oY,
                                   void* oZ, int L, int S, long long n,
                                   void* stream) {
  if (n != kLanes || L < 0) return (int)cudaErrorInvalidValue;
  if (segments == 0) segments = accum_segments(L);
  if (segments < 1 || segments > kMaxSegments || (segments & (segments - 1)))
    return (int)cudaErrorInvalidValue;
  accum_launch(sx, sy, idx, valid, oX, oY, oZ, L, S, segments, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K5 at accum_segments' segments (ops/msm.py accumulate).
extern "C" int lh_msm_accum(const void* sx, const void* sy, const void* idx,
                            const void* valid, void* oX, void* oY, void* oZ,
                            int L, int S, long long n, void* stream) {
  return lh_msm_accum_shaped(0, sx, sy, idx, valid, oX, oY, oZ, L, S, n, stream);
}

// The segments per bucket K5's launch takes for L rounds.
extern "C" int lh_msm_accum_segments(int L) { return accum_segments(L); }

// bX, bY, bZ, oX, oY, oZ: 256 x 2 x 48 int32; n must be 256.
extern "C" int lh_msm_tree(const void* bX, const void* bY, const void* bZ,
                           void* oX, void* oY, void* oZ, long long n,
                           void* stream) {
  if (n != kLanes) return (int)cudaErrorInvalidValue;
  msm_tree_kernel<<<kWindows, kWindowLanes * kTreeThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)bX, (const int4*)bY, (const int4*)bZ, (int4*)oX,
      (int4*)oY, (int4*)oZ);
  return (int)cudaGetLastError();
}

// tX, tY, tZ: 256 x 2 x 48 int32 (lanes 0-15 read); oX, oY, oZ: one lane,
// 2 x 48 int32 each; n must be 256.
extern "C" int lh_msm_horner(const void* tX, const void* tY, const void* tZ,
                             void* oX, void* oY, void* oZ, long long n,
                             void* stream) {
  if (n != kLanes) return (int)cudaErrorInvalidValue;
  msm_horner_kernel<<<1, kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)tX, (const int4*)tY, (const int4*)tZ, (int4*)oX, (int4*)oY,
      (int4*)oZ);
  return (int)cudaGetLastError();
}
