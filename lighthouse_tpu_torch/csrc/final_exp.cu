// Kernels K9, K10, K11: the final exponentiation f^(3(p^12-1)/r), as the
// three entry points of the 9-launch chain of ops/tkernel_calls.py
// final_exp_kernel (easy part, 5 x-powers, 3 combinations).
//
// Replace the Pallas TPU kernels of lighthouse_tpu/ops/tkernel_calls.py,
// all launched through the pallas_call at :437:
//   K9  :390 _easy_exp_kernel   f^((p^6-1)(p^2+1))
//   K10 :398 _pow_kernel(xm1)   the cyclotomic f^x on |x|'s bit layout,
//                               times conj(f) when xm1 (f^(x-1))
//   K11 :410 _comb_kernel(mode) b: u frob(v); c: u frob2(v) conj(v);
//                               final: u v^2 v
// Each computes what its plain version in ops/tkernel_calls.py computes,
// limb for limb; chained, they equal ops/pairing.py final_exponentiation.
//
// What bounds them on an H100: the latency of a lane's dependent chain.
// A verify runs the chain on ONE lane (pairs are reduced to one Fp12 by
// fp12_tree_prod first), far too few lanes to fill the card's multiply
// throughput. K9 (~870 Fp products with an inversion) and K11 (75-150)
// run one thread per lane, the Fp12 values in registers and local memory.
//
// K10 (63 Fp12 squarings and 5 products, ~2,540 Fp products) is one block
// per lane (coop.cuh) running ops/coop.py pow_x_plan(xm1): each squaring
// or product is a program whose 36 or 54 independent Fp products run in
// one round on 64 threads, with the additions around them in 11-12 further
// rounds. A lane is then 68 product rounds and ~810 add rounds deep (one
// thread: ~2,540 products in a row), and its time is those rounds times
// one round's latency.

#include "coop.cuh"
#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

constexpr int W12 = 12 * kWords;  // int4 per Fp12 value

__global__ void __launch_bounds__(kLaneThreads)
    easy_exp_kernel(const int4* __restrict__ f, int4* __restrict__ out,
                    long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 a;
  load(a, f + i * W12);
  const Fp12 g = mul(conj(a), inv(a));  // f^(p^6 - 1)
  store(out + i * W12, mul(frobenius2(g), g));
}

// f^x (ops/pairing.py _cyc_pow_x) for f in the cyclotomic subgroup, or
// f^(x-1) on the xm1 plan: one block per lane.
__global__ void __launch_bounds__(kCoopThreads)
    pow_x_kernel(const int4* __restrict__ f, const int16_t* __restrict__ prog,
                 int4* __restrict__ out, int prog_len) {
  coop::run_lane(prog, prog_len, coop::Inputs{{f}}, out, blockIdx.x, false);
}

__global__ void __launch_bounds__(kLaneThreads)
    comb_kernel(const int4* __restrict__ u, const int4* __restrict__ v,
                int4* __restrict__ out, int mode, long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 a, b;
  load(a, u + i * W12);
  load(b, v + i * W12);
  Fp12 r;
  if (mode == 0) {
    r = mul(a, frobenius(b));
  } else if (mode == 1) {
    r = mul(mul(a, frobenius2(b)), conj(b));
  } else {
    r = mul(mul(a, sqr(b)), b);
  }
  store(out + i * W12, r);
}

}  // namespace

// f, u, v, out: n x 2 x 3 x 2 x 48 int32. Each returns cudaGetLastError().
extern "C" int lh_easy_exp(const void* f, void* out, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  easy_exp_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)f, (int4*)out, n);
  return (int)cudaGetLastError();
}

// prog: ops/coop.py pack(pow_x_plan(xm1)), prog_len int16 values, and
// smem_bytes its shared_bytes.
extern "C" int lh_pow_x(const void* f, const void* prog, void* out,
                        int smem_bytes, int prog_len, long long n,
                        void* stream) {
  if (n <= 0) return 0;
  return coop::launch(pow_x_kernel, n, smem_bytes, (cudaStream_t)stream,
                      (const int4*)f, (const int16_t*)prog, (int4*)out,
                      prog_len);
}

// mode: 0 = b, 1 = c, 2 = final.
extern "C" int lh_comb(const void* u, const void* v, void* out, int mode,
                       long long n, void* stream) {
  if (n <= 0) return 0;
  comb_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)u, (const int4*)v, (int4*)out, mode, n);
  return (int)cudaGetLastError();
}
