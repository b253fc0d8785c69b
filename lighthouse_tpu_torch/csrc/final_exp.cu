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
// K10 and K11 compute what their plain versions in ops/tkernel_calls.py
// compute, limb for limb; K9 what ops/coop.py easy_exp_plan computes,
// limb for limb, which is its plain version's value (easy_exp_plain, with
// Fermat's inversion) up to the representative in [0, 2p) of the one
// inverted Fp value, so equal to it after canonical. Chained, they equal
// ops/pairing.py final_exponentiation after canonical.
//
// What bounds them on an H100: the latency of a lane's dependent chain.
// A verify runs the chain on ONE lane (pairs are reduced to one Fp12 by
// fp12_tree_prod first), far too few lanes to fill the card's multiply
// throughput.
//
// K9 (262 Fp products and one inversion) is one block per lane (coop.cuh)
// running ops/coop.py easy_exp_plan: the norm program takes f down the
// tower's inversion formulas (fp12_inv, fp6_inv, fp2_inv) to the one Fp
// value to invert in 4 product rounds; one thread inverts it by fp.cuh's
// divstep GCD (1,110 divsteps in place of Fermat's ~608 dependent
// products) while the block waits at one barrier; the back program takes
// the inverse up to inv(f), conj(f) inv(f) and frobenius2(g) g in 9
// product rounds, the Frobenius constants in slots loaded from a shared
// input.
//
// K10 (63 Fp12 squarings and 5 products, ~2,540 Fp products) is one block
// per lane (coop.cuh) running ops/coop.py pow_x_plan(xm1): each squaring
// or product is a program whose 36 or 54 independent Fp products run in
// one round on 64 threads, with the additions around them in 11-12 further
// rounds. A lane is then 68 product rounds and ~810 add rounds deep (one
// thread: ~2,540 products in a row), and its time is those rounds times
// one round's latency.
//
// K11 (75-150 Fp products) is one block per lane (coop.cuh) running
// ops/coop.py comb_plan(mode), one program per mode in comb_plain's
// expression order: b 3 product rounds and 21 add rounds, c 6 and 42,
// final 3 and 34, where one thread ran the products in a row with the
// Fp12 values spilled to local memory. The wrapper picks the mode's plan;
// the Frobenius constants come from a shared input, as K9's do.

#include "coop.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

// f^((p^6-1)(p^2+1)) on the plan easy_exp_plan: one block per lane, the
// Frobenius constants (6 Fp) shared by the lanes.
__global__ void __launch_bounds__(kCoopThreads)
    easy_exp_kernel(const int4* __restrict__ f, const int4* __restrict__ consts,
                    const int16_t* __restrict__ prog, int4* __restrict__ out,
                    int prog_len) {
  coop::run_lane<true>(prog, prog_len, coop::Inputs{{f, consts}}, out,
                       blockIdx.x, false);
}

// f^x (ops/pairing.py _cyc_pow_x) for f in the cyclotomic subgroup, or
// f^(x-1) on the xm1 plan: one block per lane.
__global__ void __launch_bounds__(kCoopThreads)
    pow_x_kernel(const int4* __restrict__ f, const int16_t* __restrict__ prog,
                 int4* __restrict__ out, int prog_len) {
  coop::run_lane(prog, prog_len, coop::Inputs{{f}}, out, blockIdx.x, false);
}

// u frob(v), u frob2(v) conj(v) or u v^2 v on the plan comb_plan(mode):
// one block per lane, the Frobenius constants (6 Fp) shared by the lanes.
__global__ void __launch_bounds__(kCoopThreads)
    comb_kernel(const int4* __restrict__ u, const int4* __restrict__ v,
                const int4* __restrict__ consts,
                const int16_t* __restrict__ prog, int4* __restrict__ out,
                int prog_len) {
  coop::run_lane(prog, prog_len, coop::Inputs{{u, v, consts}}, out,
                 blockIdx.x, false);
}

}  // namespace

// f, u, v, out: n x 2 x 3 x 2 x 48 int32. Each returns cudaGetLastError().
// consts: ops/coop.py easy_exp_consts, 6 x 48 int32; prog: ops/coop.py
// pack(easy_exp_plan()), prog_len int16 values, and smem_bytes its
// shared_bytes.
extern "C" int lh_easy_exp(const void* f, const void* consts, const void* prog,
                           void* out, int smem_bytes, int prog_len, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  return coop::launch(easy_exp_kernel, n, smem_bytes, (cudaStream_t)stream,
                      (const int4*)f, (const int4*)consts, (const int16_t*)prog,
                      (int4*)out, prog_len);
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

// consts: ops/coop.py easy_exp_consts; prog: ops/coop.py
// pack(comb_plan(mode)) for the mode b, c or final, prog_len int16 values,
// and smem_bytes its shared_bytes.
extern "C" int lh_comb(const void* u, const void* v, const void* consts,
                       const void* prog, void* out, int smem_bytes,
                       int prog_len, long long n, void* stream) {
  if (n <= 0) return 0;
  return coop::launch(comb_kernel, n, smem_bytes, (cudaStream_t)stream,
                      (const int4*)u, (const int4*)v, (const int4*)consts,
                      (const int16_t*)prog, (int4*)out, prog_len);
}
