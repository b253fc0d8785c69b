// Kernel K8: the optimal-ate Miller loop, one block per (P, Q) pair.
//
// Replaces the Pallas TPU kernel lighthouse_tpu/ops/tkernel_calls.py:326
// _miller_kernel (pallas_call at :357), whose body is
// lighthouse_tpu/ops/tkernel_pairing.py miller_loop_t in its default
// (non-lazy) form. Computes what ops/tkernel_pairing.py miller_loop_seg
// computes: f = 1, T = Q; for each bit of |x| below the leading one,
// f = f^2, the doubling step and its line, and on a one bit the mixed
// addition step and its line, each line multiplied into f sparsely (13 Fp2
// products, not a dense Fp12 product). Then f = conj(f) because x < 0, and
// f = 1 for a lane with P or Q at infinity.
//
// What bounds it on an H100: the latency of a lane's dependent chain. A
// lane is ~7,100 Fp products against 1,154 B read and 2,304 B written,
// and the verify gives 129 lanes: one per SM would leave the card's
// multiply throughput almost idle whatever the kernel does inside a lane.
//
// What the design does about it: one block of 64 threads per lane
// (coop.cuh) running ops/coop.py miller_plan: f, T, P and Q in
// shared-memory slots, and a doubling bit and an addition bit each a
// program (miller_dbl, miller_add) whose independent Fp products run side
// by side, f^2's 36 beside the doubling step's first 9, so a doubling bit
// is 4 product rounds and an addition bit 5, where one thread ran ~110 and
// ~90 products in a row. A lane is 277 product rounds and ~2,150 add
// rounds deep; lanes at infinity skip the loop and store f = 1.

#include "coop.cuh"
#include "lanes.cuh"

namespace {

__global__ void __launch_bounds__(bls::kCoopThreads)
    miller_kernel(coop::Inputs in, const uint8_t* __restrict__ p_inf,
                  const uint8_t* __restrict__ q_inf,
                  const int16_t* __restrict__ prog, int4* __restrict__ out,
                  int prog_len) {
  const long long i = blockIdx.x;
  coop::run_lane(prog, prog_len, in, out, i, p_inf[i] || q_inf[i]);
}

}  // namespace

// xp, yp: n x 48 int32; xq, yq: n x 2 x 48 int32; p_inf, q_inf: n bytes;
// prog: ops/coop.py pack(miller_plan()), prog_len int16 values, and
// smem_bytes its shared_bytes; out: n x 2 x 3 x 2 x 48 int32. Returns
// cudaGetLastError().
extern "C" int lh_miller(const void* xp, const void* yp, const void* p_inf,
                         const void* xq, const void* yq, const void* q_inf,
                         const void* prog, void* out, int smem_bytes,
                         int prog_len, long long n, void* stream) {
  if (n <= 0) return 0;
  const coop::Inputs in = {{(const int4*)xp, (const int4*)yp,
                            (const int4*)xq, (const int4*)yq}};
  return coop::launch(miller_kernel, n, smem_bytes, (cudaStream_t)stream, in,
                      (const uint8_t*)p_inf, (const uint8_t*)q_inf,
                      (const int16_t*)prog, (int4*)out, prog_len);
}
