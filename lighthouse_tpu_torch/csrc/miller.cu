// Kernel K8: the optimal-ate Miller loop, one lane per (P, Q) pair.
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
// What bounds it on an H100: integer multiplies. A lane is a dependent
// chain of ~7,100 Fp products against 1,154 B read and 2,304 B written.
//
// What the design does about it: one thread per lane, f (144 words), T and
// the line in registers and local memory; lanes at infinity skip the loop.
// At the verify path's 129 lanes it fills 5 of 132 SMs with one warp each;
// a warp per lane with limb-parallel products is later work.

#include "curve.cuh"
#include "lanes.cuh"

namespace {

using namespace bls;

struct Line {
  Fp2 A, B, C;  // l = A + B xp w^2 + C yp w^3 (ops/pairing.py _embed_line)
};

// Double T; the line through T scaled by 2YZ^3 (ops/pairing.py _dbl_step).
__device__ __noinline__ Jac<Fp2> dbl_step(const Jac<Fp2>& T, Line& l) {
  const Fp2 A = sqr(T.X);
  const Fp2 B = sqr(T.Y);
  const Fp2 Zh = mul(T.Y, T.Z);
  const Fp2 Zsq = sqr(T.Z);
  const Fp2 C = sqr(B);
  const Fp2 S = sqr(add(T.X, B));
  const Fp2 D = dbl(sub(sub(S, A), C));
  const Fp2 E = triple(A);
  const Fp2 X3 = sub(sqr(E), dbl(D));
  const Fp2 Z3 = dbl(Zh);
  const Fp2 Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))));
  l.A = sub(mul(E, T.X), dbl(B));
  l.B = neg(mul(E, Zsq));
  l.C = mul(Z3, Zsq);
  return {X3, Y3, Z3};
}

// T + (xq, yq); the line through them scaled by 2ZH (ops/pairing.py
// _add_step, madd-2007-bl).
__device__ __noinline__ Jac<Fp2> add_step(const Jac<Fp2>& T, const Fp2& xq,
                                          const Fp2& yq, Line& l) {
  const Fp2 Z1Z1 = sqr(T.Z);
  const Fp2 U2 = mul(xq, Z1Z1);
  const Fp2 S2 = mul(yq, mul(T.Z, Z1Z1));
  const Fp2 H = sub(U2, T.X);
  const Fp2 r = dbl(sub(S2, T.Y));
  const Fp2 I = sqr(dbl(H));
  const Fp2 HH = sqr(H);
  const Fp2 ZS = sqr(add(T.Z, H));
  const Fp2 rr = sqr(r);
  const Fp2 J = mul(H, I);
  const Fp2 V = mul(T.X, I);
  const Fp2 X3 = sub(sub(rr, J), dbl(V));
  const Fp2 Z3 = sub(sub(ZS, Z1Z1), HH);
  const Fp2 Y3 = sub(mul(r, sub(V, X3)), dbl(mul(T.Y, J)));
  l.A = sub(mul(r, xq), mul(Z3, yq));
  l.B = neg(r);
  l.C = Z3;
  return {X3, Y3, Z3};
}

// f * l with l kept sparse: slots (c0.c0, c0.c1, c1.c1) = (A, B xp, C yp)
// (tkernel_pairing _mul_line_sparse).
__device__ __noinline__ Fp12 mul_line_sparse(const Fp12& f, const Line& l,
                                             const Fp& xp, const Fp& yp) {
  const Fp2 bxp = mul_fp(l.B, xp);
  const Fp2 cyp = mul_fp(l.C, yp);
  const Fp6 &f0 = f.c[0], &f1 = f.c[1];
  const Fp6 fs = add(f0, f1);
  const Fp2 Bc = add(bxp, cyp);
  // f0 * (A + bxp v)
  const Fp2 m0 = mul(f0.c[0], l.A);
  const Fp2 m1 = mul(f0.c[1], bxp);
  const Fp2 mx = mul(add(f0.c[0], f0.c[1]), add(l.A, bxp));
  const Fp2 mu = mul(f0.c[2], bxp);
  const Fp2 mv = mul(f0.c[2], l.A);
  // f1 * (cyp v)
  const Fp2 w2 = mul(f1.c[2], cyp);
  const Fp2 w0 = mul(f1.c[0], cyp);
  const Fp2 w1 = mul(f1.c[1], cyp);
  // (f0 + f1) * (A + (bxp + cyp) v)
  const Fp2 n0 = mul(fs.c[0], l.A);
  const Fp2 n1 = mul(fs.c[1], Bc);
  const Fp2 nx = mul(add(fs.c[0], fs.c[1]), add(l.A, Bc));
  const Fp2 nu = mul(fs.c[2], Bc);
  const Fp2 nv = mul(fs.c[2], l.A);
  const Fp6 t0 = {{add(m0, mul_by_xi(mu)), sub(sub(mx, m0), m1), add(m1, mv)}};
  const Fp6 t1 = {{mul_by_xi(w2), w0, w1}};
  const Fp6 ts = {{add(n0, mul_by_xi(nu)), sub(sub(nx, n0), n1), add(n1, nv)}};
  return {{add(t0, mul_by_v(t1)), sub(sub(ts, t0), t1)}};
}

__global__ void __launch_bounds__(kLaneThreads)
    miller_kernel(const int4* __restrict__ xp, const int4* __restrict__ yp,
                  const uint8_t* __restrict__ p_inf,
                  const int4* __restrict__ xq, const int4* __restrict__ yq,
                  const uint8_t* __restrict__ q_inf, int4* __restrict__ out,
                  long long n) {
  const long long i = lane_index();
  if (i >= n) return;
  Fp12 f = one(Fp12());
  if (!p_inf[i] && !q_inf[i]) {
    Fp px, py;
    Fp2 qx, qy;
    load(px, xp + i * kWords);
    load(py, yp + i * kWords);
    load(qx, xq + i * 2 * kWords);
    load(qy, yq + i * 2 * kWords);
    Jac<Fp2> T = pt_from_affine(qx, qy, false);
    Line l;
#pragma unroll 1
    for (int b = kXTopBit - 1; b >= 0; --b) {
      f = sqr(f);
      T = dbl_step(T, l);
      f = mul_line_sparse(f, l, px, py);
      if (x_bit(b)) {
        T = add_step(T, qx, qy, l);
        f = mul_line_sparse(f, l, px, py);
      }
    }
    f = conj(f);  // x < 0
  }
  store(out + i * 12 * kWords, f);
}

}  // namespace

// xp, yp: n x 48 int32; xq, yq: n x 2 x 48 int32; p_inf, q_inf: n bytes;
// out: n x 2 x 3 x 2 x 48 int32. Returns cudaGetLastError().
extern "C" int lh_miller(const void* xp, const void* yp, const void* p_inf,
                         const void* xq, const void* yq, const void* q_inf,
                         void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  miller_kernel<<<lane_blocks(n), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)xp, (const int4*)yp, (const uint8_t*)p_inf,
      (const int4*)xq, (const int4*)yq, (const uint8_t*)q_inf, (int4*)out, n);
  return (int)cudaGetLastError();
}
