// The Jacobian group law on a group of threads of one warp (sm_90a), over
// Fp (G1) and Fp2 (G2): the doubling, the complete addition, the mixed
// addition, psi and the |x| walk. K3 (scalar_mul.cu), K4 and K15
// (subgroup_fast.cu), K5-K7 (msm.cu) and K12-K14 (htc.cuh) run on it.
//
// A group is some threads of one warp that run one chain: every thread
// holds every value of the chain and runs its additions; the Fp products
// that the chain can run side by side form a round, dealt out one per
// thread into the group's slots in shared memory, and every thread reads
// the round's results back after a __syncwarp over the group. So a
// condition on the chain's values (a point at infinity, P == Q, a scalar
// bit the whole group reads) is the same in every thread of the group and
// stays a branch that computes only the leg it keeps.
//
// Over Fp a product and a square are one Fp product each (tower.cuh sqr is
// mul(a, a)); over Fp2 a product is its three Karatsuba products and a
// square its two (tower.cuh mul, sqr). Each point operation follows its
// curve.cuh counterpart op for op, with its case order, on the lazy
// [0, 2p) values of fp.cuh, so its limbs equal curve.cuh's and the plain
// versions' (ops/points.py).

#pragma once

#include "curve.cuh"
#include "lanes.cuh"

namespace bls {

constexpr int kSlotVecs = kWords / 4;  // uint4 per Fp product slot
constexpr int kWarpSlots = kWarpThreads * kSlotVecs;  // uint4 of a warp's slots

// The threads that run one chain: this thread's index in the group, the
// group's lanes of the warp, and its kSize product slots in shared memory.
template <int kSize>
struct Group {
  int g;
  unsigned mask;
  uint4* slots;
};

// This thread's group of kSize consecutive threads of a block of one warp
// (kSize divides 32), on its kSize of the block's kWarpSlots slots.
template <int kSize>
__device__ __forceinline__ Group<kSize> sub_group(uint4* slots) {
  static_assert(kWarpThreads % kSize == 0, "a group divides the warp");
  const int k = threadIdx.x / kSize;
  const unsigned lanes = kSize == kWarpThreads ? 0xffffffffu : (1u << (kSize % kWarpThreads)) - 1;
  return {(int)(threadIdx.x % kSize), lanes << (kSize * k), slots + k * kSize * kSlotVecs};
}

// The whole warp of a block of one warp, on the block's kWarpSlots slots.
__device__ __forceinline__ Group<kWarpThreads> warp_group(uint4* slots) {
  return sub_group<kWarpThreads>(slots);
}

__device__ __forceinline__ void store_slot(uint4* slots, int s, const Fp& v) {
  uint4* d = slots + s * kSlotVecs;
#pragma unroll
  for (int k = 0; k < kSlotVecs; ++k)
    d[k] = make_uint4(v.w[4 * k], v.w[4 * k + 1], v.w[4 * k + 2], v.w[4 * k + 3]);
}

__device__ __forceinline__ Fp load_slot(const uint4* slots, int s) {
  const uint4* d = slots + s * kSlotVecs;
  Fp v;
#pragma unroll
  for (int k = 0; k < kSlotVecs; ++k) {
    const uint4 q = d[k];
    v.w[4 * k] = q.x;
    v.w[4 * k + 1] = q.y;
    v.w[4 * k + 2] = q.z;
    v.w[4 * k + 3] = q.w;
  }
  return v;
}

// Handles of a round's results: the slots of one Fp product, of an Fp2
// product's three Karatsuba products, of an Fp2 square's two.
struct ProdSlot { int s; };
struct MulSlot { int s; };
struct SqrSlot { int s; };

// One round: the Fp products declared on it go, in order, to threads 0, 1,
// ... of the group (at most kSize of them), run side by side, and land in
// the group's slots. A round is declared, run, and read before the next
// one runs (its first __syncwarp waits for the reads of the one before).
template <int kSize>
struct Round {
  const Group<kSize>& G;
  int n = 0;
  Fp x, y;  // this thread's operands

  __device__ __forceinline__ explicit Round(const Group<kSize>& grp) : G(grp) {}

  __device__ __forceinline__ ProdSlot prod(const Fp& a, const Fp& b) {
    if (G.g == n) {
      x = a;
      y = b;
    }
    return {n++};
  }
  // tower.cuh Fp mul and sqr: one product each
  __device__ __forceinline__ ProdSlot mul(const Fp& a, const Fp& b) {
    return prod(a, b);
  }
  __device__ __forceinline__ ProdSlot sqr(const Fp& a) { return prod(a, a); }
  // tower.cuh Fp2 mul: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1)
  __device__ __forceinline__ MulSlot mul(const Fp2& a, const Fp2& b) {
    const int s = prod(a.c0, b.c0).s;
    prod(a.c1, b.c1);
    prod(add(a.c0, a.c1), add(b.c0, b.c1));
    return {s};
  }
  // tower.cuh Fp2 sqr: (a0 + a1)(a0 - a1), a0 a1
  __device__ __forceinline__ SqrSlot sqr(const Fp2& a) {
    const int s = prod(add(a.c0, a.c1), sub(a.c0, a.c1)).s;
    prod(a.c0, a.c1);
    return {s};
  }

  __device__ __forceinline__ void run() {
    if (n > kSize) __trap();  // a round wider than its group
    __syncwarp(G.mask);
    if (G.g < n) store_slot(G.slots, G.g, bls::mul(x, y));
    __syncwarp(G.mask);
  }

  __device__ __forceinline__ Fp get(ProdSlot h) const {
    return load_slot(G.slots, h.s);
  }
  __device__ __forceinline__ Fp2 get(MulSlot h) const {
    const Fp t0 = load_slot(G.slots, h.s);
    const Fp t1 = load_slot(G.slots, h.s + 1);
    const Fp t2 = load_slot(G.slots, h.s + 2);
    return {sub(t0, t1), sub(sub(t2, t0), t1)};
  }
  __device__ __forceinline__ Fp2 get(SqrSlot h) const {
    return {load_slot(G.slots, h.s), dbl(load_slot(G.slots, h.s + 1))};
  }
};

// A round of one product or square.
template <int S, class F>
__device__ __forceinline__ F mul(const Group<S>& G, const F& a, const F& b) {
  Round<S> r(G);
  const auto h = r.mul(a, b);
  r.run();
  return r.get(h);
}
template <int S, class F>
__device__ __forceinline__ F sqr(const Group<S>& G, const F& a) {
  Round<S> r(G);
  const auto h = r.sqr(a);
  r.run();
  return r.get(h);
}

// ---------------------------------------------------------- group law

// curve.cuh pt_double, its products in four rounds.
template <int S, class F>
__device__ __noinline__ Jac<F> pt_double(const Group<S>& G, const Jac<F>& P) {
  F A, B, Zh, C, Sq;
  {
    Round<S> r(G);
    const auto h1 = r.sqr(P.X), h2 = r.sqr(P.Y);
    const auto h3 = r.mul(P.Y, P.Z);
    r.run();
    A = r.get(h1);
    B = r.get(h2);
    Zh = r.get(h3);
  }
  {
    Round<S> r(G);
    const auto h1 = r.sqr(B), h2 = r.sqr(add(P.X, B));
    r.run();
    C = r.get(h1);
    Sq = r.get(h2);
  }
  const F D = dbl(sub(sub(Sq, A), C));
  const F E = triple(A);
  const F X3 = sub(sqr(G, E), dbl(D));
  const F Y3 = sub(mul(G, E, sub(D, X3)), dbl(dbl(dbl(C))));
  return {X3, Y3, dbl(Zh)};
}

// curve.cuh pt_add, the complete addition with its case order (P at
// infinity -> Q, Q at infinity -> P, P == Q -> the doubling, P == -Q ->
// Z3 = 0), its products in six rounds.
template <int S, class F>
__device__ __noinline__ Jac<F> pt_add(const Group<S>& G, const Jac<F>& P,
                                      const Jac<F>& Q) {
  if (is_zero(P.Z)) return Q;
  if (is_zero(Q.Z)) return P;
  F Z1Z1, Z2Z2, U1, U2, T1, T2, S1, S2;
  {
    Round<S> r(G);
    const auto h1 = r.sqr(P.Z), h2 = r.sqr(Q.Z);
    r.run();
    Z1Z1 = r.get(h1);
    Z2Z2 = r.get(h2);
  }
  {
    Round<S> r(G);
    const auto h1 = r.mul(P.X, Z2Z2), h2 = r.mul(Q.X, Z1Z1);
    const auto h3 = r.mul(Q.Z, Z2Z2), h4 = r.mul(P.Z, Z1Z1);
    r.run();
    U1 = r.get(h1);
    U2 = r.get(h2);
    T1 = r.get(h3);
    T2 = r.get(h4);
  }
  {
    Round<S> r(G);
    const auto h1 = r.mul(P.Y, T1), h2 = r.mul(Q.Y, T2);
    r.run();
    S1 = r.get(h1);
    S2 = r.get(h2);
  }
  const F H = sub(U2, U1);
  const F rr0 = dbl(sub(S2, S1));
  if (is_zero(H) && is_zero(rr0)) return pt_double(G, P);
  F I, rr, ZS, J, V, Z3;
  {
    Round<S> r(G);
    const auto h1 = r.sqr(dbl(H)), h2 = r.sqr(rr0), h3 = r.sqr(add(P.Z, Q.Z));
    r.run();
    I = r.get(h1);
    rr = r.get(h2);
    ZS = r.get(h3);
  }
  {
    Round<S> r(G);
    const auto h1 = r.mul(H, I), h2 = r.mul(U1, I);
    const auto h3 = r.mul(sub(sub(ZS, Z1Z1), Z2Z2), H);
    r.run();
    J = r.get(h1);
    V = r.get(h2);
    Z3 = r.get(h3);
  }
  const F X3 = sub(sub(rr, J), dbl(V));
  F M, SJ;
  {
    Round<S> r(G);
    const auto h1 = r.mul(rr0, sub(V, X3)), h2 = r.mul(S1, J);
    r.run();
    M = r.get(h1);
    SJ = r.get(h2);
  }
  return {X3, sub(M, dbl(SJ)), Z3};
}

// curve.cuh pt_add_mixed: P (Jacobian) + (x2, y2) (affine, q_inf), with its
// case order (P at infinity -> (x2, y2, q_inf ? 0 : 1), q_inf -> P,
// P == Q -> the doubling), its products in six rounds.
template <int S, class F>
__device__ __noinline__ Jac<F> pt_add_mixed(const Group<S>& G, const Jac<F>& P,
                                            const F& x2, const F& y2,
                                            bool q_inf) {
  if (is_zero(P.Z)) return pt_from_affine(x2, y2, q_inf);  // inf + inf = inf
  if (q_inf) return P;
  const F Z1Z1 = sqr(G, P.Z);
  F U2, T;
  {
    Round<S> r(G);
    const auto h1 = r.mul(x2, Z1Z1), h2 = r.mul(P.Z, Z1Z1);
    r.run();
    U2 = r.get(h1);
    T = r.get(h2);
  }
  const F S2 = mul(G, y2, T);
  const F H = sub(U2, P.X);
  const F rr0 = dbl(sub(S2, P.Y));
  if (is_zero(H) && is_zero(rr0)) return pt_double(G, P);
  F I, HH, ZS, rr, J, V;
  {
    Round<S> r(G);
    const auto h1 = r.sqr(dbl(H)), h2 = r.sqr(H);
    const auto h3 = r.sqr(add(P.Z, H)), h4 = r.sqr(rr0);
    r.run();
    I = r.get(h1);
    HH = r.get(h2);
    ZS = r.get(h3);
    rr = r.get(h4);
  }
  {
    Round<S> r(G);
    const auto h1 = r.mul(H, I), h2 = r.mul(P.X, I);
    r.run();
    J = r.get(h1);
    V = r.get(h2);
  }
  const F X3 = sub(sub(rr, J), dbl(V));
  F M, YJ;
  {
    Round<S> r(G);
    const auto h1 = r.mul(rr0, sub(V, X3)), h2 = r.mul(P.Y, J);
    r.run();
    M = r.get(h1);
    YJ = r.get(h2);
  }
  return {X3, sub(M, dbl(YJ)), sub(sub(ZS, Z1Z1), HH)};  // Z3 = 2 Z1 H
}

// psi on Jacobian coordinates (ops/htc.py psi_jacobian).
template <int S>
__device__ __forceinline__ Jac<Fp2> psi(const Group<S>& G,
                                        const Jac<Fp2>& P) {
  Round<S> r(G);
  const MulSlot hx = r.mul(conj(P.X), fp2_const(kPsiCx));
  const MulSlot hy = r.mul(conj(P.Y), fp2_const(kPsiCy));
  r.run();
  return {r.get(hx), r.get(hy), conj(P.Z)};
}

// [|x|]Q: Q for the leading one, then per bit a doubling and, on a one
// bit, a complete addition of Q (ops/tkernel_htc.py _x_walk).
template <int S>
__device__ __noinline__ Jac<Fp2> x_walk(const Group<S>& G, const Jac<Fp2>& Q) {
  Jac<Fp2> acc = Q;
#pragma unroll 1
  for (int b = kXTopBit - 1; b >= 0; --b) {
    acc = pt_double(G, acc);
    if (x_bit(b)) acc = pt_add(G, acc, Q);
  }
  return acc;
}

}  // namespace bls
