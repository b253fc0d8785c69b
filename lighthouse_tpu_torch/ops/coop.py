"""Straight-line Fp programs for the block-per-lane kernels K8-K11.

A lane-step of the Miller loop (one bit of |x|), of the cyclotomic
x-power (a squaring, a product) or of the easy part of the final
exponentiation (the norm down to one Fp value, and back from its inverse)
or of the hard part's combinations (K11's three modes) is written out here as a list of Fp operations on numbered slots, each
``(op, dst, a, b)`` with op one of ``MUL``, ``ADD``, ``SUB``, ``NEG``. The
operations are those of the plain versions' expression trees, op for op:
the Karatsuba terms and the inversion formulas of ``ops/tower.py``, the
doubling and addition steps of ``ops/pairing.py``, the sparse line product
of ``ops/tkernel_pairing.py``, each add and sub with the same operands in
the same order. So a program gives the plain version's limbs exactly,
whoever runs each operation.

The operations are grouped into rounds: no operation of a round reads a
slot that another operation of the round writes, and no two write one
slot. A kernel block (``csrc/coop.cuh``) runs a round's operations on its
threads side by side and meets at a barrier before the next round. The
schedule keeps the products few rounds deep: a product runs in round
``k`` of the products when the longest chain of products into it has ``k``
of them, and the additions between two product rounds take as many rounds
as their longest chain there. A program's first inputs sit in fixed slots
that its outputs overwrite (each write after every read of the old
value), so a kernel runs the step again on its own output; the other
values share the remaining slots by lifetime, and only the fixed slots
carry a value from one step to the next.

A :class:`Plan` is all a kernel's block does for its lane: the loads
that fill the fixed slots from the kernel's inputs (or constants), the
programs and the order of their steps (one per bit of |x|, or K9's norm,
inversion and back-substitution), and the slots it stores. An inversion
step is no program: one thread inverts one fixed slot in place with
``csrc/fp.cuh`` ``fp_inv_gcd`` (a divstep GCD), the block waiting at a
barrier; :func:`invert_model` gives its representative exactly.
:func:`to_device` packs a plan into the ``int16`` tensor the kernel reads,
cached per device, so the kernel's source names no slot, program or bit.
:func:`run_program` runs a program on CPU tensors with the port's
``ops/field.py`` operations, one call per operation kind and round, and
:func:`run_plan` a whole plan: the plain model of what a block does.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto.bls.constants import P
from . import field
from .field import const
from .points import X_BITS
from .tower import FP2_ONE, FROB6_C1, FROB6_C2, FROB12_C1

MUL, ADD, SUB, NEG = 0, 1, 2, 3
_COMMUTES = (MUL, ADD)

# Threads per block (one lane) of K8-K11 (csrc/lanes.cuh kCoopThreads):
# a round's operations are dealt to them in turn.
THREADS = 64

# Fixed slots. K10: the accumulator and the base f, 12 Fp each (the
# [2, 3, 2] coefficients in order). K8: f, then T = (X, Y, Z), then P's
# (xp, yp) and Q's (xq, yq). K9: f (and its output), fp6_inv's t (3 Fp2),
# fp2_inv's input d and its norm, inverted in place, then the Frobenius
# constants FROB6_C1, FROB6_C2, FROB12_C1. K11: u (and the output), v,
# then the same Frobenius constants.
POW_ACC, POW_BASE = 0, 12
MIL_F, MIL_T, MIL_XP, MIL_YP, MIL_XQ, MIL_YQ = 0, 12, 18, 19, 20, 22
N_FIXED = 24
EXP_F, EXP_T, EXP_D, EXP_N, EXP_C = 0, 12, 18, 20, 21
EXP_FIXED = 27
COMB_U, COMB_V, COMB_C = 0, 12, 24
COMB_FIXED = 30

# Program indices: K10's pow_x_programs(), K8's miller_programs(), K9's
# easy_exp_programs().
POW_SQR, POW_MUL, POW_CONJ_MUL = 0, 1, 2
MIL_DBL, MIL_ADD = 0, 1
EXP_NORM, EXP_BACK = 0, 1


# ---------------------------------------------------------------- tracing


class _Trace:
    """Records Fp operations on symbolic values. Values below ``n_fixed``
    are the fixed slots; operation ``i`` makes value ``n_fixed + i``.
    An operation already recorded with the same operands is not recorded
    twice (the stacked plain versions compute some sums more than once:
    the same limbs)."""

    def __init__(self, n_fixed: int = N_FIXED):
        self.n_fixed = n_fixed
        self.ops: list[tuple[int, int, int]] = []
        self._seen: dict[tuple[int, int, int], int] = {}

    def _op(self, kind: int, a: int, b: int) -> int:
        key = (kind, *sorted((a, b))) if kind in _COMMUTES else (kind, a, b)
        if key not in self._seen:
            self.ops.append((kind, a, b))
            self._seen[key] = self.n_fixed + len(self.ops) - 1
        return self._seen[key]

    def mul(self, a, b):
        return self._op(MUL, a, b)

    def add(self, a, b):
        return self._op(ADD, a, b)

    def sub(self, a, b):
        return self._op(SUB, a, b)

    def neg(self, a):
        return self._op(NEG, a, a)


# Tower values are nested tuples of value ids: Fp2 (c0, c1), Fp6 three Fp2,
# Fp12 two Fp6, in the order of the torch layout's axes.


def _each(fn, *xs):
    if isinstance(xs[0], tuple):
        return tuple(_each(fn, *ys) for ys in zip(*xs))
    return fn(*xs)


def _fixed(start: int, shape) -> tuple:
    """Nested tuple of consecutive fixed slots: shape (2,) is an Fp2,
    (3, 2) an Fp6, (2, 3, 2) an Fp12."""
    if not shape:
        return start
    step = int(np.prod(shape[1:], dtype=np.int64))
    return tuple(_fixed(start + i * step, shape[1:]) for i in range(shape[0]))


def _flat(x) -> list[int]:
    return [v for y in x for v in _flat(y)] if isinstance(x, tuple) else [x]


class _Tower:
    """ops/tower.py, ops/pairing.py and ops/tkernel_pairing.py on a trace."""

    def __init__(self, t: _Trace):
        self.t = t

    def add(self, a, b):
        return _each(self.t.add, a, b)

    def sub(self, a, b):
        return _each(self.t.sub, a, b)

    def neg(self, a):
        return _each(self.t.neg, a)

    def dbl(self, a):
        return self.add(a, a)

    # Fp2
    def fp2_mul(self, a, b):
        t = self.t
        sa, sb = t.add(a[0], a[1]), t.add(b[0], b[1])
        t0, t1, t2 = t.mul(a[0], b[0]), t.mul(a[1], b[1]), t.mul(sa, sb)
        return (t.sub(t0, t1), t.sub(t.sub(t2, t0), t1))

    def fp2_sqr(self, a):
        t = self.t
        s, d = t.add(a[0], a[1]), t.sub(a[0], a[1])
        m = t.mul(a[0], a[1])
        return (t.mul(s, d), t.add(m, m))

    def fp2_mul_fp(self, a, k):
        return (self.t.mul(a[0], k), self.t.mul(a[1], k))

    def fp2_conj(self, a):
        return (a[0], self.t.neg(a[1]))

    def xi(self, a):
        return (self.t.sub(a[0], a[1]), self.t.add(a[0], a[1]))

    def fp2_norm(self, a):
        """fp2_inv's c0^2 + c1^2, the one Fp value it inverts."""
        return self.t.add(self.t.mul(a[0], a[0]), self.t.mul(a[1], a[1]))

    def fp2_inv_back(self, a, norm_inv):
        """fp2_inv from its norm's inverse: (c0 ni, -c1 ni)."""
        return (self.t.mul(a[0], norm_inv), self.t.mul(self.t.neg(a[1]), norm_inv))

    # Fp6
    def fp6_mul(self, a, b):
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0, t1, t2 = self.fp2_mul(a0, b0), self.fp2_mul(a1, b1), self.fp2_mul(a2, b2)
        s12 = self.fp2_mul(self.add(a1, a2), self.add(b1, b2))
        s01 = self.fp2_mul(self.add(a0, a1), self.add(b0, b1))
        s02 = self.fp2_mul(self.add(a0, a2), self.add(b0, b2))
        u0 = self.sub(self.sub(s12, t1), t2)
        u1 = self.sub(self.sub(s01, t0), t1)
        u2 = self.sub(self.sub(s02, t0), t2)
        return (self.add(self.xi(u0), t0), self.add(u1, self.xi(t2)),
                self.add(u2, t1))

    def v(self, a):
        return (self.xi(a[2]), a[0], a[1])

    def fp6_inv_norm(self, a):
        """fp6_inv down to its Fp2 denominator: (t, denom), the inverse
        being t denom^-1."""
        c0, c1, c2 = a
        m = self.fp2_mul
        a_sq, bc, c_sq, ab, b_sq, ac = (m(c0, c0), m(c1, c2), m(c2, c2),
                                        m(c0, c1), m(c1, c1), m(c0, c2))
        t = (self.sub(a_sq, self.xi(bc)), self.sub(self.xi(c_sq), ab),
             self.sub(b_sq, ac))
        n0, n1, n2 = m(c0, t[0]), m(c2, t[1]), m(c1, t[2])
        return t, self.add(n0, self.xi(self.add(n1, n2)))

    def fp6_frobenius(self, a, k1, k2):
        c0, c1, c2 = (self.fp2_conj(x) for x in a)
        return (c0, self.fp2_mul(c1, k1), self.fp2_mul(c2, k2))

    # Fp12
    def fp12_mul(self, a, b):
        sa, sb = self.add(a[0], a[1]), self.add(b[0], b[1])
        t0, t1 = self.fp6_mul(a[0], b[0]), self.fp6_mul(a[1], b[1])
        s = self.fp6_mul(sa, sb)
        return (self.add(t0, self.v(t1)), self.sub(self.sub(s, t0), t1))

    def fp12_sqr(self, a):
        a0, a1 = a
        s0, s1 = self.add(a0, a1), self.add(a0, self.v(a1))
        t0, s = self.fp6_mul(a0, a1), self.fp6_mul(s0, s1)
        return (self.sub(self.sub(s, t0), self.v(t0)), self.add(t0, t0))

    def fp12_conj(self, a):
        return (a[0], self.neg(a[1]))

    def fp12_inv_norm(self, a):
        """fp12_inv down to fp6_inv's denominator: (t, d)."""
        a0, a1 = a
        denom = self.sub(self.fp6_mul(a0, a0), self.v(self.fp6_mul(a1, a1)))
        return self.fp6_inv_norm(denom)

    def fp12_inv_back(self, a, t, d_inv):
        """fp12_inv from the inverse of fp6_inv's denominator."""
        d6 = tuple(self.fp2_mul(ti, d_inv) for ti in t)
        return (self.fp6_mul(a[0], d6), self.neg(self.fp6_mul(a[1], d6)))

    def fp12_frobenius(self, a, k6_1, k6_2, k12):
        f1 = self.fp6_frobenius(a[1], k6_1, k6_2)
        return (self.fp6_frobenius(a[0], k6_1, k6_2),
                tuple(self.fp2_mul(x, k12) for x in f1))

    # Miller loop
    def dbl_step(self, T):
        X, Y, Z = T
        A, B = self.fp2_sqr(X), self.fp2_sqr(Y)
        Zh, Zsq = self.fp2_mul(Y, Z), self.fp2_sqr(Z)
        C, S = self.fp2_sqr(B), self.fp2_sqr(self.add(X, B))
        D = self.dbl(self.sub(self.sub(S, A), C))
        E = self.add(self.dbl(A), A)
        F, EX, EZ = self.fp2_sqr(E), self.fp2_mul(E, X), self.fp2_mul(E, Zsq)
        X3 = self.sub(F, self.dbl(D))
        Z3 = self.dbl(Zh)
        Y3a, lC = self.fp2_mul(E, self.sub(D, X3)), self.fp2_mul(Z3, Zsq)
        Y3 = self.sub(Y3a, self.dbl(self.dbl(self.dbl(C))))
        lA = self.sub(EX, self.dbl(B))
        return (X3, Y3, Z3), (lA, self.neg(EZ), lC)

    def add_step(self, T, xq, yq):
        X1, Y1, Z1 = T
        Z1Z1 = self.fp2_sqr(Z1)
        U2, Tz = self.fp2_mul(xq, Z1Z1), self.fp2_mul(Z1, Z1Z1)
        S2 = self.fp2_mul(yq, Tz)
        H = self.sub(U2, X1)
        r = self.dbl(self.sub(S2, Y1))
        H2, Z1H = self.dbl(H), self.add(Z1, H)
        I, HH = self.fp2_sqr(H2), self.fp2_sqr(H)
        ZS, rr = self.fp2_sqr(Z1H), self.fp2_sqr(r)
        J, V = self.fp2_mul(H, I), self.fp2_mul(X1, I)
        X3 = self.sub(self.sub(rr, J), self.dbl(V))
        Z3 = self.sub(self.sub(ZS, Z1Z1), HH)
        Y3a, Y3b = self.fp2_mul(r, self.sub(V, X3)), self.fp2_mul(Y1, J)
        lA1, lA2 = self.fp2_mul(r, xq), self.fp2_mul(Z3, yq)
        Y3 = self.sub(Y3a, self.dbl(Y3b))
        return (X3, Y3, Z3), (self.sub(lA1, lA2), self.neg(r), Z3)

    def mul_line_sparse(self, f, line, xp, yp):
        A, B, C = line
        bxp, cyp = self.fp2_mul_fp(B, xp), self.fp2_mul_fp(C, yp)
        (f00, f01, f02), (g0, g1, g2) = f
        s0, s1, s2 = self.add(f[0], f[1])
        Bc = self.add(bxp, cyp)
        m = self.fp2_mul
        m0, m1 = m(f00, A), m(f01, bxp)
        mx = m(self.add(f00, f01), self.add(A, bxp))
        mu, mv = m(f02, bxp), m(f02, A)
        w2, w0, w1 = m(g2, cyp), m(g0, cyp), m(g1, cyp)
        n0, n1 = m(s0, A), m(s1, Bc)
        nx = m(self.add(s0, s1), self.add(A, Bc))
        nu, nv = m(s2, Bc), m(s2, A)
        t0 = (self.add(m0, self.xi(mu)), self.sub(self.sub(mx, m0), m1),
              self.add(m1, mv))
        t1 = (self.xi(w2), w0, w1)
        ts = (self.add(n0, self.xi(nu)), self.sub(self.sub(nx, n0), n1),
              self.add(n1, nv))
        return (self.add(t0, self.v(t1)), self.sub(self.sub(ts, t0), t1))


# ------------------------------------------------------------- scheduling


@dataclass(frozen=True)
class Program:
    """A scheduled lane-step: ``rounds[r]`` is an int array [k, 4] of
    (op, dst, a, b) slot operations, products first; ``n_slots`` the slots
    it touches. ``product_rounds`` and ``add_rounds`` count the rounds with
    and without a product."""

    name: str
    rounds: tuple
    n_slots: int

    @property
    def product_rounds(self) -> int:
        return sum(bool((r[:, 0] == MUL).any()) for r in self.rounds)

    @property
    def add_rounds(self) -> int:
        return len(self.rounds) - self.product_rounds

    @property
    def products(self) -> int:
        return sum(int((r[:, 0] == MUL).sum()) for r in self.rounds)


def _schedule(name: str, t: _Trace, outputs: dict[int, int]) -> Program:
    """Rounds and slots for the trace's operations; ``outputs`` maps a
    fixed slot to the value written there."""
    n, nf = len(t.ops), t.n_fixed
    made = {v: s for s, v in outputs.items()}
    if len(made) != len(outputs) or any(v < nf for v in made):
        raise ValueError(f"{name}: each output must be a distinct computed value")
    # stage: products on the longest chain into a value; depth: operations
    # of that stage on the longest chain (products have depth 0)
    stage = [0] * (nf + n)
    depth = [0] * (nf + n)
    for i, (kind, a, b) in enumerate(t.ops):
        v = nf + i
        stage[v] = max(stage[a], stage[b]) + (kind == MUL)
        if kind != MUL:
            depth[v] = 1 + max(depth[u] for u in (a, b) if stage[u] == stage[v])
    n_stages = max(stage[nf:]) + 1
    adds = [0] * n_stages
    for v in range(nf, nf + n):
        adds[stage[v]] = max(adds[stage[v]], depth[v])
    # round index: stage k's adds follow its product round
    first = []
    r = 0
    for k in range(n_stages):
        first.append(r)
        r += (k > 0) + adds[k]
    n_rounds = r
    rnd = [0] * n
    for i in range(n):
        v = nf + i
        k = stage[v]
        rnd[i] = first[k] + (depth[v] - 1 if k == 0 else depth[v])
    # every read of a fixed slot precedes the output write that replaces it
    last_read = [-1] * (nf + n)
    for i, (_, a, b) in enumerate(t.ops):
        for u in (a, b):
            last_read[u] = max(last_read[u], rnd[i])
    for s, v in outputs.items():
        if rnd[v - nf] <= last_read[s]:
            raise ValueError(f"{name}: output slot {s} is written before its "
                             f"last read")
    # slots: outputs in place; other values reuse a slot freed in an
    # earlier round
    slot = list(range(nf)) + [-1] * n
    order = sorted(range(n), key=lambda i: rnd[i])
    free: list[int] = []
    releases: dict[int, list[int]] = {}
    used = nf
    for i in order:
        v = nf + i
        for rr in sorted(k for k in releases if k < rnd[i]):
            free.extend(releases.pop(rr))
        if v in made:
            slot[v] = made[v]
        elif free:
            slot[v] = free.pop()
        else:
            slot[v] = used
            used += 1
        if v not in made:
            releases.setdefault(max(last_read[v], rnd[i]), []).append(slot[v])
    rounds = [[] for _ in range(n_rounds)]
    for i, (kind, a, b) in enumerate(t.ops):
        rounds[rnd[i]].append((kind, slot[nf + i], slot[a], slot[b]))
    return Program(
        name=name,
        rounds=tuple(np.array(sorted(r, key=lambda o: o[0] != MUL), np.int64).reshape(-1, 4)
                     for r in rounds),
        n_slots=used,
    )


def check_rounds(p: Program) -> None:
    """Raise unless every round of ``p`` reads no slot that it writes and
    writes no slot twice, and every slot lies below ``p.n_slots``."""
    for r, ops in enumerate(p.rounds):
        dst = ops[:, 1].tolist()
        if len(set(dst)) != len(dst):
            raise AssertionError(f"{p.name} round {r}: a slot written twice")
        if set(dst) & set(ops[:, 2:].ravel().tolist()):
            raise AssertionError(f"{p.name} round {r}: a slot read and written")
        if ops.size and (ops[:, 1:].max() >= p.n_slots or ops[:, 1:].min() < 0):
            raise AssertionError(f"{p.name} round {r}: a slot out of range")


# ------------------------------------------------------------ the programs


def _program(name: str, body, n_fixed: int = N_FIXED) -> Program:
    t = _Trace(n_fixed)
    outputs = body(_Tower(t))
    return _schedule(name, t, {s: v for s, v in outputs})


def _outputs(start: int, value) -> list[tuple[int, int]]:
    return list(enumerate(_flat(value), start))


def _fp12(start):
    return _fixed(start, (2, 3, 2))


@functools.cache
def pow_x_programs() -> tuple[Program, ...]:
    """K10's steps: acc = acc^2; acc = acc f; acc = conj(acc) conj(f)."""
    acc, base = _fp12(POW_ACC), _fp12(POW_BASE)
    return (
        _program("fp12_sqr", lambda w: _outputs(POW_ACC, w.fp12_sqr(acc))),
        _program("fp12_mul", lambda w: _outputs(POW_ACC, w.fp12_mul(acc, base))),
        _program("conj_mul", lambda w: _outputs(
            POW_ACC, w.fp12_mul(w.fp12_conj(acc), w.fp12_conj(base)))),
    )


def _miller_inputs():
    T = tuple(_fixed(MIL_T + 2 * i, (2,)) for i in range(3))
    return (_fp12(MIL_F), T, MIL_XP, MIL_YP, _fixed(MIL_XQ, (2,)),
            _fixed(MIL_YQ, (2,)))


def _miller_dbl(w: _Tower):
    f, T, xp, yp, _, _ = _miller_inputs()
    f2 = w.fp12_sqr(f)
    T2, line = w.dbl_step(T)
    return _outputs(MIL_F, w.mul_line_sparse(f2, line, xp, yp)) + _outputs(MIL_T, T2)


def _miller_add(w: _Tower):
    f, T, xp, yp, xq, yq = _miller_inputs()
    T2, line = w.add_step(T, xq, yq)
    return _outputs(MIL_F, w.mul_line_sparse(f, line, xp, yp)) + _outputs(MIL_T, T2)


@functools.cache
def miller_programs() -> tuple[Program, ...]:
    """K8's steps: a doubling bit (f^2, the doubling step, the sparse line
    product) and an addition bit (the addition step, the sparse line
    product)."""
    return (_program("miller_dbl", _miller_dbl), _program("miller_add", _miller_add))


def _easy_inputs():
    t = tuple(_fixed(EXP_T + 2 * i, (2,)) for i in range(3))
    consts = tuple(_fixed(EXP_C + 2 * i, (2,)) for i in range(3))
    return _fp12(EXP_F), t, _fixed(EXP_D, (2,)), consts


def _easy_norm(w: _Tower):
    f, _, _, _ = _easy_inputs()
    t, d = w.fp12_inv_norm(f)
    return _outputs(EXP_T, t) + _outputs(EXP_D, d) + [(EXP_N, w.fp2_norm(d))]


def _easy_back(w: _Tower):
    f, t, d, consts = _easy_inputs()
    g = w.fp12_mul(w.fp12_conj(f), w.fp12_inv_back(f, t, w.fp2_inv_back(d, EXP_N)))
    g2 = w.fp12_frobenius(w.fp12_frobenius(g, *consts), *consts)
    return _outputs(EXP_F, w.fp12_mul(g2, g))


@functools.cache
def easy_exp_programs() -> tuple[Program, ...]:
    """K9's steps around the inversion: the norm (fp12_inv, fp6_inv and
    fp2_inv of ops/tower.py down to the one Fp value fp2_inv inverts,
    keeping fp6_inv's t and fp2_inv's input) and the back-substitution
    (from that value's inverse up to inv(f), then conj(f) inv(f) and
    frobenius2(g) g, as ops/pairing.py easy_part)."""
    return (_program("easy_norm", _easy_norm, EXP_FIXED),
            _program("easy_back", _easy_back, EXP_FIXED))


def _comb_inputs():
    consts = tuple(_fixed(COMB_C + 2 * i, (2,)) for i in range(3))
    return _fp12(COMB_U), _fp12(COMB_V), consts


def _comb_b(w: _Tower):
    u, v, consts = _comb_inputs()
    return _outputs(COMB_U, w.fp12_mul(u, w.fp12_frobenius(v, *consts)))


def _comb_c(w: _Tower):
    u, v, consts = _comb_inputs()
    v2 = w.fp12_frobenius(w.fp12_frobenius(v, *consts), *consts)
    return _outputs(COMB_U, w.fp12_mul(w.fp12_mul(u, v2), w.fp12_conj(v)))


def _comb_final(w: _Tower):
    u, v, _ = _comb_inputs()
    return _outputs(COMB_U, w.fp12_mul(w.fp12_mul(u, w.fp12_sqr(v)), v))


_COMB_BODIES = {"b": _comb_b, "c": _comb_c, "final": _comb_final}


@functools.cache
def comb_program(mode: str) -> Program:
    """K11's one step in ``mode``, in ``tkernel_calls.comb_plain``'s
    expression order: b = u frob(v); c = (u frob(frob(v))) conj(v);
    final = (u v^2) v; the result in u's slots."""
    return _program(f"comb_{mode}", _COMB_BODIES[mode], COMB_FIXED)


def _x_steps(per_bit: int, per_one: int) -> list[int]:
    """Program ``per_bit`` for each bit of |x| below the leading one,
    ``per_one`` after each one bit."""
    steps = []
    for bit in X_BITS:
        steps += [per_bit] + ([per_one] if bit == "1" else [])
    return steps


# ---------------------------------------------------------------- plans

# Load sources that are constants (csrc/coop.cuh kZero, kOne).
ZERO, ONE = -1, -2


def invert_step(slot: int) -> int:
    """The step that inverts fixed slot ``slot`` in place (csrc/coop.cuh
    reads a negative step so)."""
    return -1 - slot


@dataclass(frozen=True, eq=False)
class Plan:
    """What a kernel's block does for its lane. ``loads`` fill the fixed
    slots, each (slot, source, stride, k): the lane's Fp value ``k`` of
    input ``source`` (``stride`` Fp values per lane; stride 0: value ``k``
    of an input that every lane shares), or ``ZERO`` / ``ONE``. ``steps``
    index ``programs`` and run in turn; a negative step is
    :func:`invert_step`'s. ``stores`` are the lane's
    outputs in order, each (slot, negate), negated where asked (a
    conjugate's c1); a lane the kernel skips runs no step and stores its
    loaded slots as they are."""

    name: str
    programs: tuple
    loads: tuple
    steps: tuple
    stores: tuple

    @property
    def n_slots(self) -> int:
        return max(p.n_slots for p in self.programs)


def rounds_per_lane(plan: Plan) -> tuple[int, int, int]:
    """(product rounds, add rounds, Fp products) of one lane of ``plan``'s
    programs (an inversion step is none of these)."""
    steps = np.asarray(plan.steps, np.int64)
    n = np.bincount(steps[steps >= 0], minlength=len(plan.programs))
    return tuple(int(sum(k * getattr(p, a) for k, p in zip(n, plan.programs)))
                 for a in ("product_rounds", "add_rounds", "products"))


@functools.cache
def pow_x_plan(xm1: bool) -> Plan:
    """K10 on the input f (12 Fp per lane): acc = f; a squaring per bit of
    |x| below the leading one and a product with f after each one bit; then
    conj(acc) because x < 0, or on ``xm1`` the tail conj(acc) conj(f)
    (f^(x-1))."""
    steps = _x_steps(POW_SQR, POW_MUL) + ([POW_CONJ_MUL] if xm1 else [])
    return Plan(
        name="pow_x_xm1" if xm1 else "pow_x",
        programs=pow_x_programs(),
        loads=tuple((s + k, 0, 12, k) for s in (POW_ACC, POW_BASE) for k in range(12)),
        steps=tuple(steps),
        stores=tuple((POW_ACC + k, not xm1 and k >= 6) for k in range(12)),
    )


@functools.cache
def miller_plan() -> Plan:
    """K8 on the inputs (xp, yp, xq, yq): f = 1, T = (xq, yq, 1); a
    doubling bit per bit of |x| below the leading one and an addition bit
    after each one bit; then conj(f) because x < 0. The kernel skips a lane
    with P or Q at infinity, which stores f = 1."""
    xp, yp, xq, yq = range(4)
    loads = [(MIL_F + k, ONE if k == 0 else ZERO, 0, 0) for k in range(12)]
    for start, src in ((MIL_T, xq), (MIL_T + 2, yq), (MIL_XQ, xq), (MIL_YQ, yq)):
        loads += [(start + k, src, 2, k) for k in range(2)]
    loads += [(MIL_T + 4, ONE, 0, 0), (MIL_T + 5, ZERO, 0, 0),
              (MIL_XP, xp, 1, 0), (MIL_YP, yp, 1, 0)]
    return Plan(
        name="miller",
        programs=miller_programs(),
        loads=tuple(loads),
        steps=tuple(_x_steps(MIL_DBL, MIL_ADD)),
        stores=tuple((MIL_F + k, k >= 6) for k in range(12)),
    )


@functools.cache
def easy_exp_plan() -> Plan:
    """K9 on the input f (12 Fp per lane) and the shared Frobenius
    constants (:func:`easy_exp_consts`): the norm, the inversion of its one
    Fp value, the back-substitution; the output in f's slots."""
    loads = [(EXP_F + k, 0, 12, k) for k in range(12)]
    loads += [(EXP_C + k, 1, 0, k) for k in range(6)]
    return Plan(
        name="easy_exp",
        programs=easy_exp_programs(),
        loads=tuple(loads),
        steps=(EXP_NORM, invert_step(EXP_N), EXP_BACK),
        stores=tuple((EXP_F + k, False) for k in range(12)),
    )


@functools.cache
def comb_plan(mode: str) -> Plan:
    """K11 in ``mode`` on the inputs u and v (12 Fp per lane each) and, for
    b and c, the shared Frobenius constants (:func:`easy_exp_consts`): one
    step, the output in u's slots."""
    loads = [(COMB_U + k, 0, 12, k) for k in range(12)]
    loads += [(COMB_V + k, 1, 12, k) for k in range(12)]
    if mode != "final":
        loads += [(COMB_C + k, 2, 0, k) for k in range(6)]
    return Plan(
        name=f"comb_{mode}",
        programs=(comb_program(mode),),
        loads=tuple(loads),
        steps=(0,),
        stores=tuple((COMB_U + k, False) for k in range(12)),
    )


_EXP_CONSTS = np.concatenate([FROB6_C1, FROB6_C2, FROB12_C1])


def easy_exp_consts(device) -> torch.Tensor:
    """K9's second input: FROB6_C1, FROB6_C2, FROB12_C1 as int32 [6, 48]."""
    return const(_EXP_CONSTS, device)


# ------------------------------------------------------- the plain model


# R^3 mod p in limbs: a Montgomery product by it takes the plain integer
# inverse of a R to a^-1 R (csrc/fp.cuh kR3).
_R3_LIMBS = field.int_to_limbs(pow(field.R_MONT, 3, P))


def invert_model(a: torch.Tensor) -> torch.Tensor:
    """What an inversion step (csrc/fp.cuh fp_inv_gcd) leaves in its slot,
    limb for limb: the plain integer inverse of canonical(a) (0 -> 0), then
    one Montgomery product by R^3. Same value mod p as ``field.mont_inv``
    (Fermat), possibly another representative in [0, 2p). a: int32
    [..., 48]."""
    c = field.canonical(a).cpu().numpy().reshape(-1, field.N_LIMBS)
    inv = [pow(x, P - 2, P) for x in (field.limbs_to_int(row) for row in c)]
    i = torch.from_numpy(field.ints_to_limbs(inv)).to(a.device).reshape(a.shape)
    return field.mont_mul(i, const(_R3_LIMBS, a.device))


def run_program(p: Program, slots: torch.Tensor) -> None:
    """Run ``p`` in place on ``slots`` (int32 [lanes, >= p.n_slots, 48]):
    each round's operations of one kind as one batched ``ops/field.py``
    call."""
    fns = {MUL: field.mont_mul, ADD: field.add, SUB: field.sub}
    for ops in p.rounds:
        results = []
        for kind in (MUL, ADD, SUB, NEG):
            o = torch.from_numpy(ops[ops[:, 0] == kind])
            if not len(o):
                continue
            a = slots[:, o[:, 2]]
            r = field.neg(a) if kind == NEG else fns[kind](a, slots[:, o[:, 3]])
            results.append((o[:, 1], r))
        for dst, r in results:
            slots[:, dst] = r


def run_plan(plan: Plan, inputs, skip=None) -> torch.Tensor:
    """What the kernel's blocks do, on CPU tensors: ``inputs`` as the
    plan's loads read them (int32, ``stride`` x 48 per lane), ``skip`` a
    bool [n] of lanes to skip; returns int32 [n, len(plan.stores), 48]."""
    n, dev = inputs[0].shape[0], inputs[0].device
    fill = {ZERO: torch.zeros(field.N_LIMBS, dtype=torch.int32, device=dev),
            ONE: const(FP2_ONE, dev)[0]}
    slots = torch.zeros(n, plan.n_slots, field.N_LIMBS, dtype=torch.int32, device=dev)
    for slot, src, stride, k in plan.loads:
        if src < 0:
            slots[:, slot] = fill[src]
        elif stride == 0:
            slots[:, slot] = inputs[src].reshape(-1, field.N_LIMBS)[k]
        else:
            slots[:, slot] = inputs[src].reshape(n, stride, field.N_LIMBS)[:, k]
    idx = [s for s, _ in plan.stores]
    loaded = slots[:, idx].clone()
    for step in plan.steps:
        if step < 0:
            slots[:, -1 - step] = invert_model(slots[:, -1 - step])
        else:
            run_program(plan.programs[step], slots)
    out = slots[:, idx]
    negate = torch.tensor([bool(g) for _, g in plan.stores], device=dev)
    out = torch.where(negate[:, None], field.neg(out), out)
    if skip is not None:
        out = torch.where(skip[:, None, None], loaded, out)
    return out


def pow_x_steps(f: torch.Tensor, xm1: bool) -> torch.Tensor:
    """K10's plan on the CPU: f^x, or f^x conj(f) when ``xm1``
    (f: Fp12 [n, 2, 3, 2, 48], cyclotomic)."""
    return run_plan(pow_x_plan(xm1), (f,)).reshape(-1, 2, 3, 2, field.N_LIMBS)


def easy_exp_steps(f: torch.Tensor) -> torch.Tensor:
    """K9's plan on tensors: f^((p^6-1)(p^2+1)) with the divstep
    inversion's representative (f: Fp12 [n, 2, 3, 2, 48])."""
    out = run_plan(easy_exp_plan(), (f, easy_exp_consts(f.device)))
    return out.reshape(-1, 2, 3, 2, field.N_LIMBS)


def comb_steps(u: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """K11's plan on tensors: the combination ``mode`` of u and v (Fp12
    [n, 2, 3, 2, 48])."""
    out = run_plan(comb_plan(mode), (u, v, easy_exp_consts(u.device)))
    return out.reshape(-1, 2, 3, 2, field.N_LIMBS)


def miller_steps(p_aff, p_inf, q_aff, q_inf) -> torch.Tensor:
    """K8's plan on the CPU: the Miller loop per (P, Q) lane, conj for
    x < 0, Fp12 one where P or Q is at infinity."""
    out = run_plan(miller_plan(), (*p_aff, *q_aff), p_inf | q_inf)
    return out.reshape(-1, 2, 3, 2, field.N_LIMBS)


# ------------------------------------------------------------ the packing

# int16 values before the program offsets (csrc/coop.cuh kHeader).
HEADER = 5


def pack(plan: Plan) -> np.ndarray:
    """A plan as one int16 array, the layout csrc/coop.cuh reads: [n_slots,
    n_programs, n_loads, n_stores, n_steps], the offset of each program,
    the loads (4 values each), the stores (2 each), the steps; then each
    program: [n_rounds, start of each round and the end (op indices), then
    4 values per op (op, dst, a, b)]."""
    ps = plan.programs
    head = [plan.n_slots, len(ps), len(plan.loads), len(plan.stores), len(plan.steps)]
    table = [v for ld in plan.loads for v in ld] \
        + [int(v) for st in plan.stores for v in st] + list(plan.steps)
    base = HEADER + len(ps) + len(table)
    body: list[int] = []
    offsets = []
    for p in ps:
        offsets.append(base + len(body))
        starts = np.cumsum([0] + [len(r) for r in p.rounds]).tolist()
        body += [len(p.rounds), *starts]
        for r in p.rounds:
            body += r.ravel().tolist()
    out = np.array(head + offsets + table + body, np.int64)
    if out.max() > np.iinfo(np.int16).max:
        raise ValueError("plan too large for int16 offsets")
    return out.astype(np.int16)


_PACKED: dict[str, np.ndarray] = {}
_DEVICE_CACHE: dict[tuple, torch.Tensor] = {}


def _packed(plan: Plan) -> np.ndarray:
    if plan.name not in _PACKED:
        _PACKED[plan.name] = pack(plan)
    return _PACKED[plan.name]


def to_device(plan: Plan, device) -> torch.Tensor:
    """``pack(plan)`` as an int16 tensor on ``device``, made once per plan
    and device."""
    key = (plan.name, str(torch.device(device)))
    if key not in _DEVICE_CACHE:
        _DEVICE_CACHE[key] = torch.from_numpy(_packed(plan)).to(device)
    return _DEVICE_CACHE[key]


def shared_bytes(plan: Plan) -> int:
    """Dynamic shared memory of one block, which the wrapper hands to the
    launch: the slots (12 words each), then the packed plan, 16-byte
    aligned."""
    return plan.n_slots * field.N_LIMBS + (2 * len(_packed(plan)) + 15) // 16 * 16
