"""Bucketed multi-scalar multiplication for the signature accumulator
sum_i r_i S_i of the fused verify: the host schedule, the MSM kernels K5-K7
and their plain versions.

Counterpart of ``lighthouse_tpu/ops/msm.py``. The 64-bit blinding scalars
split into 16 windows of 4 bits:

    sum_i r_i S_i = sum_w 16^w sum_{d=1..15} d B[d, w],
    B[d, w] = sum of the S_i whose window w holds the digit d

(240 buckets). The scalars come from the host CSPRNG, so the host lays out
the whole bucket accumulation as a dense [L, 240] index grid
(:func:`build_schedule`): round r adds the r-th point of every bucket's
list, one masked mixed addition per bucket, with no conflicts by
construction. The device then runs three chains:

* K5, accumulate: L rounds of ``pt_add_mixed`` into a 256-lane accumulator
  (lanes 240-255 pad the bucket axis and stay at infinity); on the card a
  deep bucket is cut into segments summed side by side and joined
  (:func:`accum_segments_plain`: the same points, other limbs);
* K6, tree: two stride-16 shift-add trees weight each bucket by its digit,
  T[w] = sum_d d B[d, w] in lanes 0-15 (the sum-of-suffix-sums identity);
  a shift never leaves a window, so the card runs one block per window;
* K7, Horner: sum_w 16^w T[w] in lane 0, four doublings and one addition
  per window.

The lane layout is digit-major, ``lane = (digit - 1) * 16 + w``: the
tree's shifts by multiples of 16 depend on it.

The wrappers follow ``ops/tkernel_calls.py``: CUDA tensors go to the kernel
(checked, counted on its ``_build.Kernel``) or the wrapper raises; CPU
tensors go to the plain version. There is no fallback from one to the
other, and importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .points import (
    FP2_OPS,
    pt_add,
    pt_add_mixed,
    pt_double,
    pt_from_affine,
    pt_infinity,
)
from .tkernel_calls import _FP2, _checked, _empty, _launch, _on_cpu

WINDOW_BITS = 4
N_WINDOWS = 64 // WINDOW_BITS          # 16 (RAND_BITS = 64)
N_DIGITS = (1 << WINDOW_BITS) - 1      # 15 nonzero digits
N_BUCKETS = N_WINDOWS * N_DIGITS       # 240
_LANES = 256                           # buckets padded to a power of two

_LIB = _build.CudaLibrary("msm.cu")
_SITE = "lighthouse_tpu/ops/msm.py"


def _kernel(name: str, replaces: str) -> _build.Kernel:
    return _build.register(_build.Kernel(
        name=name,
        route="cuda",
        source="lighthouse_tpu_torch/csrc/msm.cu",
        replaces=f"{_SITE}:{replaces}",
        library=_LIB,
    ))


K5 = _kernel("msm_accum", "153 kernel(of _accum_t)")
K6 = _kernel("msm_tree", "185 _tree_kernel")
K7 = _kernel("msm_horner", "213 _horner_kernel")

# ------------------------------------------------------------ the schedule


def max_rounds(n_sets: int) -> int:
    """Static bucket-depth bound for an n-set batch: binomial mean
    n/16 plus ~6 sigma, rounded up to a multiple of 8 -- P(overflow) ~ 1e-7
    per batch; the caller checks the actual schedule and falls back."""
    mean = n_sets / (1 << WINDOW_BITS)
    bound = int(mean + 6.0 * math.sqrt(mean + 16) + 8)
    return -(-bound // 8) * 8


def build_schedule(r_u64: np.ndarray, L: int, skip=None):
    """Host scheduler: scalars -> (idx[L, 240] int32, valid[L, 240] bool).

    idx[r, b] is the set index whose point is added into bucket b at
    round r (0 with valid=False for exhausted slots). ``skip`` marks set
    indices to leave out (padding lanes). Returns None when a bucket holds
    more than L points (the caller falls back to the scan path).
    Vectorised: it runs on the dispatch path of every verify."""
    r = np.asarray(r_u64, np.uint64)
    shifts = (np.arange(N_WINDOWS, dtype=np.uint64) * np.uint64(WINDOW_BITS))
    digits = ((r[None, :] >> shifts[:, None]) & np.uint64(N_DIGITS)).astype(
        np.int64
    )  # [W, S]
    if skip is not None:
        digits[:, np.asarray(skip, bool)] = 0
    wi, si = np.nonzero(digits)
    b = (digits[wi, si] - 1) * N_WINDOWS + wi   # digit-major lanes
    order = np.argsort(b, kind="stable")
    b_sorted = b[order]
    i_sorted = si[order]
    first = np.searchsorted(b_sorted, np.arange(N_BUCKETS), side="left")
    counts = (
        np.searchsorted(b_sorted, np.arange(N_BUCKETS), side="right") - first
    )
    if len(b_sorted) and counts.max() > L:
        return None
    pos = np.arange(len(b_sorted)) - first[b_sorted]
    idx = np.zeros((L, N_BUCKETS), np.int32)
    idx[pos, b_sorted] = i_sorted
    valid = np.arange(L)[:, None] < counts[None, :]
    return idx, valid


# ------------------------------------------------------ plain versions


def _on_lanes(live, fn, base, *args):
    """``base`` with ``fn(*args)`` on the lanes where ``live`` holds. The
    group law is lane-wise, so running it on those lanes alone gives their
    limbs; the other lanes are the case selects', which need no product."""
    lanes = live.nonzero().squeeze(1)
    if lanes.numel() == 0:
        return base
    out = fn(*(tuple(c[lanes] for c in a) for a in args))
    return tuple(b.index_copy(0, lanes, o) for b, o in zip(base, out))


def _add_mixed(acc, x, y, valid):
    """``pt_add_mixed(acc, (x, y), ~valid)`` lane for lane: acc at infinity
    takes (x, y) (with Z = 0 where not valid), an invalid lane keeps acc,
    and the formula runs where both are finite."""
    F = FP2_OPS
    p_inf = F.is_zero(acc[2])
    Q = pt_from_affine(F, x, y, ~valid)
    base = tuple(F.select(p_inf, q, a) for q, a in zip(Q, acc))
    return _on_lanes(valid & ~p_inf,
                     lambda P, q: pt_add_mixed(F, P, q[:2], ~q[2]),
                     base, acc, (x, y, valid))


def _add(P, Q):
    """``pt_add(P, Q)`` lane for lane: Q where P is at infinity, else P
    where Q is, and the formula where both are finite."""
    F = FP2_OPS
    p_inf, q_inf = F.is_zero(P[2]), F.is_zero(Q[2])
    base = tuple(F.select(p_inf, q, p) for p, q in zip(P, Q))
    return _on_lanes(~p_inf & ~q_inf, lambda a, b: pt_add(F, a, b), base, P, Q)


def accum_plain(sx, sy, idx, valid):
    """K5's plain version (reference ``_accum_t``): affine signatures sx, sy
    [S, 2, 48], the schedule idx int32 / valid bool [L, 240] -> the bucket
    accumulator, Jacobian (X, Y, Z) of [256, 2, 48].

    Every lane starts at (one, one, zero); round r adds (sx, sy)[idx[r]]
    masked by valid[r] (``pt_add_mixed``). The pad lanes 240-255 add the
    all-zero affine point, never valid."""
    S, L = sx.shape[0], idx.shape[0]
    pad = _LANES - N_BUCKETS
    zero = torch.zeros(1, *_FP2, dtype=sx.dtype, device=sx.device)
    sx, sy = torch.cat([sx, zero]), torch.cat([sy, zero])  # row S: the pad
    idx = torch.cat([idx.long(), torch.full((L, pad), S, dtype=torch.long,
                                            device=idx.device)], 1)
    valid = torch.cat([valid, torch.zeros(L, pad, dtype=torch.bool,
                                          device=valid.device)], 1)
    acc = tuple(c.contiguous() for c in pt_infinity(FP2_OPS, (_LANES,), sx.device))
    for r in range(L):
        acc = _add_mixed(acc, sx[idx[r]], sy[idx[r]], valid[r])
    return acc


def segment_bounds(valid, k: int):
    """K5's cut of each bucket into k segments (csrc/msm.cu segment_sum):
    valid bool [L, 240] -> (r0, r1, want), each int64 [k, 256]. Segment j
    of a bucket with c valid rounds holds its valid rounds lo .. hi - 1 in
    order, lo = ceil(j c / k), hi = ceil((j + 1) c / k), ``want`` of them,
    and the rounds [r0, r1): from the one after valid round lo - 1 (0 when
    lo = 0) to valid round hi - 1, the last segment to L. The segments cut
    [0, L) into k runs; the pad lanes 240-255 (no valid round) lie wholly
    in the last."""
    L = valid.shape[0]
    dev = valid.device
    v = torch.cat([valid, torch.zeros(L, _LANES - N_BUCKETS, dtype=torch.bool,
                                      device=dev)], 1)
    c = v.sum(0)
    j = torch.arange(k, device=dev)[:, None]
    lo, hi = (j * c + k - 1) // k, ((j + 1) * c + k - 1) // k
    cum = v.long().cumsum(0)  # valid rounds in [0, r]

    def after(m):  # the round after valid round m - 1, 0 for m = 0
        n = (cum[None] < m[:, None]).sum(1)  # rounds before valid round m - 1
        return torch.where(m > 0, n + 1, torch.zeros_like(n))

    r0 = after(lo)
    r1 = torch.where(j == k - 1, torch.full_like(lo, L), after(hi))
    return r0, r1, hi - lo


def accum_segments_plain(sx, sy, idx, valid, k: int):
    """What K5 computes with its buckets cut into k segments (k a power of
    two): each segment of :func:`segment_bounds` runs
    :func:`accum_plain`'s rounds over its rounds [r0, r1) from (one, one,
    zero), then each bucket's k sums are joined by :func:`_add` in a tree,
    s[a] = s[a] + s[a + step] for step = 1, 2, .. k / 2. The same points
    as ``accum_plain`` (equal at canonical affine), other Jacobian limbs
    where k > 1; k = 1 is ``accum_plain`` limb for limb."""
    S, L = sx.shape[0], idx.shape[0]
    dev = sx.device
    r0, r1, _ = (t.reshape(-1) for t in segment_bounds(valid, k))
    pad = _LANES - N_BUCKETS
    zero = torch.zeros(1, *_FP2, dtype=sx.dtype, device=dev)
    sx, sy = torch.cat([sx, zero]), torch.cat([sy, zero])  # row S: the pad
    idx = torch.cat([idx.long(), torch.full((L, pad), S, dtype=torch.long, device=dev)], 1)
    valid = torch.cat([valid, torch.zeros(L, pad, dtype=torch.bool, device=dev)], 1)
    lane = torch.arange(_LANES, device=dev).repeat(k)  # segment-major
    acc = tuple(c.contiguous() for c in pt_infinity(FP2_OPS, (k * _LANES,), dev))
    span = int((r1 - r0).max()) if L else 0
    for t in range(span):
        live = r0 + t < r1
        r = torch.where(live, r0 + t, torch.zeros_like(r0))
        i = idx[r, lane]
        new = _add_mixed(acc, sx[i], sy[i], valid[r, lane] & live)
        acc = tuple(torch.where(live[:, None, None], a, b) for a, b in zip(new, acc))
    s = tuple(c.reshape(k, _LANES, *_FP2) for c in acc)
    step = 1
    while step < k:
        lhs = tuple(c[0::2 * step].reshape(-1, *_FP2) for c in s)
        rhs = tuple(c[step::2 * step].reshape(-1, *_FP2) for c in s)
        out = _add(lhs, rhs)
        s = tuple(c.clone() for c in s)
        for c, o in zip(s, out):
            c[0::2 * step] = o.reshape(-1, _LANES, *_FP2)
        step *= 2
    return tuple(c[0] for c in s)


def _shift_down(c, sh: int):
    """Lane i <- lane i + sh; the top sh lanes become all-zero limbs."""
    return torch.cat([c[sh:], torch.zeros_like(c[:sh])])


def tree_plain(B):
    """K6's plain version (reference ``_tree_kernel``): the bucket
    accumulator (X, Y, Z) [256, 2, 48] -> T[w] = sum_d d B[d, w] in lanes
    0-15, by two passes of ``pt_add(P, shift_down(P, sh))`` for sh in 16,
    32, 64, 128. The vacated lanes are X = Y = Z = 0, which ``pt_add``
    takes for infinity (Z = 0)."""
    P = B
    for _ in range(2):
        for sh in (16, 32, 64, 128):
            P = _add(P, tuple(_shift_down(c, sh) for c in P))
    return P


def horner_plain(T):
    """K7's plain version (reference ``_horner_kernel``), lane 0 only, the
    one the reference reads: the tree output (X, Y, Z) [256, 2, 48] ->
    sum_w 16^w T[w] as one Jacobian lane, each [1, 2, 48]. From T[15], each
    window w = 14 .. 0 takes four doublings and one complete addition of
    T[w]."""
    F = FP2_OPS
    acc = tuple(c[N_WINDOWS - 1:N_WINDOWS] for c in T)
    for w in range(N_WINDOWS - 2, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = pt_double(F, acc)
        acc = pt_add(F, acc, tuple(c[w:w + 1] for c in T))
    return acc


# ------------------------------------------------------------ wrappers


def _lanes256(kernel, P):
    (X, Y, Z), n = _checked(kernel, [(c, torch.int32, _FP2) for c in P])
    if n != _LANES:
        raise ValueError(f"{kernel.name}: wants {_LANES} lanes, got {n}")
    return X, Y, Z


def accum_segments(L: int) -> int:
    """The segments per bucket that K5's launch takes for L rounds, each
    summed on a group of 8 threads (csrc/msm.cu accum_segments)."""
    return K5.library.load().lh_msm_accum_segments(ctypes.c_int(L))


def accumulate(sx, sy, idx, valid):
    """Kernel K5: the bucket accumulator from affine signatures sx, sy
    [S, 2, 48] and the schedule idx int32 / valid bool [L, 240] ->
    Jacobian (X, Y, Z) of [256, 2, 48] (plain: :func:`accum_plain`; the
    kernel's limbs are :func:`accum_segments_plain`'s at the segments of
    :func:`accum_segments`, the same points). The kernel gathers sx[idx]
    itself; an index outside [0, S) in any slot stops it with a device
    fault."""
    if _on_cpu(sx, sy, idx, valid):
        return accum_plain(sx, sy, idx, valid)
    (sx, sy), S = _checked(K5, [(sx, torch.int32, _FP2), (sy, torch.int32, _FP2)])
    (idx, valid), L = _checked(K5, [(idx, torch.int32, (N_BUCKETS,)),
                                    (valid, torch.bool, (N_BUCKETS,))])
    if idx.device != sx.device:
        raise ValueError(f"{K5.name}: wants every operand on one CUDA device, "
                         f"got {idx.device} beside {sx.device}")
    out = _empty(_LANES, _FP2, sx, lead=(3,))
    _launch(K5, (sx, sy, idx, valid, out[0], out[1], out[2]), (L, S), _LANES)
    return out[0], out[1], out[2]


def tree(B):
    """Kernel K6: the bucket accumulator (X, Y, Z) [256, 2, 48] -> the
    window sums T in lanes 0-15, the same shape (plain: :func:`tree_plain`,
    the same limbs on all 256 lanes)."""
    if _on_cpu(*B):
        return tree_plain(B)
    X, Y, Z = _lanes256(K6, B)
    out = _empty(_LANES, _FP2, X, lead=(3,))
    _launch(K6, (X, Y, Z, out[0], out[1], out[2]), (), _LANES)
    return out[0], out[1], out[2]


def horner(T):
    """Kernel K7: the window sums (X, Y, Z) [256, 2, 48] -> the MSM point
    as one Jacobian lane, each [1, 2, 48] (plain: :func:`horner_plain`)."""
    if _on_cpu(*T):
        return horner_plain(T)
    X, Y, Z = _lanes256(K7, T)
    out = _empty(1, _FP2, X, lead=(3,))
    _launch(K7, (X, Y, Z, out[0], out[1], out[2]), (), _LANES)
    return out[0], out[1], out[2]


def msm_g2(sx, sy, idx, valid):
    """sum_i r_i S_i from affine signatures sx, sy [S, 2, 48] (Montgomery;
    sets at infinity must be left out of the schedule, the scheduler's
    ``skip``) and the host schedule idx / valid [L, 240]: one Jacobian
    point (X, Y, Z), each [2, 48]. K5, K6 and K7 on CUDA tensors, their
    plain versions on CPU tensors."""
    P = horner(tree(accumulate(sx, sy, idx, valid)))
    return tuple(c[0] for c in P)
