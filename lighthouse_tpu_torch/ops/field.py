"""Batched BLS12-381 base-field (Fp) limb arithmetic on torch tensors.

Port of ``lighthouse_tpu/ops/limb.py``, in the same representation so the
tensors compare one to one with the JAX package's arrays:

An Fp element is ``int32[..., 48]``: 48 little-endian limbs of 8 bits each
(384 bits; p is 381 bits), in Montgomery form with R = 2^384. Every value is
in [0, 2p) (the lazy "almost-reduced" form); limbs are normalized to
[0, 255] on function exit. Canonical reduction to [0, p) happens only at
comparison/serialization boundaries (:func:`canonical`).

Every function returns exactly the limbs the reference returns, not merely
an equal value mod p: ``add`` subtracts 2p iff the sum reaches 2p, ``sub``
adds 2p iff a < b, ``mont_mul`` has no final subtraction. How the carries
are propagated is free (``_carry.py`` does it in a constant number of ops
instead of the reference's 48-step scan); the normalized limbs are not.

All functions broadcast over leading axes. ``mont_mul`` sends a CUDA tensor
to kernel K1 and a CPU tensor to its plain version (``mont_mul.py``).
"""

from __future__ import annotations

from itertools import repeat

import numpy as np
import torch

from ..crypto.bls.constants import P
from ._carry import const, resolve, scalar
from .mont_mul import mont_mul

# ----------------------------------------------------------------- parameters

LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
N_LIMBS = 48  # 48 * 8 = 384 bits >= 381
R_BITS = N_LIMBS * LIMB_BITS  # Montgomery R = 2^384

R_MONT = (1 << R_BITS) % P          # R mod p
R2_MONT = (R_MONT * R_MONT) % P     # R^2 mod p  (to_mont multiplier)


# ------------------------------------------------------- host conversions


def int_to_limbs(x: int) -> np.ndarray:
    """Host-side: python int -> int32[48] limb vector (little-endian)."""
    if x < 0 or x >= (1 << R_BITS):
        raise ValueError("value out of limb range")
    return np.frombuffer(x.to_bytes(N_LIMBS, "little"), dtype=np.uint8).astype(
        np.int32
    )


def limbs_to_int(limbs) -> int:
    """Host-side: limb vector (any nonneg int32 values) -> python int."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))


def ints_to_limbs(xs) -> np.ndarray:
    """Host-side batch conversion: iterable of ints -> int32[n, 48]."""
    xs = list(xs)
    buf = _ints_to_bytes(xs)
    return (
        np.frombuffer(buf, dtype=np.uint8).astype(np.int32).reshape(len(xs), N_LIMBS)
    )


def _ints_to_bytes(xs: list) -> bytes:
    """One concatenated little-endian 48-byte buffer for a list of ints."""
    try:
        return b"".join(map(int.to_bytes, xs, repeat(N_LIMBS), repeat("little")))
    except TypeError:
        # non-int field wrappers: the casting path
        return b"".join(int(x).to_bytes(N_LIMBS, "little") for x in xs)


# --- vectorized host-side to-Montgomery conversion ------------------------
# ints_to_limbs_mont() computes limbs(v * 2^384 mod p) for a whole batch
# without per-int Python bigint work (same algorithm as the reference's
# lighthouse_tpu/ops/limb.py). Each v < p splits into 24 base-2^16 words
# u_i, then
#
#     v * 2^384 mod p  ==  sum_i u_i * W_i  -  q * p,   q = floor(V / p)
#
# with W_i = 2^(16*i + 384) mod p as 12 base-2^32 words. T = u @ WMAT is one
# float64 matmul whose partials are exact (< 24 * 2^48 < 2^53). The quotient
# estimate q is off by at most one, fixed up after a signed base-2^32 carry
# loop; the 12 columns then ARE the 48 output limbs via a byte view.

_MONT_WMAT = np.zeros((24, 12), np.float64)
for _i in range(24):
    _w = (1 << (16 * _i + R_BITS)) % P
    for _k in range(12):
        _MONT_WMAT[_i, _k] = (_w >> (32 * _k)) & 0xFFFFFFFF
_P32F = np.array(
    [(P >> (32 * _k)) & 0xFFFFFFFF for _k in range(12)], np.float64
)
# 2^(32k)/p rounded to f64: quotient-estimate weights for the T columns
_POW32_OVER_P = np.array(
    [float((1 << (32 * _k + 100)) // P) * 2.0 ** -100 for _k in range(12)],
    np.float64,
)
_TWO32 = 2.0 ** 32
_INV32 = 2.0 ** -32
# top base-2^32 word of p: prefilter for the rare >= p fixup check
_PTOPF = float(P >> (32 * 11))
del _i, _k, _w


def _carry_rows_f64(D: np.ndarray) -> None:
    """In-place signed base-2^32 carry normalization of float64 digit
    columns (exact: all values stay far below 2^53)."""
    c = np.empty_like(D)
    t = np.empty_like(D)
    while True:
        np.multiply(D, _INV32, out=c)
        np.floor(c, out=c)
        c[:, -1] = 0.0  # the top column keeps its sign until fixup
        if not c.any():
            return
        np.multiply(c, _TWO32, out=t)
        np.subtract(D, t, out=D)
        D[:, 1:] += c[:, :-1]


def ints_to_limbs_mont(xs) -> np.ndarray:
    """Host-side batch to-Montgomery conversion: iterable of standard-domain
    ints in [0, p) -> int32[n, 48] limbs of (v * R) mod p."""
    xs = list(xs)
    n = len(xs)
    if n == 0:
        return np.zeros((0, N_LIMBS), np.int32)
    buf = _ints_to_bytes(xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(n, 24).astype(np.float64)
    T = u16 @ _MONT_WMAT                      # [n, 12] base-2^32, exact
    q = np.floor(T @ _POW32_OVER_P)           # ~V/p, off by at most 1
    D = np.empty((n, 13))
    D[:, 12] = 0.0
    np.multiply(q[:, None], _P32F[None, :], out=D[:, :12])
    np.subtract(T, D[:, :12], out=D[:, :12])
    _carry_rows_f64(D)
    # q off-by-one fixup: a negative top column means q was one too big
    # (add p back); otherwise a >= p check catches q one too small.
    while True:
        neg = D[:, 12] < 0
        if neg.any():
            D[neg, :12] += _P32F
            _carry_rows_f64(D)
            continue
        cand = D[:, 11] >= _PTOPF
        if not cand.any():
            break
        diff = D[cand, :12] - _P32F[None, :]
        nz = diff != 0
        has = nz.any(axis=1)
        top = 11 - np.argmax(nz[:, ::-1], axis=1)
        ge = (~has) | (has & (diff[np.arange(diff.shape[0]), top] > 0))
        if not ge.any():
            break
        rows = np.flatnonzero(cand)[ge]
        D[rows, :12] -= _P32F
        _carry_rows_f64(D)
    return (
        D[:, :12].astype("<u4").view(np.uint8).astype(np.int32)
        .reshape(n, N_LIMBS)
    )


P_LIMBS = int_to_limbs(P)
TWO_P_LIMBS = int_to_limbs(2 * P)
R2_LIMBS = int_to_limbs(R2_MONT)
ONE_LIMBS = int_to_limbs(1)
R_LIMBS = int_to_limbs(R_MONT)  # 1 in Montgomery form
ZERO_LIMBS = int_to_limbs(0)
# 2^384 - p and 2^384 - 2p: x - kp as the nonnegative sum x + (2^384 - kp),
# whose carry out of the top limb is the comparison x >= kp.
COMP_P_LIMBS = int_to_limbs((1 << R_BITS) - P)
COMP_TWO_P_LIMBS = int_to_limbs((1 << R_BITS) - 2 * P)
# a - b as a + (255 - b) + 1 limbwise: 255 per limb, 256 in limb 0.
_SUB_BIAS = np.full(N_LIMBS, LIMB_MASK, np.int32)
_SUB_BIAS[0] += 1


# --------------------------------------------------------------- add/sub/neg


def _pick(x: torch.Tensor, take_first: torch.Tensor) -> torch.Tensor:
    """x: [2, ..., 48] candidates -> x[0] where take_first else x[1]."""
    return torch.where(take_first.unsqueeze(-1), x[0], x[1])


def _normalize_pair(x: torch.Tensor):
    """Normalize stacked candidates with digits <= 766: one regroup keeping
    the top limb's overflow, then the binary resolve. Returns (limbs,
    total carry out of the top limb)."""
    hi = x >> scalar(LIMB_BITS, x)
    x = x & scalar(LIMB_MASK, x)
    x[..., 1:] += hi[..., :-1]
    out, carry = resolve(x)
    return out, carry + hi[..., -1]


def add(a, b):
    """(a + b) mod-ish: result = a+b, minus 2p iff a+b >= 2p; in [0, 2p)."""
    s = a + b
    both, carry = _normalize_pair(
        torch.stack((s + const(COMP_TWO_P_LIMBS, s.device), s))
    )
    return _pick(both, carry[0] != 0)


def sub(a, b):
    """(a - b) mod-ish: result = a-b, plus 2p iff a < b; in [0, 2p)."""
    d = a - b + const(_SUB_BIAS, a.device)      # a - b + 2^384, digits >= 0
    both, carry = _normalize_pair(
        torch.stack((d, d + const(TWO_P_LIMBS, d.device)))
    )
    return _pick(both, carry[0] != 0)


def add_sub(a, b):
    """(add(a, b), sub(a, b)) with one normalization for both."""
    s = a + b
    d = a - b + const(_SUB_BIAS, a.device)
    both, carry = _normalize_pair(torch.stack((
        torch.stack((s + const(COMP_TWO_P_LIMBS, s.device), d)),
        torch.stack((s, d + const(TWO_P_LIMBS, d.device))),
    )))
    out = _pick(both, carry[0] != 0)
    return out[0], out[1]


def neg(a):
    """(-a) mod-ish, closed on [0, 2p): 0 -> 0, else 2p - a."""
    return sub(const(ZERO_LIMBS, a.device), a)


def double(a):
    return add(a, a)


# ------------------------------------------------------------ multiplication


def mont_sqr(a):
    return mont_mul(a, a)


def mont_pow_const(a, e: int):
    """a^e in the Montgomery domain for a constant exponent: left-to-right
    square-and-multiply over the bits of e, skipping the multiply on zero
    bits (the reference computes it and selects the square)."""
    if e < 0:
        raise ValueError("negative exponent")
    if e == 0:
        return const(R_LIMBS, a.device).expand(a.shape)
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_sqr(acc)
        if bit == "1":
            acc = mont_mul(acc, a)
    return acc


def mont_inv(a):
    """a^{-1} in the Montgomery domain via Fermat (a^(p-2)); 0 -> 0."""
    return mont_pow_const(a, P - 2)


def to_mont(a):
    """Standard -> Montgomery domain: a * R mod p."""
    return mont_mul(a, const(R2_LIMBS, a.device))


def from_mont(a):
    """Montgomery -> standard domain: a * R^{-1} mod p (canonical, < p)."""
    return canonical(mont_mul(a, const(ONE_LIMBS, a.device)))


# ------------------------------------------------------- canonical / compare


def canonical(a):
    """Fully reduce an almost-reduced value into [0, p)."""
    d, carry = resolve(a + const(COMP_P_LIMBS, a.device))    # a - p + 2^384
    return torch.where((carry != 0).unsqueeze(-1), d, a)


def eq(a, b):
    """Value equality mod p for almost-reduced inputs -> bool[...]."""
    c = canonical(torch.stack(torch.broadcast_tensors(a, b)))
    return (c[0] == c[1]).all(-1)


def is_zero(a):
    """a == 0 mod p: for a in [0, 2p) that is a == 0 or a == p."""
    return (a == 0).all(-1) | (a == const(P_LIMBS, a.device)).all(-1)


def sgn0(a):
    """RFC 9380 sgn0 (parity of the canonical representative) -> int32[...]."""
    return canonical(a)[..., 0] & 1

