"""Carry propagation and schoolbook convolution on byte-limb tensors.

Shared by the plain Montgomery multiply (``mont_mul.py``) and the Fp layer
(``field.py``). Limbs are radix 2^8 on the trailing axis, little-endian.

The reference normalizes with a 48-step sequential scan
(``lighthouse_tpu/ops/limb.py`` ``_carry_scan``). Any carry method yields the
same normalized limbs, so here a carry costs a constant number of tensor
ops whatever the limb count:

* :func:`regroup` folds each digit's high part into the next digit once,
  shrinking a digit bound B to 255 + B/256 (radix 2^8; 2^16 likewise);
* :func:`resolve` finishes digits that are at most 510 (511 in limb 0),
  where every carry is 0 or 1: the carry out of limb i is the "generate"
  bit of the nearest limb at or below i that is not 255, found with one
  ``cummax`` over limb positions.

Tensor constants are cached per device (and dtype for scalars): a Python
scalar operand costs a fresh wrapped tensor on every op, a numpy constant a
host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(arr, device) -> torch.Tensor:
    """Module-level numpy constant ``arr`` as a tensor on ``device``
    (cached per device; the arrays are never mutated)."""
    key = ("arr", id(arr), torch.device(device))
    hit = _CACHE.get(key)
    if hit is None:
        hit = (arr, torch.from_numpy(np.ascontiguousarray(arr)).to(device))
        _CACHE[key] = hit
    return hit[1]


def scalar(v: int, like: torch.Tensor) -> torch.Tensor:
    """0-dim tensor ``v`` with ``like``'s dtype and device (cached)."""
    key = ("s", v, like.dtype, like.device)
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(v, dtype=like.dtype, device=like.device)
        _CACHE[key] = t
    return t


def _positions(n: int, device) -> torch.Tensor:
    """int64 [0, 1, ..., n-1] on ``device`` (cached)."""
    key = ("pos", n, device)
    pos = _CACHE.get(key)
    if pos is None:
        pos = torch.arange(n, dtype=torch.int64, device=device)
        _CACHE[key] = pos
    return pos


def _conv_index(n: int, width: int, device) -> torch.Tensor:
    """int64 [n*n] with entry i*n+j = min(i+j, width) (cached)."""
    key = ("conv", n, width, device)
    idx = _CACHE.get(key)
    if idx is None:
        ij = torch.arange(n).unsqueeze(1) + torch.arange(n).unsqueeze(0)
        idx = ij.clamp(max=width).flatten().to(device)
        _CACHE[key] = idx
    return idx


def regroup(t: torch.Tensor, passes: int = 1, bits: int = 8) -> torch.Tensor:
    """``passes`` rounds of t = (t mod 2^bits) + (t >> bits moved one limb
    up) for nonnegative digits of radix 2^bits. The top limb's high part is
    dropped: callers use this only where the value fits the limb count, or
    modulo 2^(bits * limb count)."""
    mask, shift = scalar((1 << bits) - 1, t), scalar(bits, t)
    for _ in range(passes):
        hi = t >> shift
        t = t & mask
        t[..., 1:] += hi[..., :-1]
    return t


def resolve(t: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize radix-2^bits digits in [0, 2^(bits+1) - 2] (limb 0 may be
    one more) to [0, 2^bits - 1].

    Returns (limbs, carry_out) with carry_out in {0, 1} the overflow past
    the top limb; the dtype of ``t`` is kept. Limb 0 has no carry in, so
    position 0 doubles as the "no stop below" sentinel: a leading run of
    all-ones limbs reads limb 0's generate bit, which is then 0."""
    mask = scalar((1 << bits) - 1, t)
    gen = t >> scalar(bits, t)                           # limb > mask: emits 1
    stop = (t != mask) * _positions(t.shape[-1], t.device)
    cout = gen.gather(-1, stop.cummax(-1).values)        # carry out of limb i
    out = t & mask
    out[..., 1:] += cout[..., :-1]
    out &= mask
    return out, cout[..., -1]


def conv(a: torch.Tensor, b: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """Schoolbook product columns of two limb vectors (leading axes
    broadcast): out[..., k] = sum_{i+j=k} a[..., i] * b[..., j].

    Returns ``width`` columns (default 2n, the top one zero); columns at
    or past ``width`` are dropped. One outer product, one index_add."""
    n = a.shape[-1]
    width = 2 * n if width is None else width
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)                 # [..., n, n]
    out = outer.new_zeros(*outer.shape[:-2], width + 1)
    out.index_add_(-1, _conv_index(n, width, a.device), outer.flatten(-2))
    return out[..., :width]
