"""Kernel K1, the batched BLS12-381 Montgomery multiply, and its plain
PyTorch version.

``mont_mul(a, b)`` computes a * b * 2^-384 mod-ish p for Fp values in the
reference layout: ``int32[..., 48]`` byte limbs, Montgomery form with
R = 2^384, inputs and output in [0, 2p), no final subtraction. The output
is the integer (a*b + m*p) / R with m the unique quotient in [0, R), so it
equals ``lighthouse_tpu.ops.limb.mont_mul`` limb for limb.

* A CUDA tensor goes to K1 (``csrc/mont_mul.cu``, replacing the Pallas
  kernel ``lighthouse_tpu/ops/pallas_mont.py:_mont_mul_kernel``), or the
  wrapper raises. There is no fallback.
* A CPU tensor goes to :func:`mont_mul_plain`, the int64 tensor version
  the CPU tests use and ``chip_smoke.py`` holds K1 to on the card.

Importing this module builds nothing; K1 compiles at its first launch (or
through ``_build.build_all``).
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from ..crypto.bls.constants import P
from . import _build
from ._carry import const, conv, regroup, resolve

N_LIMBS = 48
_TAIL = (N_LIMBS,)
R_BITS = 8 * N_LIMBS

N_WORDS = 24  # the plain version works in 16-bit words


def _words16(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(2 * N_WORDS, "little"), "<u2").astype(np.int64)


_P16 = _words16(P)
# N' = -p^{-1} mod 2^384: m = (T mod R) * N' mod R is the Montgomery quotient.
_NINV16 = _words16((-pow(P, -1, 1 << R_BITS)) % (1 << R_BITS))

# ------------------------------------------------------------ plain version


def _to_words(x: torch.Tensor) -> torch.Tensor:
    """int32 [..., 48] byte limbs -> int64 [..., 24] 16-bit words."""
    b = x.to(torch.uint8, memory_format=torch.contiguous_format)
    return b.view(torch.uint16).to(torch.int64)


def _to_limbs(w: torch.Tensor) -> torch.Tensor:
    """int64 [..., 24] words in [0, 2^16) -> int32 [..., 48] byte limbs."""
    b = w.to(torch.int16, memory_format=torch.contiguous_format)
    return b.view(torch.uint8).to(torch.int32)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Montgomery product (int64 tensors, any device).

    REDC with whole-number products of 16-bit words instead of the
    reference's 48 digit steps, same integer out:

      T = a*b             48 columns, each < 24 * 2^32 < 2^37
      m = (T mod R) * N'  mod R, columns < 2^58 before three regroups
      U = (T + m*p) / R   columns < 2^38 before two regroups

    The top column of T + m*p stays below 2^16 because the value is below
    4p^2 + R*p < 2^768, so dropping its high part in a regroup is exact.

    Broadcasts over leading axes; returns int32[..., 48]."""
    dev = a.device
    t = conv(_to_words(a), _to_words(b))                      # [..., 48]
    m = conv(t[..., :N_WORDS], const(_NINV16, dev), width=N_WORDS)
    m, _ = resolve(regroup(m, passes=3, bits=16), bits=16)
    u = regroup(t + conv(m, const(_P16, dev)), passes=2, bits=16)
    u, _ = resolve(u, bits=16)
    return _to_limbs(u[..., N_WORDS:])


# ------------------------------------------------------------- kernel K1

_LIB = _build.CudaLibrary("mont_mul.cu")
K1 = _build.register(_build.Kernel(
    name="mont_mul",
    route="cuda",
    source="lighthouse_tpu_torch/csrc/mont_mul.cu",
    replaces="lighthouse_tpu/ops/pallas_mont.py:54 _mont_mul_kernel",
    library=_LIB,
))
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _LIB.load().lh_mont_mul
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _broadcast(a: torch.Tensor, b: torch.Tensor):
    """Both operands expanded to their common shape, by shape arithmetic
    (the rare case: the verify path passes equal shapes)."""
    sa, sb = tuple(a.shape), tuple(b.shape)
    k = max(len(sa), len(sb))
    sa, sb = (1,) * (k - len(sa)) + sa, (1,) * (k - len(sb)) + sb
    shape = []
    for x, y in zip(sa, sb):
        if x != y and 1 not in (x, y):
            raise ValueError(f"mont_mul operands do not broadcast: {a.shape}, {b.shape}")
        shape.append(y if x == 1 else x)
    return a.expand(shape), b.expand(shape)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous, 16-byte aligned tensor (the kernel copies whole
    rows of 12 int4): x itself in the common case."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
    return x


def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors (broadcasting over leading axes).

    The verify path's operands have one shape and are contiguous and
    aligned: then the launch is a few attribute reads, one ``empty_like``,
    the current stream and one ctypes call, and no operand is copied."""
    if a.dtype is not torch.int32 or b.dtype is not torch.int32:
        raise TypeError(f"mont_mul wants int32 limbs, got {a.dtype}, {b.dtype}")
    if not a.is_cuda or b.get_device() != a.get_device():
        raise ValueError(
            f"mont_mul kernel wants both operands on one CUDA device, got "
            f"{a.device} and {b.device}"
        )
    if a.shape[-1:] != _TAIL or b.shape[-1:] != _TAIL:
        raise ValueError(f"last axis must be {N_LIMBS} limbs")
    if a.shape != b.shape:
        a, b = _broadcast(a, b)
    a, b = _aligned(a), _aligned(b)
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    if n == 0:
        return out
    rc = _kernel_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                      _build.current_stream(a))
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    K1.launches += 1
    K1.sizes[n] += 1
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_cuda(a, b)
    if a.is_cpu and b.is_cpu:
        return mont_mul_plain(a, b)
    raise ValueError(f"unsupported devices {a.device}, {b.device}")
