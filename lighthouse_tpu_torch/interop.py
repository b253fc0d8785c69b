"""State carried between the JAX package and the port.

A BLS verifier has no weights: what crosses is the packed device state
that ``lighthouse_tpu.jax_backend`` builds in ``_dispatch`` (numpy arrays
of Montgomery byte limbs, infinity masks and RLC bits), and the pubkey
registry of ``lighthouse_tpu.blsrt.DevicePubkeyTable`` (uint8 limb
planes). The functions here turn exactly those arrays into the port's
tensors and table, so the same operands can go through
``jax_backend._verify_jit`` and the port's ``_verify_core``.

They also hold the byte repack used at the CUDA kernel boundary: the torch
layout keeps 48 x 8-bit limbs in int32, the kernels work on 12 x 32-bit
words (the same integer, R = 2^384 in both).
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS = 48
N_WORDS = 12


def _tensor(x, dtype, shape, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # already a tensor, possibly on device
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got {tuple(x.shape)}")
        return x.to(device=device, dtype=dtype)
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.shape != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {arr.shape}")
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def operands_from_numpy(px, py, pinf, sx, sy, sinf, mx, my, minf, r_bits,
                        device):
    """The JAX dispatch's numpy operands -> ``_verify_core`` arguments.

    px, py: int32 [S, K, 48]; pinf: bool [S, K]; sx, sy, mx, my: int32
    [S, 2, 48]; sinf, minf: bool [S]; r_bits: int32 [S, 64] (MSB first).
    Any operand may already be a tensor (the device hash leaves mx, my,
    minf on the card); it moves only if it lies elsewhere. Returns (pk, pk_inf, sig, sig_inf, msg, msg_inf, r_bits) on ``device``.
    """
    return (pubkey_operands(px, py, pinf, device)
            + set_operands(sx, sy, sinf, mx, my, minf, r_bits, device))


def pubkey_operands(px, py, pinf, device):
    """The pubkey grid of :func:`operands_from_numpy` alone: (pk, pk_inf)."""
    S, K = np.asarray(pinf).shape
    g1 = (S, K, N_LIMBS)
    return (
        (_tensor(px, torch.int32, g1, device), _tensor(py, torch.int32, g1, device)),
        _tensor(pinf, torch.bool, (S, K), device),
    )


def set_operands(sx, sy, sinf, mx, my, minf, r_bits, device):
    """The per-set operands of :func:`operands_from_numpy` alone: (sig,
    sig_inf, msg, msg_inf, r_bits) on ``device``, for a verify whose
    pubkeys come from elsewhere (the indexed gather)."""
    S = np.asarray(sinf).shape[0]
    i32, b = torch.int32, torch.bool
    g2 = (S, 2, N_LIMBS)
    return (
        (_tensor(sx, i32, g2, device), _tensor(sy, i32, g2, device)),
        _tensor(sinf, b, (S,), device),
        (_tensor(mx, i32, g2, device), _tensor(my, i32, g2, device)),
        _tensor(minf, b, (S,), device),
        _tensor(r_bits, i32, (S, np.asarray(r_bits).shape[-1]), device),
    )


def table_from_numpy(x_u8, y_u8, n: int):
    """A JAX ``DevicePubkeyTable``'s staging planes (``_host_x``,
    ``_host_y``: uint8 [C, 48] Montgomery limbs, C >= n) and its length
    -> the port's ``blsrt.DevicePubkeyTable`` holding the same n rows."""
    from .blsrt import DevicePubkeyTable

    return DevicePubkeyTable.from_planes(x_u8, y_u8, n)


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """int32 [..., 48] byte limbs -> int64 [..., 12] 32-bit words."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=limbs.device)
    grouped = limbs.to(torch.int64).reshape(*limbs.shape[:-1], N_WORDS, 4)
    return (grouped << shifts).sum(-1)


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """int64 [..., 12] 32-bit words -> int32 [..., 48] byte limbs."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=words.device)
    limbs = (words.unsqueeze(-1) >> shifts) & 255
    return limbs.reshape(*words.shape[:-1], N_LIMBS).to(torch.int32)
