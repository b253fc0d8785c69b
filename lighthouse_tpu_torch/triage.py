"""The retained pack of a triage and its row slicing.

Poison triage (``TorchBackend.verify_signature_sets_triaged``) packs a
batch once, keeps every padded grid, and answers each refinement round by
slicing rows out of that pack: no pack, hash or scalar draw runs again, so
a refinement round verifies the suspects under the round-1 blinding
scalars. In the reference these live in ``lighthouse_tpu/jax_backend.py``
(``_TriagePack``, ``_rows_take``, ``_slice_packs``), over numpy arrays or
``jax.Array``; here over numpy arrays or ``torch.Tensor``. A tensor is
sliced on its own device by an index tensor there (the device hash's rows
never come back to the host). The reference slices a list of packs, one
per pipelined chunk; the port has no pipelined chunks yet, so it slices
the one pack of the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .devices import next_pow2


class TriagePack:
    """Padded per-row inputs of one triage batch.

    Pubkeys are either table-indexed (``tx``/``ty``: the device table's
    uint8 planes, shared by reference; ``idx``/``pinf``: host grids [S, K])
    or limb grids (``px``/``py`` [S, K, 48], ``pinf``). ``sx, sy, sinf``
    are the signatures, ``mx, my, minf`` the hashed messages (tensors on the
    device on the device-hash route, numpy otherwise), ``r_bits`` the RLC
    scalars' bits [S, 64]. ``r_u64`` holds the same scalars as integers,
    for the MSM schedule of a plain verify; a sliced pack has none."""

    __slots__ = ("n", "S", "K", "tx", "ty", "idx", "px", "py", "pinf",
                 "sx", "sy", "sinf", "mx", "my", "minf", "r_bits", "r_u64")

    def __init__(self, n: int, S: int, K: int):
        self.n, self.S, self.K = n, S, K
        self.tx = self.ty = self.idx = None
        self.px = self.py = None
        self.r_u64 = None


def rows_take(arr, sel, pad: int, fill):
    """Rows ``sel`` of ``arr`` then ``pad`` rows of ``fill``; a tensor is
    indexed on its own device."""
    sel = np.asarray(sel, np.int64)
    if isinstance(arr, np.ndarray):
        out = arr[sel]
        if pad:
            out = np.concatenate([out, np.full((pad, *out.shape[1:]), fill,
                                               out.dtype)])
        return out
    out = arr.index_select(0, torch.from_numpy(sel).to(arr.device))
    if pad:
        out = torch.cat([out, out.new_full((pad, *out.shape[1:]), fill)])
    return out


def slice_pack(pk: TriagePack, sel) -> TriagePack:
    """A refinement pack of the rows ``sel`` (sorted indices into the
    batch) of the round-1 pack ``pk``, padded to a power of two with inert
    rows (keys and signatures at infinity, zero scalars). A table-mode pack
    keeps the table by reference and slices its index grid."""
    m = len(sel)
    S2 = next_pow2(m)
    pad = S2 - m
    out = TriagePack(n=m, S=S2, K=pk.K)
    if pk.tx is not None:
        out.tx, out.ty = pk.tx, pk.ty
        out.idx = rows_take(pk.idx, sel, pad, 0)
    else:
        out.px = rows_take(pk.px, sel, pad, 0)
        out.py = rows_take(pk.py, sel, pad, 0)
    for field, fill in (("pinf", True), ("sx", 0), ("sy", 0), ("sinf", True),
                        ("mx", 0), ("my", 0), ("minf", True), ("r_bits", 0)):
        setattr(out, field, rows_take(getattr(pk, field), sel, pad, fill))
    return out
