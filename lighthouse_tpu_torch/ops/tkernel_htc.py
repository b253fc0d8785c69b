"""Device hash-to-G2: the hash kernels K12-K14, their plain versions and
the entry points.

Counterpart of ``lighthouse_tpu/ops/tkernel_htc.py``. Two bodies carry the
sequential depth, and each is a CUDA chain in ``csrc/htc.cuh``, one thread
per lane:

* the SSWU + 3-isogeny body: one 757-step ``sqrt_ratio`` exponentiation per
  u, then straight-line SSWU and isogeny glue, out to a Jacobian point on
  E2. Its schedule is the classic one of ``ops/htc.py`` op for op (the
  reference kernel body repeats ``sswu_fq2`` then ``iso3_jacobian``), so
  its plain version is those two functions;
* the cofactor body: h_eff by two |x| walks and psi (:func:`cofactor_plain`).

The resident kernel K12 runs both bodies and the Q0 + Q1 addition between
them in one launch; the chained route runs K13 on 2n lanes, the plain
complete addition of the halves, then K14. Canonical affine output comes
from kernel K2 (``tkernel_calls.to_affine_g2``) either way.

The wrappers follow ``ops/tkernel_calls.py``: CUDA tensors go to the kernel
(checked, counted on its ``_build.Kernel``) or the wrapper raises; CPU
tensors go to the plain version. There is no fallback from one to the
other, and importing this module builds nothing.
"""

from __future__ import annotations

import torch

from . import _build, htc
from . import tkernel_calls as tc
from .points import FP2_OPS, X_BITS, pt_add, pt_double, pt_neg
from .tkernel_calls import _FP2, _checked, _empty, _launch, _on_cpu

_LIB = _build.CudaLibrary("htc.cu")
_SITE = "lighthouse_tpu/ops/tkernel_htc.py"


def _kernel(name: str, replaces: str) -> _build.Kernel:
    return _build.register(_build.Kernel(
        name=name,
        route="cuda",
        source="lighthouse_tpu_torch/csrc/htc.cu",
        replaces=f"{_SITE}:{replaces}",
        library=_LIB,
    ))


K12 = _kernel("map_to_g2", "338 _map_to_g2_kernel")
K13 = _kernel("sswu_iso", "216 _sswu_iso_kernel")
K14 = _kernel("cofactor", "300 _cofactor_kernel")

_US = (2, 2, 48)  # per message: u-half, Fp2 coefficient, limb

# ------------------------------------------------------ plain versions


def sswu_iso_plain(u):
    """SSWU + 3-isogeny, u [..., 2, 48] -> Jacobian (X, Y, Z) on E2, the
    same leading axes (reference ``_sswu_iso_body``)."""
    return htc.iso3_jacobian(*htc.sswu_fq2(u))


def _x_walk(Q):
    """[|x|]Q on |x|'s static bits: the leading one is Q itself, then a
    doubling per bit and a complete addition of Q on each one bit."""
    acc = Q
    for bit in X_BITS:
        acc = pt_double(FP2_OPS, acc)
        if bit == "1":
            acc = pt_add(FP2_OPS, acc, Q)
    return acc


def cofactor_plain(Q):
    """h_eff Q (reference ``_cofactor_body``), by two |x| walks.

    With t = [|x|]Q and t2 = [|x|]t (x < 0, so [x]Q = -t and [x^2]Q = t2):
    (x^2-x-1) Q = t2 + t - Q and (x-1) psi(Q) = -psi(t + Q), so

        h_eff Q = t2 + t - Q - psi(t + Q) + psi^2(2Q).

    Every addition is the complete ``pt_add`` (doubling, inverse and
    infinity cases selected), so padding lanes stay safe."""
    F = FP2_OPS
    t = _x_walk(Q)
    t2 = _x_walk(t)
    term0 = pt_add(F, pt_add(F, t2, t), pt_neg(F, Q))
    term1 = pt_neg(F, htc.psi_jacobian(pt_add(F, t, Q)))
    term2 = htc.psi_jacobian(htc.psi_jacobian(pt_double(F, Q)))
    return pt_add(F, pt_add(F, term0, term1), term2)


def map_to_g2_resident_plain(us):
    """us [n, 2, 2, 48] -> cofactor-cleared Jacobian (X, Y, Z), each
    [n, 2, 48] (reference ``_map_to_g2_kernel``): both u-halves through the
    SSWU + isogeny body at once, Q0 + Q1, then the cofactor body."""
    X, Y, Z = sswu_iso_plain(us)
    Q = pt_add(FP2_OPS, (X[:, 0], Y[:, 0], Z[:, 0]), (X[:, 1], Y[:, 1], Z[:, 1]))
    return cofactor_plain(Q)


# ------------------------------------------------------------ wrappers


def map_to_g2_resident(us):
    """Kernel K12: us int32 [n, 2, 2, 48] (hash_to_field output) ->
    cofactor-cleared Jacobian (X, Y, Z), each [n, 2, 48] (plain:
    :func:`map_to_g2_resident_plain`)."""
    if _on_cpu(us):
        return map_to_g2_resident_plain(us)
    (us,), n = _checked(K12, [(us, torch.int32, _US)])
    out = _empty(n, _FP2, us, lead=(3,))
    _launch(K12, (us, out[0], out[1], out[2]), (), n)
    return out[0], out[1], out[2]


def sswu_iso(u):
    """Kernel K13: u int32 [n, 2, 48] -> Jacobian (X, Y, Z) on E2, each
    [n, 2, 48] (plain: :func:`sswu_iso_plain`)."""
    if _on_cpu(u):
        return sswu_iso_plain(u)
    (u,), n = _checked(K13, [(u, torch.int32, _FP2)])
    out = _empty(n, _FP2, u, lead=(3,))
    _launch(K13, (u, out[0], out[1], out[2]), (), n)
    return out[0], out[1], out[2]


def clear_cofactor(P):
    """Kernel K14: Jacobian (X, Y, Z) [n, 2, 48] -> h_eff P, Jacobian
    (plain: :func:`cofactor_plain`)."""
    if _on_cpu(*P):
        return cofactor_plain(P)
    (X, Y, Z), n = _checked(K14, [(c, torch.int32, _FP2) for c in P])
    out = _empty(n, _FP2, X, lead=(3,))
    _launch(K14, (X, Y, Z, out[0], out[1], out[2]), (), n)
    return out[0], out[1], out[2]


# --------------------------------------------------------- entry points


def _device(device) -> torch.device:
    """The card unless the caller names a device; no card raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device hash-to-G2: no CUDA device; pass device='cpu' to run "
                "the plain versions on the host"
            )
        device = "cuda"
    return torch.device(device)


def hash_to_g2_map_dev(msgs, dst=None, device=None, resident: bool = True):
    """Front of :func:`hash_to_g2_fused_dev`: host SHA-256 and field
    reduction (``htc.hash_to_field_dev``), then the curve map on
    ``device``. Returns ``(Q, cleared)``: Q a Jacobian (X, Y, Z) of
    [n, 2, 48] tensors, ``cleared`` True when the resident kernel K12
    already cleared the cofactor; otherwise K13 on the 2n u-halves and the
    complete addition of the halves ran, and the cofactor is left to
    :func:`hash_to_g2_finish_dev`."""
    dev = _device(device)
    u = torch.from_numpy(htc.hash_to_field_dev(msgs, htc.DST if dst is None else dst))
    u = u.to(dev)
    if resident:
        return map_to_g2_resident(u), True
    n = u.shape[0]
    X, Y, Z = sswu_iso(torch.cat([u[:, 0], u[:, 1]]))  # u0 rows, then u1
    return pt_add(FP2_OPS, (X[:n], Y[:n], Z[:n]), (X[n:], Y[n:], Z[n:])), False


def hash_to_g2_finish_dev(Q, cleared: bool):
    """Back of :func:`hash_to_g2_fused_dev`: the cofactor clear (K14) unless
    the front already ran it, then canonical affine (K2 G2), left on Q's
    device: (x[n,2,48], y[n,2,48], inf[n])."""
    if not cleared:
        Q = clear_cofactor(Q)
    return tc.to_affine_g2(Q)


def hash_to_g2_fused_dev(msgs, dst=None, device=None, resident: bool = True):
    """Batched hash_to_curve through the hash kernels, the results left on
    ``device`` (the card unless named): messages -> canonical affine
    (x[n,2,48], y[n,2,48], inf[n]). ``resident`` picks K12 (one launch)
    or the chained K13 -> add -> K14 route; both give the same points."""
    return hash_to_g2_finish_dev(*hash_to_g2_map_dev(msgs, dst, device, resident))
