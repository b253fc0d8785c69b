"""The fused kernels of the verify path (K2-K4, K8-K11), the full-order
subgroup check K15, and their plain versions.

Counterpart of ``lighthouse_tpu/ops/tkernel_calls.py``, whose Pallas kernels
each run one long sequential chain of the verify (affine normalisation,
RLC scalar multiplication, subgroup check, Miller loop, final
exponentiation) as one program. Here each is a CUDA kernel under
``lighthouse_tpu_torch/csrc/`` that runs the chain one lane per thread.

Every wrapper takes the port's batch-major tensors, with one leading lane
axis: Fp ``int32[n, 48]``, Fp2 ``[n, 2, 48]``, Fp12 ``[n, 2, 3, 2, 48]``,
masks ``bool[n]``.

* CUDA tensors go to the kernel, or the wrapper raises. It checks dtype,
  device, shape and contiguity; it allocates its outputs with
  ``torch.empty``; it launches on the current stream; it raises on a
  nonzero CUDA error; it counts the launch on its ``_build.Kernel``. Zero
  lanes launch nothing.
* CPU tensors go to the plain version, which computes the same limbs.

There is no fallback from one to the other. Importing this module builds
nothing; each library compiles at its first launch or in
``_build.build_all``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, points
from .pairing import _cyc_pow_x, _cyc_pow_x_minus_1, easy_part
from .points import FP2_OPS, FP_OPS
from .tkernel_pairing import miller_loop_seg
from .tower import fp12_conj, fp12_frobenius, fp12_frobenius2, fp12_mul, fp12_sqr

_FP = (48,)
_FP2 = (2, 48)
_FP12 = (2, 3, 2, 48)

_LIBS = {
    stem: _build.CudaLibrary(f"{stem}.cu")
    for stem in ("to_affine", "scalar_mul", "subgroup_fast", "subgroup",
                 "miller", "final_exp")
}
_SITE = "lighthouse_tpu/ops/tkernel_calls.py"


def _kernel(name: str, stem: str, replaces: str) -> _build.Kernel:
    return _build.register(_build.Kernel(
        name=name,
        route="cuda",
        source=f"lighthouse_tpu_torch/csrc/{stem}.cu",
        replaces=f"{_SITE}:{replaces}",
        library=_LIBS[stem],
    ))


K2_G1 = _kernel("to_affine_g1", "to_affine", "267 _to_affine_kernel(g2=False)")
K2_G2 = _kernel("to_affine_g2", "to_affine", "267 _to_affine_kernel(g2=True)")
K3_G1 = _kernel("scalar_mul_g1", "scalar_mul", "77 _scalar_mul_kernel(g2=False)")
K3_G2 = _kernel("scalar_mul_g2", "scalar_mul", "77 _scalar_mul_kernel(g2=True)")
K4 = _kernel("subgroup_fast", "subgroup_fast", "191 _subgroup_fast_kernel")
K15 = _kernel("subgroup_full", "subgroup", "141 _subgroup_kernel")
K8 = _kernel("miller", "miller", "326 _miller_kernel")
K9 = _kernel("easy_exp", "final_exp", "390 _easy_exp_kernel")
K10 = _kernel("pow_x", "final_exp", "398 _pow_kernel")
K11 = _kernel("comb", "final_exp", "410 _comb_kernel")

COMB_MODES = ("b", "c", "final")

# ------------------------------------------------------------ the launcher


def _on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU: the plain version's case.
    Anything else is the kernel's, whose checks reject a mix."""
    return all(t.device.type == "cpu" for t in tensors)


def _checked(kernel: _build.Kernel, specs):
    """(tensor, dtype, tail shape) triples sharing one leading lane axis, on
    one CUDA device -> (contiguous 16-byte aligned tensors, lane count)."""
    first = specs[0][0]
    dev = first.device
    n = first.shape[0] if first.dim() else -1
    out = []
    for t, dtype, tail in specs:
        if t.dtype != dtype:
            raise TypeError(f"{kernel.name}: wants {dtype}, got {t.dtype}")
        if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail \
                or t.shape[0] != n:
            raise ValueError(
                f"{kernel.name}: wants shape [{n}, {', '.join(map(str, tail))}]"
                f", got {list(t.shape)}"
            )
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{kernel.name}: wants every operand on one CUDA device, got "
                f"{t.device} beside {dev}"
            )
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out, n


def _launch(kernel: _build.Kernel, tensors, ints, n: int) -> None:
    """Call ``lh_<name>(pointers..., ints..., n, stream)`` of the kernel's
    library and count the launch; zero lanes launch nothing."""
    if n == 0:
        return
    fn = getattr(kernel.library.load(), f"lh_{kernel.name}")
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
            *(ctypes.c_int(i) for i in ints),
            ctypes.c_longlong(n), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA error {rc}")
    kernel.launches += 1
    kernel.sizes[n] += 1


def _empty(n: int, tail, like: torch.Tensor, lead=()) -> torch.Tensor:
    return torch.empty((*lead, n, *tail), dtype=torch.int32, device=like.device)


# --------------------------------------------------------------- K2


def _to_affine(kernel, F, tail, P):
    if _on_cpu(*P):
        return points.pt_to_affine(F, P)
    (X, Y, Z), n = _checked(kernel, [(c, torch.int32, tail) for c in P])
    out = _empty(n, tail, X, lead=(2,))
    inf = torch.empty(n, dtype=torch.bool, device=X.device)
    _launch(kernel, (X, Y, Z, out[0], out[1], inf), (), n)
    return out[0], out[1], inf


def to_affine_g1(P):
    """Kernel K2, G1 form: Jacobian (X, Y, Z) [n, 48] -> canonical affine
    (x, y) and the infinity mask (plain: ``points.pt_to_affine``)."""
    return _to_affine(K2_G1, FP_OPS, _FP, P)


def to_affine_g2(P):
    """Kernel K2, G2 form, on Fp2 coordinates [n, 2, 48]."""
    return _to_affine(K2_G2, FP2_OPS, _FP2, P)


# --------------------------------------------------------------- K3


def _scalar_mul(kernel, F, tail, x, y, inf, bits):
    if _on_cpu(x, y, inf, bits):
        return points.pt_scalar_mul_bits(F, (x, y), inf, bits)
    nbits = bits.shape[-1] if bits.dim() == 2 else -1
    (x, y, inf, bits), n = _checked(kernel, [
        (x, torch.int32, tail), (y, torch.int32, tail),
        (inf, torch.bool, ()), (bits, torch.int32, (nbits,)),
    ])
    out = _empty(n, tail, x, lead=(3,))
    _launch(kernel, (x, y, inf, bits, out[0], out[1], out[2]), (nbits,), n)
    return out[0], out[1], out[2]


def scalar_mul_g1(x, y, inf, bits):
    """Kernel K3, G1 form: [k_i]Q_i per lane, Jacobian out. x, y: affine
    [n, 48]; inf: bool [n]; bits: int32 [n, nbits], MSB first (plain:
    ``points.pt_scalar_mul_bits``)."""
    return _scalar_mul(K3_G1, FP_OPS, _FP, x, y, inf, bits)


def scalar_mul_g2(x, y, inf, bits):
    """Kernel K3, G2 form, on Fp2 coordinates [n, 2, 48]."""
    return _scalar_mul(K3_G2, FP2_OPS, _FP2, x, y, inf, bits)


# --------------------------------------------------------------- K4


def subgroup_check_g2_fast(x, y, inf):
    """Kernel K4: psi(Q) == [x]Q per lane -> bool [n]; infinity passes
    (plain: ``points.subgroup_check_g2_fast``)."""
    if _on_cpu(x, y, inf):
        return points.subgroup_check_g2_fast(x, y, inf)
    (x, y, inf), n = _checked(K4, [
        (x, torch.int32, _FP2), (y, torch.int32, _FP2), (inf, torch.bool, ()),
    ])
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    _launch(K4, (x, y, inf, out), (), n)
    return out


# --------------------------------------------------------------- K15


def subgroup_check_g2(x, y, inf):
    """Kernel K15: [r]Q == infinity per lane, r the curve order -> bool [n];
    infinity passes (plain: ``points.pt_subgroup_check`` on
    ``pt_from_affine``). The verify path runs K4; this is its full-order
    counterpart."""
    if _on_cpu(x, y, inf):
        P = points.pt_from_affine(FP2_OPS, x, y, inf)
        return points.pt_subgroup_check(FP2_OPS, P)
    (x, y, inf), n = _checked(K15, [
        (x, torch.int32, _FP2), (y, torch.int32, _FP2), (inf, torch.bool, ()),
    ])
    out = torch.empty(n, dtype=torch.bool, device=x.device)
    _launch(K15, (x, y, inf, out), (), n)
    return out


# --------------------------------------------------------------- K8


def miller_loop(p_aff, p_inf, q_aff, q_inf):
    """Kernel K8: the Miller loop per (P, Q) lane -> Fp12 [n, 2, 3, 2, 48];
    Fp12 one where P or Q is at infinity (plain:
    ``tkernel_pairing.miller_loop_seg``)."""
    if _on_cpu(*p_aff, p_inf, *q_aff, q_inf):
        return miller_loop_seg(p_aff, p_inf, q_aff, q_inf)
    (xp, yp, pinf, xq, yq, qinf), n = _checked(K8, [
        (p_aff[0], torch.int32, _FP), (p_aff[1], torch.int32, _FP),
        (p_inf, torch.bool, ()),
        (q_aff[0], torch.int32, _FP2), (q_aff[1], torch.int32, _FP2),
        (q_inf, torch.bool, ()),
    ])
    out = _empty(n, _FP12, xp)
    _launch(K8, (xp, yp, pinf, xq, yq, qinf, out), (), n)
    return out


# ------------------------------------------------------------ K9-K11


# f^((p^6-1)(p^2+1)): g = conj(f) / f, then frob2(g) g.
easy_exp_plain = easy_part


def pow_x_plain(f, xm1: bool):
    """f^x, or f^(x-1) = f^x conj(f) when ``xm1`` (cyclotomic f)."""
    return (_cyc_pow_x_minus_1 if xm1 else _cyc_pow_x)(f)


def comb_plain(u, v, mode: str):
    """The three combinations of the hard part (reference
    ``tkernel_calls._comb_kernel``): b = u frob(v), c = u frob2(v) conj(v),
    final = u v^2 v."""
    if mode == "b":
        return fp12_mul(u, fp12_frobenius(v))
    if mode == "c":
        return fp12_mul(fp12_mul(u, fp12_frobenius2(v)), fp12_conj(v))
    if mode == "final":
        return fp12_mul(fp12_mul(u, fp12_sqr(v)), v)
    raise ValueError(f"unknown comb mode {mode!r}")


def _fp12_call(kernel, operands, ints):
    (*ins,), n = _checked(kernel, [(f, torch.int32, _FP12) for f in operands])
    out = _empty(n, _FP12, ins[0])
    _launch(kernel, (*ins, out), ints, n)
    return out


def easy_exp(f):
    """Kernel K9 on Fp12 [n, 2, 3, 2, 48] (plain: :func:`easy_exp_plain`)."""
    if _on_cpu(f):
        return easy_exp_plain(f)
    return _fp12_call(K9, (f,), ())


def pow_x(f, xm1: bool):
    """Kernel K10 (plain: :func:`pow_x_plain`)."""
    if _on_cpu(f):
        return pow_x_plain(f, xm1)
    return _fp12_call(K10, (f,), (int(bool(xm1)),))


def comb(u, v, mode: str):
    """Kernel K11 in mode b, c or final (plain: :func:`comb_plain`)."""
    if mode not in COMB_MODES:
        raise ValueError(f"unknown comb mode {mode!r}")
    if _on_cpu(u, v):
        return comb_plain(u, v, mode)
    return _fp12_call(K11, (u, v), (COMB_MODES.index(mode),))


def final_exp_kernel(f):
    """f^(3(p^12-1)/r) as the 9-launch chain of the reference's
    ``_final_exp_t``: the easy part, then the HHT hard part from 5 x-powers
    and 3 combinations. Equals ``pairing.final_exponentiation`` limb for
    limb (the same chain of the same tower calls)."""
    g = easy_exp(f)
    a = pow_x(pow_x(g, True), True)
    b = comb(pow_x(a, False), a, "b")
    c = comb(pow_x(pow_x(b, False), False), b, "c")
    return comb(c, g, "final")
