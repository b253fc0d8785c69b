"""Plain version of the Miller-loop kernel K8.

Port of the non-lazy Miller loop of ``lighthouse_tpu/ops/tkernel_pairing.py``
in the port's batch-major layout (lanes lead, Fp12 is ``[..., 2, 3, 2, 48]``).
It is the classic ``pairing.miller_loop`` (same doubling and addition steps,
same walk over |x|) with one change: each line is multiplied into f sparsely
(13 Fp2 products) instead of embedded as a dense Fp12. So
``miller_loop_seg`` equals ``pairing.miller_loop`` after ``canonical``, not
limb for limb. The plain version of the x-power kernel K10 is the classic
``pairing._cyc_pow_x``.

On the card each tower call is still a string of small launches
(``chip_smoke.py`` times this as K8's plain version).
"""

from __future__ import annotations

import torch

from .field import add, sub
from .pairing import miller_loop
from .tower import _stk2, _stk6, fp2_mul, fp2_mul_by_xi, fp2_mul_fp, fp6_mul_by_v


def _mul_line_sparse(f, line, xp, yp):
    """f * l with the line l = A + B xp w^2 + C yp w^3 kept sparse: its only
    nonzero slots are (c0.c0, c0.c1, c1.c1) = (A, B xp, C yp), so the
    Karatsuba Fp12 product takes 13 Fp2 products, all independent, stacked
    here into one ``fp2_mul``."""
    A, B, C = line
    bc = fp2_mul_fp(torch.stack(torch.broadcast_tensors(B, C)),
                    torch.stack((xp, yp)))
    bxp, cyp = bc[0], bc[1]
    f0, f1 = f[..., 0, :, :, :], f[..., 1, :, :, :]
    fs = add(f0, f1)
    f00, f01, f02 = (f0[..., i, :, :] for i in range(3))
    g0, g1, g2 = (f1[..., i, :, :] for i in range(3))
    s0, s1, s2 = (fs[..., i, :, :] for i in range(3))
    Bc = add(bxp, cyp)
    m = fp2_mul(
        _stk2(f00, f01, add(f00, f01), f02, f02,
              g2, g0, g1,
              s0, s1, add(s0, s1), s2, s2),
        _stk2(A, bxp, add(A, bxp), bxp, A,
              cyp, cyp, cyp,
              A, Bc, add(A, Bc), Bc, A),
    )
    (m0, m1, mx, mu, mv, w2, w0, w1,
     n0, n1, nx, nu, nv) = (m[..., i, :, :] for i in range(13))
    t0 = _stk2(add(m0, fp2_mul_by_xi(mu)), sub(sub(mx, m0), m1), add(m1, mv))
    t1 = _stk2(fp2_mul_by_xi(w2), w0, w1)
    ts = _stk2(add(n0, fp2_mul_by_xi(nu)), sub(sub(nx, n0), n1), add(n1, nv))
    return _stk6(add(t0, fp6_mul_by_v(t1)), sub(sub(ts, t0), t1))


def miller_loop_seg(p_aff, p_inf, q_aff, q_inf):
    """The Miller loop of kernel K8: f_{|x|,Q}(P) with sparse line products,
    conjugated for x < 0; Fp12 one on lanes with P or Q at infinity.

    p_aff: (xp, yp) Fp [n, 48]; q_aff: (xq, yq) Fp2 [n, 2, 48]; masks
    bool [n]. Returns Fp12 [n, 2, 3, 2, 48]."""
    return miller_loop(p_aff, p_inf, q_aff, q_inf, mul_line=_mul_line_sparse)
