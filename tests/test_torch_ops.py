"""Tower, group-law and pairing parity of the port against the JAX
package's ``ops/tower.py``, ``ops/points.py`` and ``ops/pairing.py``.

Same inputs (made with a seeded numpy generator, or points from the host
oracle) through both; the tolerance is exact equality of the int32 limb
arrays, since the port follows the reference's schedules call by call. Slow
tier, like the JAX package's own op-level sweeps (tests/conftest.py).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.api import SecretKey
from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu.crypto.bls.pairing import pairing as oracle_pairing
from lighthouse_tpu.ops import limb
from lighthouse_tpu.ops import pairing as jpairing
from lighthouse_tpu.ops import points as jpoints
from lighthouse_tpu.ops import tower as jtower
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import pairing, points, tower

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _elems(seed, shape):
    """Random Fp values in [0, 2p) as int32 limbs of the given shape."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape[:-1]))
    raw = rng.integers(0, 256, size=(n, 48), dtype=np.uint8)
    ints = [int.from_bytes(r.tobytes(), "little") % (2 * P) for r in raw]
    return limb.ints_to_limbs(ints).reshape(shape)


def _same(got, want):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want)
    )


@pytest.mark.parametrize("name, shape", [
    ("fp2_mul", (3, 2, 48)),
    ("fp2_sqr", (3, 2, 48)),
    ("fp6_mul", (2, 3, 2, 48)),
    ("fp12_mul", (2, 2, 3, 2, 48)),
    ("fp12_sqr", (2, 2, 3, 2, 48)),
    ("fp12_frobenius", (2, 2, 3, 2, 48)),
    ("fp12_conj", (2, 2, 3, 2, 48)),
    ("fp2_inv", (2, 2, 48)),
    ("fp12_inv", (1, 2, 3, 2, 48)),
])
def test_tower_op_matches_reference(name, shape):
    a = _elems(1, shape)
    b = _elems(2, shape)
    unary = name in ("fp2_sqr", "fp12_sqr", "fp12_frobenius", "fp12_conj",
                     "fp2_inv", "fp12_inv")
    args = (a,) if unary else (a, b)
    got = getattr(tower, name)(*map(torch.from_numpy, args))
    _same(got, getattr(jtower, name)(*args))


def _g2_points(n):
    pts = [hash_to_g2(bytes([i]) * 32) for i in range(n)]
    return jpoints.g2_to_dev(pts)


def _g1_points(n):
    pts = [SecretKey.from_int(5 + i).public_key().point for i in range(n)]
    return jpoints.g1_to_dev(pts)


def _both(F_port, F_ref, fn, *args):
    """Run points.<fn> on both packages; args are numpy arrays or tuples."""
    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return torch.from_numpy(np.ascontiguousarray(x))

    got = getattr(points, fn)(F_port, *map(conv, args))
    want = getattr(jpoints, fn)(F_ref, *args)
    return got, want


@pytest.mark.parametrize("g", ["g1", "g2"])
def test_group_law_matches_reference(g):
    if g == "g1":
        x, y, inf = _g1_points(4)
        Fp, Fr = points.FP_OPS, jpoints.FP_OPS
    else:
        x, y, inf = _g2_points(4)
        Fp, Fr = points.FP2_OPS, jpoints.FP2_OPS
    inf = inf.copy()
    inf[3] = True                                   # one infinity lane
    Pj = jpoints.pt_from_affine(Fr, x, y, inf)
    P = tuple(np.asarray(c) for c in Pj)
    Q = tuple(np.asarray(c)[::-1].copy() for c in Pj)  # lanes reversed
    Pd = tuple(np.asarray(c) for c in jpoints.pt_double(Fr, Pj))

    for fn, args in (
        ("pt_double", (P,)),
        ("pt_add", (P, Q)),
        ("pt_add", (P, P)),                          # doubling branch
        ("pt_add", (Pd, P)),
        ("pt_add_mixed", (Pd, (x, y), inf)),
        ("pt_to_affine", (Pd,)),
    ):
        got, want = _both(Fp, Fr, fn, *args)
        for gc, wc in zip(got, want):
            _same(gc, wc)


def test_scalar_mul_and_subgroup_check_match_reference():
    x, y, inf = _g2_points(2)
    bits = jpoints.scalars_to_bits([0b1011, 0b0110], 4)
    got, want = _both(points.FP2_OPS, jpoints.FP2_OPS, "pt_scalar_mul_bits",
                      (x, y), inf, bits)
    for gc, wc in zip(got, want):
        _same(gc, wc)
    P = tuple(torch.from_numpy(np.asarray(c)) for c in
              jpoints.pt_from_affine(jpoints.FP2_OPS, x, y, inf))
    assert points.pt_subgroup_check(points.FP2_OPS, P).all()


def test_miller_loop_and_final_exp_match_reference():
    gx, gy, ginf = _g1_points(2)
    qx, qy, qinf = _g2_points(2)
    want_f = jpairing.miller_loop_jit((gx, gy), ginf, (qx, qy), qinf)
    t = torch.from_numpy
    got_f = pairing.miller_loop((t(gx), t(gy)), t(ginf), (t(qx), t(qy)), t(qinf))
    _same(got_f, want_f)
    got_e = pairing.final_exponentiation(got_f)
    _same(got_e, jpairing.final_exponentiation_jit(np.asarray(want_f)))
    # and the pairing value equals the host oracle's
    p0 = SecretKey.from_int(5).public_key().point
    q0 = hash_to_g2(bytes([0]) * 32)
    assert jtower.fq12_from_dev(got_e[0].numpy()) == oracle_pairing(p0, q0)
